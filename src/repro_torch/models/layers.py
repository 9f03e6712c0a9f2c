"""Shared layers: RMSNorm, RoPE and multimodal RoPE, the dense SwiGLU
FFN, embeddings and the stub front ends' projection (counterpart of the
reference's ``models/layers.py``). Compute dtype is bf16; normalisation
and rotary statistics are taken in fp32, as in the reference."""
from __future__ import annotations

import math

import numpy as np
import torch


def dense_init(shape, generator: torch.Generator, device, in_axis: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Seeded normal / sqrt(fan_in): the shapes and scales of the
    reference's ``_dense_init`` (not its bits: torch draws its own)."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w / math.sqrt(fan_in)).to(dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product with fp32 accumulation and one rounding to a's dtype,
    the reference's XLA dot. On the CPU it runs as an fp32 product rounded
    once (which matches XLA's CPU dot bit for bit, where a bf16 CPU matmul
    does not); on a GPU the bf16 product itself accumulates in fp32."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


class _Silu(torch.autograd.Function):
    """x * logistic(x). Forward: the reference's rounding points (in bf16
    it rounds after each step of 1 / (1 + exp(-x)) and after the
    product, XLA's expansion of the bf16 ``logistic``). Backward: JAX's
    rule, ``g * s + (g * x) * (s * (1 - s))`` from the rounded s, each
    product rounding to x's dtype. Differentiating the forward's steps
    instead would meet exp(-x) = inf below x = -88 and give 0 * inf =
    NaN, where the reference's gradient is 0."""

    @staticmethod
    def forward(ctx, x):
        def r(t):
            return t.to(x.dtype)
        sig = r(1.0 / r(1.0 + r(torch.exp(-x.float())).float()).float())
        ctx.save_for_backward(x, sig)
        return x * sig

    @staticmethod
    def backward(ctx, g):
        x, sig = ctx.saved_tensors
        return g * sig + (g * x) * (sig * (1 - sig))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x) with the reference's rounding points and gradient
    (:class:`_Silu`)."""
    return _Silu.apply(x)


def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    """The dense SwiGLU FFN, ``silu(x @ w1) * (x @ w3) @ w2``, with the
    reference's rounding points: each product rounds once to bf16, silu
    rounds as :func:`silu` does, the gate times the up projection rounds
    once. The reference computes it outside any Pallas kernel, as plain
    matrix products here."""
    h = silu(mm(x, p["w1"])) * mm(x, p["w3"])
    return mm(h, p["w2"])


def rmsnorm(w: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = positions[..., None].float() * freqs            # [..., S, hd/2]
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd] rotated by fp32 angles [..., S, hd/2], one rounding
    back to x's dtype."""
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int):
    """Qwen2-VL's split of the hd/2 frequency channels into (temporal,
    height, width) sections: h and w get 3/8 each, (16, 24, 24) at hd 128."""
    half = head_dim // 2
    hw = int(round(0.375 * half))
    return (half - 2 * hw, hw, hw)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: [B, S, H, hd]; positions3: [3, B, S]
    (temporal, height, width ids). Each section of frequency channels
    turns with its own position stream; where the three streams coincide
    (text) this is :func:`apply_rope` bit for bit."""
    hd = x.shape[-1]
    if sections is None:
        sections = mrope_sections(hd)
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"head_dim {hd} // 2")
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = positions3.to(x.device)[..., None].float() * freqs  # [3,B,S,hd/2]
    bounds = np.cumsum((0,) + tuple(sections))
    return _rotate(x, torch.cat([angles[i, ..., int(a):int(b)] for i, (a, b)
                                 in enumerate(zip(bounds, bounds[1:]))],
                                dim=-1))


def frontend_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A stub front end's precomputed embeddings (patches or frames
    [B, P, F]) through ``frontend_proj`` [F, D], rounded once to bf16: the
    reference's ``(x @ w).astype(bf16)``, with its dtype promotion (an fp32
    x makes an fp32 product)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return mm(x.to(dtype), w.to(dtype)).to(torch.bfloat16)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def logits_from_embed(table: torch.Tensor, x: torch.Tensor,
                      softcap: float = 0.0) -> torch.Tensor:
    lg = mm(x, table.t())                                    # [B, S, V]
    if softcap > 0:
        lg = softcap * torch.tanh(lg.float() / softcap)
    return lg
