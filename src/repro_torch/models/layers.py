"""Shared layers: RMSNorm, RoPE, embeddings (counterpart of the reference's
``models/layers.py``). Compute dtype is bf16; normalisation and rotary
statistics are taken in fp32, as in the reference."""
from __future__ import annotations

import math

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


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x) with the reference's rounding points: in bf16 the
    reference rounds after each step of 1 / (1 + exp(-x)) and after the
    product (XLA's expansion of the bf16 ``logistic``)."""
    def r(t):
        return t.to(x.dtype)
    sig = r(1.0 / r(1.0 + r(torch.exp(-x.float())).float()).float())
    return x * sig


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
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def logits_from_embed(table: torch.Tensor, x: torch.Tensor,
                      softcap: float = 0.0) -> torch.Tensor:
    lg = mm(x, table.t())                                    # [B, S, V]
    if softcap > 0:
        lg = softcap * torch.tanh(lg.float() / softcap)
    return lg
