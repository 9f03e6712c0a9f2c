"""Mamba2 SSD mixing layer (counterpart of the reference's
``models/ssm.py``).

The chunked dual form of arXiv:2405.21060 §6: an intra-chunk quadratic
(attention-like) term plus an inter-chunk linear recurrence over chunk
states, for prefill; ``ssd_decode_step`` is the O(1) recurrent form of a
decode step. The prefill scan is the ``ssd_scan`` kernel
(:mod:`repro_torch.kernels.ssd_scan`): its plain version on the CPU, the
hand-written CUDA kernel on a GPU. Train mode runs the kernel's plain
version, ``ssd_scan_plain`` (the reference's ``ssd_chunked``, one chunk at
a time in fp32), on every device: it is differentiable, the kernel is not.
The decode recurrence and the causal conv are plain PyTorch, as they are
plain JAX in the reference.

Layouts and rounding points are the reference's: ``in_proj`` through
:func:`layers.mm`; ``dt = softplus(dt + dt_bias)`` in fp32; the conv as
four fp32 taps, ``silu``, then bf16; ``y`` in bf16, the ``D`` skip in
bf16, then the gated RMSNorm and ``out_proj``.

Recurrence (per head h, state n, channel p):
    h_t = exp(a_t) * h_{t-1} + B_t ⊗ (x_t * dt_t)
    y_t = C_t · h_t + D * x_t,         a_t = -exp(A_log) * dt_t
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from .layers import dense_init, mm, rmsnorm, silu

Params = Dict[str, torch.Tensor]


def mamba_params(cfg: ModelConfig, generator: torch.Generator,
                 device) -> Params:
    """One layer's seeded parameters with the reference's shapes, dtypes
    and scales (``mamba_params``): ``conv_w`` normal x 0.1 in bf16,
    ``conv_b``, ``A_log`` and ``dt_bias`` zero, ``D`` and ``norm_w`` one."""
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    nh = s.num_heads(D)
    ci = di + 2 * s.d_state                    # conv runs over (x, B, C)
    conv_w = torch.randn((ci, s.d_conv), generator=generator, device=device)
    return {
        "in_proj": dense_init((D, 2 * di + 2 * s.d_state + nh), generator,
                              device),
        "conv_w": (conv_w * 0.1).to(torch.bfloat16),
        "conv_b": torch.zeros((ci,), dtype=torch.bfloat16, device=device),
        "A_log": torch.zeros((nh,), device=device),        # A = -exp(0)
        "D": torch.ones((nh,), device=device),
        "dt_bias": torch.zeros((nh,), device=device),
        "norm_w": torch.ones((di,), device=device),
        "out_proj": dense_init((di, D), generator, device),
    }


def _split_proj(zxbcdt: torch.Tensor, s: SSMConfig, di: int, nh: int):
    return torch.split(zxbcdt, [di, di + 2 * s.d_state, nh], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. xbc: [B, S, ci]; w: [ci, K].

    Returns (activated output [B, S, ci], new state [B, K-1, ci])."""
    Bb, S, ci = xbc.shape
    K = w.shape[1]
    if state is None:
        state = torch.zeros((Bb, K - 1, ci), dtype=xbc.dtype,
                            device=xbc.device)
    ext = torch.cat([state, xbc], dim=1)                   # [B, S+K-1, ci]
    out = torch.zeros((Bb, S, ci), dtype=torch.float32, device=xbc.device)
    for k in range(K):                        # the reference's taps, in order
        out = out + ext[:, k:k + S, :].float() * w[:, k].float()
    out = silu(out + b.float()).to(xbc.dtype)
    return out, ext[:, S:, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor,
                init_state: Optional[torch.Tensor] = None,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan through the ``ssd_scan`` kernel.

    x: [B, S, nh, hp]; dt: [B, S, nh] (post-softplus); Bmat/Cmat: [B, S, ds];
    A_log: [nh]. Returns (y [B, S, nh, hp], final state [B, nh, ds, hp])."""
    h0 = None if init_state is None else init_state.float().contiguous()
    return ssd_scan(x.contiguous(), dt.float().contiguous(), A_log.float(),
                    Bmat.contiguous(), Cmat.contiguous(), h0, chunk)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                    Bmat: torch.Tensor, Cmat: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. x: [B, nh, hp]; dt: [B, nh]; B/C: [B, ds];
    state: [B, nh, ds, hp]."""
    a = torch.exp(-torch.exp(A_log.float()) * dt)          # [B, nh]
    xd = x.float() * dt[..., None]
    state = a[..., None, None] * state.float() + \
        torch.einsum("bn,bhp->bhnp", Bmat.float(), xd)
    y = torch.einsum("bn,bhnp->bhp", Cmat.float(), state)
    return y.to(x.dtype), state


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> Params:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    ci = di + 2 * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, ci), dtype=torch.bfloat16,
                            device=device),
        "ssd": torch.zeros((batch, nh, s.d_state, s.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Params] = None, decode: bool = False,
                train: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full Mamba2 block. x: [B, S, D] -> (y [B, S, D], new state).
    ``train`` (no state) scans through the differentiable plain scan in
    place of the kernel and returns no state."""
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    nh = s.num_heads(D)
    Bb, S, _ = x.shape

    zxbcdt = mm(x, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, s, di, nh)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above 20
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))

    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bmat, Cmat = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    xh = xs.reshape(Bb, S, nh, s.head_dim)

    if decode:
        if S != 1:
            raise ValueError(f"mamba_apply: a decode step takes one token, "
                             f"got {S}")
        y, new_ssd = ssd_decode_step(xh[:, 0], dt[:, 0], p["A_log"],
                                     Bmat[:, 0], Cmat[:, 0], state["ssd"])
        y = y[:, None]
    elif train:
        y, new_ssd = ssd_scan_plain(xh, dt, p["A_log"], Bmat, Cmat,
                                    chunk=s.chunk_size)
    else:
        init = None if state is None else state["ssd"]
        y, new_ssd = ssd_chunked(xh, dt, p["A_log"], Bmat, Cmat, init,
                                 chunk=s.chunk_size)

    y = y + (p["D"].float()[:, None] * xh.float()).to(y.dtype)
    y = y.reshape(Bb, S, di)
    # gated RMSNorm (mamba2: norm(y * silu(z)))
    y = rmsnorm(p["norm_w"], y * silu(z.float()).to(y.dtype), cfg.norm_eps)
    out = mm(y, p["out_proj"])
    new_state = {"conv": new_conv, "ssd": new_ssd} \
        if (state is not None or decode) else None
    return out, new_state
