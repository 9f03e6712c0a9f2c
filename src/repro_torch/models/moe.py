"""Top-k MoE FFN with sort-based capacity dispatch, serve mode
(counterpart of the reference's ``models/moe.py``).

This is the dense-framework path the prefill forward runs over the full
expert table; the decode path's two-tier execution lives in
:mod:`repro_torch.core.collaborative`. The expert products here are plain
large matrix products (the reference leaves them to XLA einsums).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import MoEConfig
from .layers import mm, silu

Params = Dict[str, torch.Tensor]


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, D] -> (probs [T, E] fp32, top-k ids [T, K], weights [T, K])."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_i.to(torch.int32), top_w


def sort_dispatch(top_i: torch.Tensor, capacity: int, num_experts: int):
    """Flat top-k expert ids -> (token [A], buffer slot [A], keep [A],
    order [A]) with A = T*K and slots in [0, E*C)."""
    A = top_i.numel()
    flat_e = top_i.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=flat_e.device),
        side="left")
    pos_in_e = torch.arange(A, device=flat_e.device) - starts[sorted_e]
    keep = pos_in_e < capacity
    slot = sorted_e * capacity + torch.clamp(pos_in_e, max=capacity - 1)
    token = order // top_i.shape[-1]
    return token, slot, keep, order


def _dispatch(xb: torch.Tensor, tib: torch.Tensor, C: int, E: int):
    """One example's dispatch: xb [S, D], tib [S, K] -> buffer + coords."""
    token, slot, keep, order = sort_dispatch(tib, C, E)
    gathered = xb[token] * keep[:, None].to(xb.dtype)
    # add, not set: dropped assignments are zeroed and clamped onto slot
    # C-1, which must not clobber the kept token living there
    buf = torch.zeros((E * C, xb.shape[-1]), dtype=xb.dtype,
                      device=xb.device).index_add_(0, slot, gathered)
    return buf.reshape(E, C, xb.shape[-1]), token, slot, keep, order


def _experts(p: Params, device) -> Tuple[torch.Tensor, ...]:
    """The layer's expert table on the compute device. A host-tier table
    (pinned memory) is copied over for this call and dropped after it."""
    return tuple(p[k].to(device, non_blocking=True) for k in ("w1", "w3", "w2"))


def _combine(out, token, slot, keep, order, tw, S, E, C, dtype):
    contrib = out.reshape(E * C, -1)[slot] * \
        (tw.reshape(-1)[order] * keep)[:, None].to(dtype)
    return torch.zeros((S, out.shape[-1]), dtype=dtype,
                       device=out.device).index_add_(0, token, contrib)


def _moe_one_group(p: Params, xf: torch.Tensor, top_i: torch.Tensor,
                   top_w: torch.Tensor, m: MoEConfig, cf: float
                   ) -> torch.Tensor:
    """Flat single-group dispatch (decode-shaped: T = B tokens)."""
    T, D = xf.shape
    E, K = m.num_experts, m.top_k
    C = max(int(T * K / E * cf), 1)
    C = (C + 7) // 8 * 8
    buf, token, slot, keep, order = _dispatch(xf, top_i, C, E)
    w1, w3, w2 = _experts(p, xf.device)
    h = silu(mm(buf, w1)) * mm(buf, w3)
    out = mm(h, w2)
    return _combine(out, token, slot, keep, order, top_w, T, E, C, xf.dtype)


def moe_apply(p: Params, x: torch.Tensor, m: MoEConfig,
              capacity_factor: Optional[float] = None) -> torch.Tensor:
    """x: [B, S, D] -> y [B, S, D] (serve mode: no aux loss).

    Dispatch is per example when S > 1, one flat group when S == 1, with
    the reference's capacity rule (serve slack only where drops are
    probable: few assignments per dispatch group)."""
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    if capacity_factor is not None and (S if S > 1 else B * S) * K > 256:
        cf = m.capacity_factor
    xf = x.reshape(B * S, D)
    _, top_i, top_w = route(p["router"], xf, K)
    if S == 1:
        return _moe_one_group(p, xf, top_i, top_w, m, cf).reshape(B, S, D)
    C = max(int(S * K / E * cf), 1)
    C = (C + 7) // 8 * 8
    ti, tw = top_i.reshape(B, S, K), top_w.reshape(B, S, K)
    w1, w3, w2 = _experts(p, x.device)
    ys = []
    for b in range(B):
        buf, token, slot, keep, order = _dispatch(x[b], ti[b], C, E)
        h = silu(mm(buf, w1)) * mm(buf, w3)
        out = mm(h, w2)                            # [E, C, D]
        ys.append(_combine(out, token, slot, keep, order, tw[b], S, E, C,
                           x.dtype))
    return torch.stack(ys).reshape(B, S, D)
