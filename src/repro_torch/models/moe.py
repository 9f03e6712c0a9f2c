"""Top-k MoE FFN with sort-based capacity dispatch (counterpart of the
reference's ``models/moe.py``).

This is the dense-framework path over the full expert table: the
engine's prefill forward, every forward of the generic path's MoE layers
(jamba, llama4) and every train-mode forward (:func:`moe_train`, with
the Switch load-balance loss); the engine's decode step runs the two-tier
execution of :mod:`repro_torch.core.collaborative`. The engine's forward
gives :func:`moe_apply` its own source of the layer's table
(:class:`repro_torch.core.collaborative.ForwardExperts`: resident experts
from the cache's slots, the rest from the host tier, a layer ahead);
every other caller reads the layer's own tables (:func:`_experts`). The
expert products here are plain large matrix products (the reference
leaves them to XLA einsums), differentiable through the dispatch's
gathers and scatters and the combine weights, so the router trains. A
layer with shared experts (``p["shared"]``, a dense SwiGLU FFN of
``num_shared_experts`` x d_ff) adds their output to the routed one.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import MoEConfig
from .layers import ffn_apply, mm, silu

Params = Dict[str, torch.Tensor]
Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]    # w1, w3, w2


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, D] -> (probs [T, E] fp32, top-k ids [T, K], weights [T, K])."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_i.to(torch.int32), top_w


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch aux loss: E * sum_e f_e * P_e (fp32 scalar), f the share of
    assignments an expert takes, P its mean router probability."""
    f = torch.zeros(num_experts, dtype=torch.float32,
                    device=probs.device).index_add_(
        0, top_i.reshape(-1).long(),
        torch.ones(top_i.numel(), dtype=torch.float32, device=probs.device))
    f = f / torch.clamp(f.sum(), min=1.0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


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
    """The layer's expert table on the compute device, where the caller
    gives no source of its own: a host-tier table (pinned memory) is
    copied over whole for this call and dropped after it; the generic
    path's tables already live there."""
    return tuple(p[k].to(device, non_blocking=True) for k in ("w1", "w3", "w2"))


def _combine(out, token, slot, keep, order, tw, S, E, C, dtype):
    contrib = out.reshape(E * C, -1)[slot] * \
        (tw.reshape(-1)[order] * keep)[:, None].to(dtype)
    return torch.zeros((S, out.shape[-1]), dtype=dtype,
                       device=out.device).index_add_(0, token, contrib)


def _moe_one_group(p: Params, xf: torch.Tensor, top_i: torch.Tensor,
                   top_w: torch.Tensor, m: MoEConfig, cf: float,
                   experts: Optional[Callable[[], Tables]] = None
                   ) -> torch.Tensor:
    """Flat single-group dispatch (decode-shaped: T = B tokens)."""
    T, D = xf.shape
    E, K = m.num_experts, m.top_k
    C = max(int(T * K / E * cf), 1)
    C = (C + 7) // 8 * 8
    buf, token, slot, keep, order = _dispatch(xf, top_i, C, E)
    w1, w3, w2 = experts() if experts else _experts(p, xf.device)
    h = silu(mm(buf, w1)) * mm(buf, w3)
    out = mm(h, w2)
    return _combine(out, token, slot, keep, order, top_w, T, E, C, xf.dtype)


def moe_apply(p: Params, x: torch.Tensor, m: MoEConfig,
              capacity_factor: Optional[float] = None,
              experts: Optional[Callable[[], Tables]] = None
              ) -> torch.Tensor:
    """x: [B, S, D] -> y [B, S, D] (serve mode: no aux loss).

    Dispatch is per example when S > 1, one flat group when S == 1, with
    the reference's capacity rule (serve slack only where drops are
    probable: few assignments per dispatch group). ``experts``, called
    once, gives the layer's (w1, w3, w2) on x's device in place of
    :func:`_experts` over ``p``'s tables."""
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    if capacity_factor is not None and (S if S > 1 else B * S) * K > 256:
        cf = m.capacity_factor
    xf = x.reshape(B * S, D)
    _, top_i, top_w = route(p["router"], xf, K)
    if S == 1:
        y = _moe_one_group(p, xf, top_i, top_w, m, cf, experts)
    else:
        C = max(int(S * K / E * cf), 1)
        C = (C + 7) // 8 * 8
        ti, tw = top_i.reshape(B, S, K), top_w.reshape(B, S, K)
        w1, w3, w2 = experts() if experts else _experts(p, x.device)
        ys = []
        for b in range(B):
            buf, token, slot, keep, order = _dispatch(x[b], ti[b], C, E)
            h = silu(mm(buf, w1)) * mm(buf, w3)
            out = mm(h, w2)                        # [E, C, D]
            ys.append(_combine(out, token, slot, keep, order, tw[b], S, E,
                               C, x.dtype))
        y = torch.cat(ys)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xf)
    return y.reshape(B, S, D)


def moe_train(p: Params, x: torch.Tensor, m: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train mode: x [B, S, D] -> (y [B, S, D], the load-balance loss),
    with the train capacity factor (``m.capacity_factor``: tokens past an
    expert's capacity drop), as the reference's ``moe_apply`` with
    ``capacity_factor=None``. S > 1 dispatches per example and runs the
    expert products of all B examples as one [E, B*C, D] product, as the
    reference's ``becd,edf`` einsum does, so each expert's weight
    gradient sums the whole batch in one product and rounds once."""
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    xf = x.reshape(B * S, D)
    probs, top_i, top_w = route(p["router"], xf, K)
    aux = load_balance_loss(probs, top_i, E)
    if S == 1:
        y = _moe_one_group(p, xf, top_i, top_w, m, m.capacity_factor)
    else:
        C = max(int(S * K / E * m.capacity_factor), 1)
        C = (C + 7) // 8 * 8
        ti, tw = top_i.reshape(B, S, K), top_w.reshape(B, S, K)
        ds = [_dispatch(x[b], ti[b], C, E) for b in range(B)]
        buf = torch.stack([d[0] for d in ds], dim=1).reshape(E, B * C, D)
        w1, w3, w2 = _experts(p, x.device)
        h = silu(mm(buf, w1)) * mm(buf, w3)
        out = mm(h, w2).reshape(E, B, C, D)
        y = torch.cat([_combine(out[:, b], *ds[b][1:], tw[b], S, E, C,
                                x.dtype) for b in range(B)])
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xf)
    return y.reshape(B, S, D), aux
