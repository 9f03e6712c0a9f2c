"""AdamW with fp32 master weights (the port's ``optim/adamw.py``, the
counterpart of the reference's at world size 1: its ZeRO-1 sharding of
the optimizer state has no counterpart, as the port runs on one device).

The rounding points are the reference's: gradients stay in the
parameter's dtype (bf16 for bf16 leaves) through the clip, whose scale
is cast to that dtype; the moments and the master copy are fp32; the
schedule and the bias corrections ``1 - b**step`` are fp32 tensors (a
Python float would compute them in float64 and move the update). The
update runs in place under ``torch.no_grad``, elementwise in the
reference's order, over flat slices of each leaf (:data:`SLICE`
elements) so that its fp32 temporaries stay small beside a large leaf.
Optional int8 gradient compression models the cross-pod all-reduce
precision reduction.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, NamedTuple, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.tree import leaves, tree_map

SLICE = 1 << 24          # elements of a leaf updated at a time


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    mu: Any
    nu: Any
    master: Any


def init_opt_state(params: Any) -> AdamWState:
    """Zero fp32 moments and an fp32 master copy of every leaf (a copy
    even of an fp32 leaf: the update writes the master in place)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      master=master)


def lr_schedule(ocfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10%, in fp32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(ocfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - ocfg.warmup_steps)
                       / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0, 1)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return ocfg.lr * warm * cos


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), n


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization (DCN gradient compression)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def maybe_compress_grads(grads: Any, ocfg: OptimizerConfig) -> Any:
    """Round-trips grads through int8 (the precision the pod-axis
    all-reduce would carry). No-op unless ocfg.compress_pod_grads."""
    if not ocfg.compress_pod_grads:
        return grads

    def rt(g):
        if g.dim() == 0:
            return g
        return decompress_int8(*compress_int8(g)).to(g.dtype)
    return tree_map(rt, grads)


def _slices(g: torch.Tensor, *ts: torch.Tensor
            ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Flat slices of a gradient (read) and of the tensors the update
    writes in place (views: they are contiguous)."""
    flat = [g.reshape(-1)] + [t.view(-1) for t in ts]
    for i in range(0, flat[0].numel(), SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 ocfg: OptimizerConfig) -> Tuple[Any, AdamWState]:
    """One AdamW step IN PLACE: the moments and master of ``state`` and
    the leaves of ``params`` (the master rounded to each leaf's dtype).
    Returns (params, the new state)."""
    step = state.step + 1
    lr = lr_schedule(ocfg, step)
    b1, b2 = ocfg.beta1, ocfg.beta2
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=sf.device), sf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=sf.device), sf)
    for g, mu, nu, master, p in zip(
            *(leaves(t) for t in (grads, state.mu, state.nu,
                                       state.master, params))):
        for gs, ms, ns, ws, ps in _slices(g, mu, nu, master, p):
            gs = gs.to(torch.float32)
            ms.mul_(b1).add_(gs * (1 - b1))
            ns.mul_(b2).add_(gs * (1 - b2) * gs)
            upd = (ms / c1).div_(torch.sqrt(ns / c2).add_(ocfg.eps))
            ws.sub_(upd.add_(ws * ocfg.weight_decay).mul_(lr))
            ps.copy_(ws)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu,
                              master=state.master)
