"""The train step: loss -> grads -> clip -> (compress) -> AdamW (the
port's ``optim/train_step.py``, the reference's at world size 1).

The reference's mesh branches (ZeRO-1 resharding of the gradients and
optimizer state, the fp32 accumulator in the optimizer sharding) belong
to ``sharding/``, slice 8 of the port, and are not here: this is the
reference's step with no mesh active, where its sharding constraints
are no-ops.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.config import ModelConfig, OptimizerConfig
from repro_torch.models import loss_fn
from repro_torch.tree import leaves, tree_map, unflatten
from .adamw import (AdamWState, adamw_update, clip_by_global_norm,
                    maybe_compress_grads)


def _split_micro(batch: Dict[str, torch.Tensor], micro: int
                 ) -> List[Dict[str, torch.Tensor]]:
    """The global batch as ``micro`` microbatches of B/micro rows.
    ``positions`` carries the batch on dim 1 ([3, B, S]); everything else
    on dim 0."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(micro)]
    for k, v in batch.items():
        parts = v.chunk(micro, dim=1 if k == "positions" else 0)
        for i in range(micro):
            out[i][k] = parts[i]
    return out


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    remat: bool = True, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "xent", "aux"}). The step updates
    ``params`` and the state's tensors in place (the reference donates
    both) and returns them. Every floating-point leaf of ``params`` is
    made to require grad.

    microbatches > 1 = gradient accumulation: forward and backward run
    per microbatch, the gradients summed in fp32 and scaled by
    1/microbatches (so they reach the clip and the update in fp32, as
    the reference's scan carry does); loss, xent and aux are the means."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def _grads(params, batch):
        ls = leaves(params)
        for p in ls:
            if p.is_floating_point() and not p.requires_grad:
                p.requires_grad_(True)
        loss, parts = loss_fn(params, batch, cfg, remat=remat)
        gs = torch.autograd.grad(loss, ls, allow_unused=True,
                                 materialize_grads=True)
        grads = unflatten(params, iter(gs))
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            grads

    def train_step(params, opt_state: AdamWState, batch
                   ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        if microbatches > 1:
            gsum = None
            lsum = xsum = asum = 0.0
            for mb in _split_micro(batch, microbatches):
                loss, parts, g = _grads(params, mb)
                gsum = tree_map(lambda t: t.to(torch.float32), g) \
                    if gsum is None else tree_map(
                        lambda a, b: a.add_(b.to(torch.float32)), gsum, g)
                lsum = lsum + loss
                xsum = xsum + parts["xent"]
                asum = asum + parts["aux"]
            inv = 1.0 / microbatches
            grads = tree_map(lambda t: t * inv, gsum)
            loss = lsum * inv
            parts = {"xent": xsum * inv, "aux": asum * inv}
        else:
            loss, parts, grads = _grads(params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, ocfg.grad_clip)
            grads = maybe_compress_grads(grads, ocfg)
        params, opt_state = adamw_update(grads, opt_state, params, ocfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **parts}

    return train_step

