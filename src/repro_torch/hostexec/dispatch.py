"""The hybrid dispatcher stage: partition a step's expert groups into the
card's lane and the CPU miss lane (the port's counterpart of the
reference's ``hostexec/dispatch.py``).

Drop-in for :func:`repro_torch.core.collaborative.execute` when
``EngineConfig.host_compute`` is on:

  * hit groups (resident in the slot buffer) run through the grouped gmm
    kernels, as always;
  * miss groups the cost model sends to the CPU
    (:class:`~repro_torch.hostexec.policy.HostDispatchPolicy`) ship their
    rows of the ``[G, A, D]`` dispatch buffer to the host executor and get
    their outputs back before the combine — activations move, weights do
    not;
  * the other misses (the fetch lane) are staged from the host tier and run
    on the card, as always.

Cache semantics are the same in all three: the probe's bookkeeping and
commit's post-fetch are untouched, so a miss the policy admits still warms
the cache — its weights go host->device on the copy stream, off the
critical path. The host lane changes where FLOPs run and the stats
channel, never residency. Its math is float32 over the bf16 tier: close to
the card's lane, not bitwise equal.

The reference's in-graph ``host_backend="jax"`` has no PyTorch meaning:
it is exactly ``host_compute=False`` with these counters.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import CacheConfig
from repro_torch.core import collaborative as collab

__all__ = ["dispatch_execute", "dispatch_plan"]


def dispatch_plan(pr: collab.ProbeResult, cpu_table
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition the probe's groups: (to_cpu [G] bool, counts [G] int32).

    counts — valid assignments per group; to_cpu — non-resident groups the
    cost model sends to the host (``cpu_table[c]``: run a c-token miss
    group on the CPU; index 0 is False so empty groups never dispatch).
    Resident groups always stay on the card."""
    table = torch.as_tensor(cpu_table, dtype=torch.bool)
    counts = collab.group_counts(pr)
    miss = ~pr.resident & (pr.rep_e >= 0)
    to_cpu = miss & table[counts.clamp(max=table.shape[0] - 1).long()]
    return to_cpu, counts


def dispatch_execute(tiers: collab.ExpertTiers, layer: int,
                     x: torch.Tensor, top_w: torch.Tensor,
                     pr: collab.ProbeResult, ccfg: CacheConfig, cpu_table,
                     executor=None, fuse_small: int = 0
                     ) -> Tuple[torch.Tensor, Optional[collab.Staged],
                                Dict[str, int]]:
    """Stage 2' — hybrid grouped execution with host-computed misses.

    As :func:`repro_torch.core.collaborative.execute`, plus the split
    table and the executor (required when the table sends a group to the
    CPU); ``fuse_small`` is the executor's fusion threshold (the stat
    mirrors it). Returns (y [T, D], the device lane's staged weights for
    commit's post-fetch, dispatch stats {cpu_expert_calls, cpu_tokens,
    miss_expert_groups, fused_groups})."""
    to_cpu, counts = dispatch_plan(pr, cpu_table)
    y, staged = collab.execute_lanes(tiers, layer, x, top_w, pr, ccfg,
                                     to_cpu, executor, counts)
    executed_miss = ~pr.resident & (pr.rep_e >= 0) & (counts > 0)
    dstats = {
        "cpu_expert_calls": int(to_cpu.sum()),
        "cpu_tokens": int(counts[to_cpu].sum()),
        # every executed non-resident group reads the host tier, whatever
        # lane it takes
        "miss_expert_groups": int(executed_miss.sum()),
        "fused_groups": (int((to_cpu & (counts <= fuse_small)).sum())
                         if fuse_small > 0 else 0),
    }
    return y, staged, dstats
