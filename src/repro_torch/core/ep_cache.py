"""Hot-expert replication planning for expert parallelism (the port's own
copy of the reference's ``core/ep_cache.py``).

At multi-device scale the paper's memory relation recurs one level up:
each device holds only its EP shard of experts (E / ep_degree), and
tokens routed to remote experts pay an all-to-all, the analogue of the
paper's PCIe fetch. The same cache mathematics applies:

  * each device keeps M_hot *remote* experts, refreshed from batch-level
    routing counts (the paper's Consecutive-Tokens locality becomes
    step-over-step skew locality of the batch);
  * a token whose expert is local or cached computes locally; only true
    misses cross the interconnect;
  * a refresh (the post-fetch) gathers the newly hot experts' weights.

These are pure numpy functions over routing counts: which experts to
replicate, the dispatch split and the all-to-all bytes saved. They place
nothing on any device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class EPCachePlan:
    """Per-device replication decision for one refresh interval."""
    hot_experts: np.ndarray        # [ep_degree, M_hot] expert ids per shard
    local_fraction: float          # tokens served locally after replication
    a2a_bytes_baseline: int
    a2a_bytes_with_cache: int
    refresh_bytes: int             # weight gather cost of the refresh

    @property
    def traffic_ratio(self) -> float:
        total = self.a2a_bytes_with_cache + self.refresh_bytes
        return total / max(self.a2a_bytes_baseline, 1)


def home_shard(expert: np.ndarray, num_experts: int, ep: int) -> np.ndarray:
    """Contiguous EP placement: expert e lives on shard e // (E/ep)."""
    return expert // (num_experts // ep)


def plan_replication(counts: np.ndarray, ep_degree: int, m_hot: int,
                     expert_bytes: int, token_bytes: int,
                     prev_hot: Optional[np.ndarray] = None) -> EPCachePlan:
    """Plan hot-expert replication from a step's routing counts.

    counts: [..., E] token counts per expert (summed over leading axes).
    ep_degree: EP group size. m_hot: replication slots per device.
    token_bytes: bytes of one token's activation row (D * dtype size).
    """
    counts = counts.reshape(-1, counts.shape[-1]).sum(axis=0)   # [E]
    E = counts.shape[0]
    assert E % ep_degree == 0
    per = E // ep_degree
    total_tokens = int(counts.sum())

    # baseline: every token for a non-local expert crosses the wire
    # (uniform token origin over shards -> (ep-1)/ep of traffic is remote)
    remote_frac = (ep_degree - 1) / ep_degree
    baseline = int(2 * total_tokens * remote_frac * token_bytes)  # and back

    hot = np.zeros((ep_degree, m_hot), np.int64)
    extra_local = 0.0
    refresh = 0
    for shard in range(ep_degree):
        own = np.arange(shard * per, (shard + 1) * per)
        remote = np.setdiff1d(np.arange(E), own)
        order = remote[np.argsort(-counts[remote])]
        pick = order[:m_hot]
        hot[shard] = pick
        # replicated experts serve this shard's tokens locally
        extra_local += counts[pick].sum() / ep_degree
        if prev_hot is not None:
            new = np.setdiff1d(pick, prev_hot[shard])
            refresh += int(len(new)) * expert_bytes
        else:
            refresh += m_hot * expert_bytes

    local_tokens = counts.sum() / ep_degree + extra_local
    local_frac = float(min(local_tokens / max(total_tokens, 1), 1.0))
    with_cache = int(baseline * max(0.0, 1 - (local_frac - 1 / ep_degree)
                                    / max(remote_frac, 1e-9)))
    return EPCachePlan(hot_experts=hot, local_fraction=local_frac,
                       a2a_bytes_baseline=baseline,
                       a2a_bytes_with_cache=with_cache,
                       refresh_bytes=refresh)


def simulate_ep_cache(trace: np.ndarray, ep_degree: int, m_hot: int,
                      expert_bytes: int, token_bytes: int,
                      refresh_every: int = 1) -> Tuple[float, float]:
    """Replay a routing trace [T, L, K]; returns (mean local fraction,
    mean traffic ratio against the baseline all-to-all)."""
    T = trace.shape[0]
    E = int(trace.max()) + 1
    prev = None
    fracs, ratios = [], []
    for t in range(0, T, max(refresh_every, 1)):
        window = trace[t: t + refresh_every]
        counts = np.zeros(E, np.int64)
        np.add.at(counts, window.reshape(-1), 1)
        plan = plan_replication(counts, ep_degree, m_hot, expert_bytes,
                                token_bytes, prev_hot=prev)
        prev = plan.hot_experts
        fracs.append(plan.local_fraction)
        ratios.append(plan.traffic_ratio)
    return float(np.mean(fracs)), float(np.mean(ratios))
