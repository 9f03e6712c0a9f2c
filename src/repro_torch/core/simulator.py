"""Discrete-event simulator of single-request MoE token generation (the
port's own copy of the reference's ``core/simulator.py``).

Replays a router trace through the paper's execution strategies and the
calibrated cost model (:mod:`repro_torch.core.costmodel`), producing
tokens/s, hit rates and J/token: the quantities behind the paper's Fig. 5,
Fig. 6 and Tables IV/V. Every number it returns is a cost-model number for
the paper's testbed (AMD 7960X + RTX 4090 over PCIe 4.0 x16), not a
measurement of the card the port runs on.

Modeled mechanics for ``ours`` (the paper's framework):
  * set-associative cache bookkeeping through :class:`NumpyCache`;
  * a single async fetch engine (the second copy engine): a miss enqueues
    a post-fetch; the expert serves hits only once its transfer completes
    — a tag hit on an in-flight expert is serviced as a miss (compute
    proceeds on the CPU; no duplicate fetch is enqueued);
  * per-layer latency = other + max(GPU hit-expert time, activation round
    trip + CPU missed-expert time); GPU and CPU overlap;
  * layers beyond cache coverage run entirely on the CPU.

Baselines:
  cpu_only   — every expert on the CPU (the paper's lower bound).
  on_demand  — DeepSpeed/Accelerate-style fetch-then-compute on the GPU.
  pregated   — Pre-gated MoE idealized as *perfect* overlap (the paper's
               §IV-A grants it max(compute, transfer)).
  fiddler    — static popularity placement profiled on a *different*
               trace + per-model orchestration overhead calibrated to
               Fig. 5 (Fiddler's internals are not modeled from first
               principles).

``ours_prefetch`` extends ``ours`` with the engine's cross-layer
speculative prefetch: while layer l executes, the next layer's picks are
predicted (per-expert accuracy ``prefetch_accuracy``; a wrong prediction
substitutes a random expert) and reserved through
:meth:`NumpyCache.reserve`. Reservations ride the SAME single fetch
engine as demand post-fetches, so wasted speculative transfers delay
demand fetches; a reservation serves hits only once its transfer lands
(``ready_at``), from the next layer's probe at the earliest.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.config import CacheConfig
from .costmodel import (PREFETCH_PREDICTOR_ACCURACY, PREGATED_POWER_W,
                        PaperModelTimings, cpu_expert_ms, fetch_expert_ms,
                        gpu_expert_ms)
from .policies import NumpyCache

FIDDLER_OVERHEAD_MS = {"mixtral-8x7b": 3.7, "phi35-moe": 9.8}


@dataclass
class SimResult:
    tokens_per_s: float
    ms_per_token: float
    hit_rate: float
    both_hit_rate: float
    cpu_power_w: float = 0.0
    gpu_power_w: float = 0.0
    joules_per_token: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)


def _nearest_key(d: Dict[int, float], k: int) -> float:
    return d[min(d, key=lambda x: abs(x - k))]


def _fiddler_placement(trace: np.ndarray, timings: PaperModelTimings,
                       ccfg: Optional[CacheConfig], seed: int) -> set:
    """Static global-popularity placement, profiled on a shuffled tenth
    of the trace, in the same memory budget as ``ours``."""
    T, L, _ = trace.shape
    rng = np.random.default_rng(seed + 1)
    slots = (ccfg.num_indexes * ccfg.num_ways) if ccfg else L * 2
    profile = np.zeros((L, timings.num_experts))
    fake = trace[rng.permutation(T)][: max(T // 10, 1)]
    for l in range(L):
        np.add.at(profile[l], fake[:, l, :].reshape(-1), 1.0)
    order = np.dstack(np.unravel_index(
        np.argsort(-profile, axis=None), profile.shape))[0]
    return {(int(l), int(e)) for l, e in order[:slots]}


def simulate(trace: np.ndarray, timings: PaperModelTimings, threads: int,
             method: str = "ours", ccfg: Optional[CacheConfig] = None,
             seed: int = 0,
             prefetch_accuracy: float = PREFETCH_PREDICTOR_ACCURACY
             ) -> SimResult:
    """trace: [T, L, K] expert ids. Returns aggregate timing and energy
    (the paper testbed's cost model)."""
    T, L, K = trace.shape
    t_gpu = gpu_expert_ms(timings)
    t_cpu = cpu_expert_ms(timings, threads)
    t_fetch = fetch_expert_ms(timings)
    t_act = timings.act_transfer_ms
    t_other = timings.other_layer_ms

    cache = None
    ready_at: Dict[tuple, float] = {}
    fetch_free_at = 0.0
    pf_rng = np.random.default_rng(seed + 17)
    pf_issued = pf_wasted = pf_predicted = pf_correct = 0
    if method in ("ours", "ours_prefetch"):
        assert ccfg is not None
        cache = NumpyCache(ccfg, num_experts=timings.num_experts, seed=seed)
    if method == "fiddler":
        placed = _fiddler_placement(trace, timings, ccfg, seed)

    now = 0.0
    hits = accesses = both = 0
    for t in range(T):
        for l in range(L):
            experts = trace[t, l]
            accesses += K
            if method == "cpu_only":
                now += t_other + t_act + K * t_cpu
            elif method == "on_demand":
                now += t_other + K * t_fetch + K * t_gpu
            elif method == "pregated":
                now += max(K * t_fetch, t_other + K * t_gpu)
            elif method == "fiddler":
                h = [(l, int(e)) in placed for e in experts]
                nh = sum(h)
                hits += nh
                both += nh == K
                gpu_t = nh * t_gpu
                cpu_t = (t_act + (K - nh) * t_cpu) if nh < K else 0.0
                now += t_other + max(gpu_t, cpu_t) + \
                    FIDDLER_OVERHEAD_MS.get(timings.name, 3.7)
            elif method in ("ours", "ours_prefetch"):
                tag_hits = cache.access(l, experts)
                # a tag hit whose post-fetch hasn't landed is still a miss
                real = [h and ready_at.get((l, int(e)), 0.0) <= now
                        for h, e in zip(tag_hits, experts)]
                nh = sum(real)
                hits += nh
                both += nh == K
                gpu_t = nh * t_gpu
                cpu_t = (t_act + (K - nh) * t_cpu) if nh < K else 0.0
                # post-fetch misses on the async engine (covered sets only)
                if l < cache.tags.shape[0]:
                    for h, e in zip(tag_hits, experts):
                        if not h:
                            fetch_free_at = max(fetch_free_at, now) + t_fetch
                            ready_at[(l, int(e))] = fetch_free_at
                layer_ms = t_other + max(gpu_t, cpu_t)
                if method == "ours_prefetch" and l + 1 < L:
                    # predict layer l+1's picks: each actual pick survives
                    # with p = prefetch_accuracy, else a random expert is
                    # (wastefully) predicted; available at this layer's
                    # dispatch, so the transfer may overlap its compute
                    nxt = trace[t, l + 1]
                    pred = [int(e) if pf_rng.random() < prefetch_accuracy
                            else int(pf_rng.integers(timings.num_experts))
                            for e in nxt]
                    pf_predicted += len(pred)
                    pf_correct += sum(p in nxt for p in pred)
                    # window gate per transfer: a speculative fetch queues
                    # behind this layer's demand fetches on the one engine
                    # and is issued only if it lands inside this layer's
                    # compute window; the whole prediction batch stays
                    # protected even when only a prefix fits
                    for p in pred:
                        if max(fetch_free_at, now) + t_fetch \
                                > now + layer_ms:
                            break
                        iss = cache.reserve(l + 1, [p], protect=pred)
                        if iss[0]:
                            fetch_free_at = max(fetch_free_at, now) \
                                + t_fetch
                            ready_at[(l + 1, p)] = fetch_free_at
                            pf_issued += 1
                            pf_wasted += int(p not in nxt)
                    cache.land()
                now += layer_ms
            else:
                raise ValueError(method)

    ms_tok = now / T
    res = SimResult(
        tokens_per_s=1000.0 / ms_tok, ms_per_token=ms_tok,
        hit_rate=hits / max(accesses, 1),
        both_hit_rate=both / (T * L),
    )
    if method == "ours_prefetch":
        res.extra.update(
            prefetch_issued=pf_issued, prefetch_wasted=pf_wasted,
            prediction_accuracy=pf_correct / max(pf_predicted, 1),
            spec_hits=cache.spec_hits)
    if timings.cpu_power_w:
        if method == "pregated":
            res.cpu_power_w = PREGATED_POWER_W[timings.name]["cpu"]
            res.gpu_power_w = PREGATED_POWER_W[timings.name]["gpu"]
        else:
            res.cpu_power_w = _nearest_key(timings.cpu_power_w, threads)
            res.gpu_power_w = _nearest_key(timings.gpu_power_w, threads)
        res.joules_per_token = (res.cpu_power_w + res.gpu_power_w) \
            * ms_tok / 1000.0
    return res


def best_cache_config(timings: PaperModelTimings, mem_gb: float = 19.0,
                      ways_options=(2, 4, 8)) -> Dict[int, CacheConfig]:
    """The paper's §III-B slot math + §IV-C guidance: candidate (N, M)
    configs for a memory budget, keyed by ways."""
    out = {}
    slots = int(mem_gb * 1024 / timings.expert_mb)
    for m in ways_options:
        if m > timings.num_experts:
            continue
        n = min(slots // m, timings.num_layers)
        if n >= 1:
            out[m] = CacheConfig(num_indexes=n, num_ways=m)
    return out
