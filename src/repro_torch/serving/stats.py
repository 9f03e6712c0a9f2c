"""Typed serving statistics (the port's own copy of the reference's
``serving/stats.py``).

Replaces the string-keyed stats dicts of the engine and the scheduler:
:class:`EngineStats` is an immutable snapshot of the engine's counters
(demand + prefetch + prefill channels, per-layer series), and
:class:`RunStats` wraps one scheduler run around it with request-level
accounting. Both are frozen dataclasses with typed integer counters,
zero-guarded derived-rate properties, and a ``to_json()`` that emits only
JSON-native types — array-valued series (the per-layer hit-rate vector)
live behind properties, never mixed into a scalar dict, so the export
round-trips through ``json.dumps``/``json.loads`` exactly.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Tuple

import numpy as np

__all__ = ["EngineStats", "RunStats"]


@dataclass(frozen=True)
class EngineStats:
    """Counters of one :class:`~repro_torch.serving.CollaborativeEngine`.

    Decode (demand) channel: ``hits`` / ``accesses`` / ``host_assignments``
    / ``fetched_experts`` over decode-step expert assignments, plus
    ``tokens`` (active decoded tokens) and ``steps`` (padded batch steps).
    Prefetch channel: cross-layer speculation counters. Prefill channel:
    the cache-warming chunked-prefill accesses — kept separate so decode
    demand hit rates stay comparable with and without warming. Host
    channel: miss-expert groups the hybrid dispatcher ran on the CPU
    (``cpu_expert_calls``) and their token assignments (``cpu_tokens``).
    """
    # decode demand channel
    hits: int = 0
    accesses: int = 0
    host_assignments: int = 0
    fetched_experts: int = 0
    tokens: int = 0
    steps: int = 0
    # cross-layer speculative prefetch channel
    prefetch_issued: int = 0
    prefetch_hits: int = 0
    prefetch_wasted: int = 0
    predicted: int = 0
    predicted_correct: int = 0
    # chunked-prefill (cache warming) channel
    prefill_hits: int = 0
    prefill_accesses: int = 0
    prefill_fetched: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    # first tokens sampled from prefill logits (one per request / batch
    # row) — kept apart from the decode-step ``tokens`` counter so decode
    # rates stay per-step, but folded into ``generated_tokens`` totals
    first_tokens: int = 0
    # segment-streamed prefill channel (prefill_segment engines): prompt
    # segments forwarded between decode ticks, and prompt tokens whose
    # forward AND warm a prefix hit skipped outright
    prefill_segments: int = 0
    prefix_tokens_skipped: int = 0
    # live host-execution channel (the host lane): cache-miss expert
    # groups the cost-model dispatcher ran on the CPU, the token
    # assignments they carried, and the total executed non-resident
    # groups (CPU + fetch lanes — only counted while the dispatcher runs)
    cpu_expert_calls: int = 0
    cpu_tokens: int = 0
    miss_expert_groups: int = 0
    # CPU-miss groups the host executor's small-group fusion lane batched
    # into one stacked matmul instead of one pool task each
    fused_groups: int = 0
    # executor pool-census channel (read from the host executor):
    # censused dispatches, their summed effective
    # worker counts (mean workers = census_threads / census_calls), and
    # groups that landed on their thread-affinity bucket
    census_calls: int = 0
    census_threads: int = 0
    affinity_hits: int = 0
    # executor pool-utilization channel: summed per-worker microseconds spent inside expert FFN compute, and
    # the high-water mark of bucket tasks one dispatch submitted
    host_busy_us: int = 0
    host_queue_peak: int = 0
    # paged-KV channel (kv_paged engines): current page-pool occupancy
    # (gauge), admissions served from the prefix index, and partial last
    # pages duplicated by copy-on-write appends
    kv_pages_in_use: int = 0
    prefix_hits: int = 0
    cow_forks: int = 0
    # zero-ref prefix pages parked in the pool's retention LRU (gauge)
    prefix_pages_retained: int = 0
    # per-MoE-layer demand series (tuples: immutable + JSON-native)
    per_layer_hits: Tuple[int, ...] = ()
    per_layer_accesses: Tuple[int, ...] = ()

    # -- derived rates (all zero-guarded) ---------------------------------
    @property
    def generated_tokens(self) -> int:
        """Total generated output tokens: decode-step tokens plus the
        first token of every request/row (sampled from prefill logits) —
        the number token-based throughput should divide by."""
        return self.tokens + self.first_tokens

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)

    @property
    def prefetch_hit_rate(self) -> float:
        """Share of demand accesses served by a landed reservation."""
        return self.prefetch_hits / max(self.accesses, 1)

    @property
    def prefetch_waste_rate(self) -> float:
        return self.prefetch_wasted / max(self.prefetch_issued, 1)

    @property
    def prediction_accuracy(self) -> float:
        return self.predicted_correct / max(self.predicted, 1)

    @property
    def prefill_hit_rate(self) -> float:
        return self.prefill_hits / max(self.prefill_accesses, 1)

    @property
    def cpu_offload_rate(self) -> float:
        """Share of miss assignments the dispatcher computed on the CPU."""
        return self.cpu_tokens / max(self.host_assignments, 1)

    @property
    def per_layer_hit_rates(self) -> np.ndarray:
        """Demand hit rate per MoE layer ([num_layers] float; layers with
        zero accesses report 0.0). Array-valued: exposed as a property so
        the scalar counters and ``to_json()`` stay array-free."""
        acc = np.asarray(self.per_layer_accesses, np.int64)
        hit = np.asarray(self.per_layer_hits, np.int64)
        return np.where(acc > 0, hit / np.maximum(acc, 1), 0.0)

    def to_json(self) -> Dict:
        """JSON-native export: int counters, float rates, list series."""
        d = {k: int(v) for k, v in asdict(self).items()
             if not isinstance(v, tuple)}
        d.update(
            generated_tokens=int(self.generated_tokens),
            hit_rate=float(self.hit_rate),
            prefetch_hit_rate=float(self.prefetch_hit_rate),
            prefetch_waste_rate=float(self.prefetch_waste_rate),
            prediction_accuracy=float(self.prediction_accuracy),
            prefill_hit_rate=float(self.prefill_hit_rate),
            cpu_offload_rate=float(self.cpu_offload_rate),
            per_layer_hits=[int(x) for x in self.per_layer_hits],
            per_layer_accesses=[int(x) for x in self.per_layer_accesses],
            per_layer_hit_rates=[float(x) for x in self.per_layer_hit_rates],
        )
        return d


@dataclass(frozen=True)
class RunStats:
    """One scheduler run: request accounting around an EngineStats
    snapshot — including the overlapped-admission channel
    (``prefill_pending`` slots warming right now, cumulative
    ``admission_stalls`` ticks with a request waiting in queue, and
    ``queue_rejected`` bounded-admission rejections). Engine counters and
    rates are reachable directly (``run.hit_rate`` delegates to
    ``run.engine.hit_rate``)."""
    engine: EngineStats = field(default_factory=EngineStats)
    requests_submitted: int = 0
    requests_finished: int = 0
    requests_active: int = 0
    requests_queued: int = 0
    prefill_pending: int = 0
    admission_stalls: int = 0
    queue_rejected: int = 0
    # latency percentiles (milliseconds) from the scheduler's streaming
    # log-bucket histograms (repro_torch.obs.metrics.LogHistogram — ~4%
    # relative bucket error): time to first token (submit → first token),
    # per-token inter-arrival (TPOT), and the admission-work stall the
    # decode loop absorbed on ticks that admitted or warmed a request
    ttft_ms_p50: float = 0.0
    ttft_ms_p95: float = 0.0
    ttft_ms_p99: float = 0.0
    tpot_ms_p50: float = 0.0
    tpot_ms_p95: float = 0.0
    tpot_ms_p99: float = 0.0
    stall_ms_p50: float = 0.0
    stall_ms_p95: float = 0.0
    stall_ms_p99: float = 0.0

    def __getattr__(self, name):
        # delegate unknown attributes to the engine snapshot so call sites
        # read run.hits / run.hit_rate without the .engine hop. "engine"
        # itself (and dunders) must raise a plain AttributeError: during
        # copy/pickle reconstruction the instance has no fields yet, and
        # delegating the "engine" miss to self.engine would recurse
        # forever
        if name.startswith("__") or name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    def to_json(self) -> Dict:
        return {
            "requests_submitted": int(self.requests_submitted),
            "requests_finished": int(self.requests_finished),
            "requests_active": int(self.requests_active),
            "requests_queued": int(self.requests_queued),
            "prefill_pending": int(self.prefill_pending),
            "admission_stalls": int(self.admission_stalls),
            "queue_rejected": int(self.queue_rejected),
            "ttft_ms_p50": float(self.ttft_ms_p50),
            "ttft_ms_p95": float(self.ttft_ms_p95),
            "ttft_ms_p99": float(self.ttft_ms_p99),
            "tpot_ms_p50": float(self.tpot_ms_p50),
            "tpot_ms_p95": float(self.tpot_ms_p95),
            "tpot_ms_p99": float(self.tpot_ms_p99),
            "stall_ms_p50": float(self.stall_ms_p50),
            "stall_ms_p95": float(self.stall_ms_p95),
            "stall_ms_p99": float(self.stall_ms_p99),
            "engine": self.engine.to_json(),
        }
