"""Streaming log-bucket histograms for latency percentiles (the port's
own copy of the reference's ``obs/metrics.py``).

``RunStats`` reports p50/p95/p99 for TTFT, TPOT and admission stall.
Storing raw samples would grow without bound under the ROADMAP's
traffic-scale load harness, so samples land in geometric buckets
instead: bucket ``i`` covers ``[GROWTH**i, GROWTH**(i+1))``, giving a
bounded relative error of ``GROWTH - 1`` (~8% half-width, i.e. ≤~4%
from a bucket's geometric midpoint) at any scale from microseconds to
minutes. ``observe`` is two integer ops and an array increment — cheap
enough to run unconditionally, which is why the histograms feed
``RunStats`` even when the trace recorder is the no-op one.

The percentile estimator interpolates within the winning bucket's
span, and the parity test pins it against ``np.percentile`` on the raw
samples to within the bucket error bound.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

GROWTH = 1.08
_LOG_GROWTH = math.log(GROWTH)


class LogHistogram:
    """Fixed-growth log-bucket histogram over positive samples.

    Buckets are allocated lazily in a dict keyed by bucket index, so an
    idle histogram costs nothing and a busy one holds ~#decades/log10
    (GROWTH) entries (~30 per decade at 1.08).
    """

    __slots__ = ("_buckets", "count", "total", "min", "max")

    def __init__(self) -> None:
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        """Record one sample. Non-positive samples clamp to the lowest
        bucket (duration math can round to 0 at ns resolution)."""
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        idx = (math.floor(math.log(value) / _LOG_GROWTH)
               if value > 0.0 else -(10 ** 9))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0 <= q <= 100). Interpolates
        linearly inside the winning bucket; exact at the recorded min
        and max endpoints."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile out of range: {q}")
        if self.count == 0:
            return 0.0
        # rank in [0, count-1], same convention as np.percentile linear
        rank = q / 100.0 * (self.count - 1)
        if rank >= self.count - 1:
            return self.max
        seen = 0
        for idx in sorted(self._buckets):
            n = self._buckets[idx]
            if seen + n > rank:
                lo = GROWTH ** idx if idx > -(10 ** 9) else 0.0
                hi = GROWTH ** (idx + 1) if idx > -(10 ** 9) else 0.0
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / n
                return lo + frac * (hi - lo)
            seen += n
        return self.max

    def percentiles(self, qs: Sequence[float] = (50.0, 95.0, 99.0)
                    ) -> List[float]:
        return [self.percentile(q) for q in qs]

    def to_json(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }
