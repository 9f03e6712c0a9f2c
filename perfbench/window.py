"""End-to-end metrics of one measured window, from the host times at which
each request was sent and each of its tokens reached the client.

All times are ``time.perf_counter()`` seconds. A token counts where its
arrival lies in ``[t0, t1]``; a gap between two tokens of one request
counts where both lie in the window; a request's time to first token counts
where its first token lies in the window.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclass
class Served:
    """One request as its client saw it."""
    index: int
    prompt_len: int
    t_send: float
    times: List[float] = field(default_factory=list)   # token arrivals
    tokens: List[int] = field(default_factory=list)
    done: bool = False


def _inside(t: float, t0: float, t1: float) -> bool:
    return t0 <= t <= t1


def gaps(served: Iterable[Served], t0: float, t1: float) -> List[float]:
    """Every inter-token gap (s) of every request with both ends inside."""
    out = []
    for s in served:
        for a, b in zip(s.times, s.times[1:]):
            if _inside(a, t0, t1) and _inside(b, t0, t1):
                out.append(b - a)
    return out


def tokens_in(served: Iterable[Served], t0: float, t1: float) -> int:
    return sum(_inside(t, t0, t1) for s in served for t in s.times)


def ttfts(served: Iterable[Served], t0: float, t1: float) -> List[float]:
    return [s.times[0] - s.t_send for s in served
            if s.times and _inside(s.times[0], t0, t1)]


def p95(values: List[float]) -> float:
    """The 95th percentile, linearly interpolated between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95.0))


def end_to_end(served: List[Served], t0: float, t1: float
               ) -> Dict[str, Optional[float]]:
    """tok_s, tpot_ms, itl_p95_ms, ttft_ms over the window (None where the
    window holds nothing to measure)."""
    g = gaps(served, t0, t1)
    tt = ttfts(served, t0, t1)
    return {
        "tok_s": tokens_in(served, t0, t1) / (t1 - t0),
        "tpot_ms": 1e3 * sum(g) / len(g) if g else None,
        "itl_p95_ms": 1e3 * p95(g) if g else None,
        "ttft_ms": 1e3 * sum(tt) / len(tt) if tt else None,
    }


def decode_positions(served: Iterable[Served], t0: float, t1: float
                     ) -> List[int]:
    """Keys each decode-step token of the window attended: a request's
    token i (i >= 1; token 0 comes from its prefill) was produced at
    position prompt_len + i - 1 and saw prompt_len + i keys."""
    out = []
    for s in served:
        for i, t in enumerate(s.times):
            if i >= 1 and _inside(t, t0, t1):
                out.append(s.prompt_len + i)
    return out
