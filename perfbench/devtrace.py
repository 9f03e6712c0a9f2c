"""Reduction of a ``torch.profiler`` Chrome trace (CUDA activity) to what
the per-layer metrics read: the device's operations on the host's clock.

Clock: the harness calls ``torch.cuda.synchronize()`` as the window
opens and as it closes, reading ``perf_counter_ns`` just before each. The
trace records both calls (``cudaDeviceSynchronize``, on its own clock,
beside the profiler's own at its start and stop); the line through the
two calls' starts maps the trace's times onto ``perf_counter_ns``, the
clock of the program's spans and the window. A trace in which no pair of calls lies as far
apart as the marks gives no reading.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "cudaDeviceSynchronize"
MAX_SKEW = 0.01          # the two clocks' rates agree far closer than this


@dataclass(frozen=True)
class Op:
    name: str
    cat: str
    t0: int             # ns, perf_counter_ns domain
    t1: int
    stream: int
    nbytes: int


@dataclass
class DeviceTrace:
    ops: List[Op]
    scale: float            # host ns a trace ns
    syncs: int              # synchronize calls the trace holds

    def within(self, t0: int, t1: int) -> List[Op]:
        return [o for o in self.ops if o.t1 > t0 and o.t0 < t1]


def _mark_pair(syncs: Sequence[float], starts: Sequence[float]
               ) -> Tuple[float, float]:
    """The two synchronize calls (trace ns) that are the harness's marks:
    of all pairs, the one whose spacing is nearest the marks' spacing on
    the host (the profiler synchronizes at its own start and stop too)."""
    want = starts[1] - starts[0]
    return min(((a, b) for i, a in enumerate(syncs) for b in syncs[i + 1:]),
               key=lambda p: abs((p[1] - p[0]) - want))


def load(path: Path, marks: Sequence[Tuple[int, int]]) -> Optional[
        DeviceTrace]:
    """Parse ``path``. ``marks``: the (before, after) ``perf_counter_ns``
    readings around the two synchronize calls. None if the trace holds
    no device work or not the two synchronize calls to align by."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    syncs = sorted(e["ts"] * 1e3 for e in events
                   if e.get("ph") == "X" and e.get("name") == SYNC)
    if len(syncs) < 2:
        return None
    starts = [a for a, _ in marks]
    s0, s1 = _mark_pair(syncs, starts)
    scale = (starts[1] - starts[0]) / (s1 - s0) if s1 > s0 else 0.0
    if abs(scale - 1.0) > MAX_SKEW:
        return None          # the marks are not in the trace

    def host(ts_ns: float) -> int:
        return int(starts[0] + (ts_ns - s0) * scale)

    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        t0 = host(e["ts"] * 1e3)
        ops.append(Op(name=e.get("name", ""), cat=e["cat"], t0=t0,
                      t1=t0 + int(e.get("dur", 0) * 1e3 * scale),
                      stream=int(args.get("stream", e.get("tid", 0)) or 0),
                      nbytes=int(args.get("bytes", 0) or 0)))
    if not ops:
        return None
    ops.sort(key=lambda o: o.t0)
    return DeviceTrace(ops=ops, scale=scale, syncs=len(syncs))


def busy_intervals(ops: Sequence[Op], t0: int, t1: int
                   ) -> List[Tuple[int, int]]:
    """The union of the ops' intervals, clipped to [t0, t1]."""
    spans = sorted((max(o.t0, t0), min(o.t1, t1)) for o in ops
                   if o.t1 > t0 and o.t0 < t1)
    out: List[Tuple[int, int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def busy_ns(ops: Sequence[Op], t0: int, t1: int) -> int:
    return sum(b - a for a, b in busy_intervals(ops, t0, t1))


def idle_intervals(ops: Sequence[Op], t0: int, t1: int
                   ) -> List[Tuple[int, int]]:
    out, cur = [], t0
    for a, b in busy_intervals(ops, t0, t1):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return out


def top_ops(ops: Sequence[Op], n: int = 10) -> List[List]:
    """[[name, seconds], ...]: device time by operation name, largest
    first."""
    by: Dict[str, int] = {}
    for o in ops:
        by[o.name] = by.get(o.name, 0) + (o.t1 - o.t0)
    return [[k, v / 1e9] for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1])[:n]]


def _containing(spans: Sequence[Tuple[int, int]], starts: List[int],
                t: int) -> Optional[Tuple[int, int]]:
    """The span of sorted, disjoint ``spans`` that holds ``t``, if any."""
    i = bisect.bisect_right(starts, t) - 1
    return spans[i] if i >= 0 and spans[i][1] >= t else None


def label_gaps(gaps: Sequence[Tuple[int, int]],
               spans: Dict[str, List[Tuple[int, int]]], n: int = 10
               ) -> List[List]:
    """[[host span, idle seconds], ...]: the idle time under each host
    span (the shortest span open at a gap's midpoint; "no span" where
    none is), largest first. ``spans``: name -> sorted disjoint spans."""
    index = {k: (v, [a for a, _ in v]) for k, v in spans.items()}
    by: Dict[str, int] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        best, best_len = "no span", None
        for name, (v, starts) in index.items():
            s = _containing(v, starts, mid)
            if s is not None and (best_len is None or s[1] - s[0] < best_len):
                best, best_len = name, s[1] - s[0]
        by[best] = by.get(best, 0) + (b - a)
    return [[k, v / 1e9] for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1])[:n]]


def overlap_bytes(ops: Sequence[Op], spans: Sequence[Tuple[int, int]],
                  kind: str = "HtoD") -> float:
    """Bytes of the copies whose name holds ``kind``, each counted in the
    share of its duration that lies inside the sorted, disjoint spans."""
    starts = [a for a, _ in spans]
    total = 0.0
    for o in ops:
        if o.cat != "gpu_memcpy" or kind not in o.name:
            continue
        dur = max(o.t1 - o.t0, 1)
        i = max(bisect.bisect_right(starts, o.t0) - 1, 0)
        inside = 0
        while i < len(spans) and spans[i][0] < o.t1:
            a, b = spans[i]
            inside += max(0, min(o.t1, b) - max(o.t0, a))
            i += 1
        total += o.nbytes * min(inside, dur) / dur
    return total
