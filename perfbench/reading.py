"""What a traced run hands each per-layer metric's reader
(``perfbench/metrics/<name>.py``: ``read(reading) -> float | None``; None
where the run holds nothing for it to read, and the metric is left out).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from perfbench.devtrace import DeviceTrace
from perfbench.manifest import ROOT
from perfbench.window import Served


@dataclass
class Reading:
    cfg: Dict                    # the configuration file (and its name)
    t0: float                    # the window, perf_counter seconds
    t1: float
    served: List[Served]         # every request as its client saw it
    events: List[Any]            # the program's trace events (its spans)
    stats0: Any                  # the engine's counters at the window's
    stats1: Any                  # start and at its end
    device: Optional[DeviceTrace]   # the profiler's device operations
    # the declared entry points' calls (``harness.KernelShapes``), in call
    # order: (function, *shape, host perf_counter ns of the call)
    kernel_calls: List[Tuple]
    root: Path = ROOT            # the checkout the cell's modules are in

    @property
    def t0_ns(self) -> int:
        return int(self.t0 * 1e9)

    @property
    def t1_ns(self) -> int:
        return int(self.t1 * 1e9)

    def spans(self, track: str, name: str) -> List[Tuple[int, int]]:
        """Sorted (start, end) ns of the program's spans ``name`` on
        ``track`` (a track ending in ":" matches every track it starts)
        that start inside the window."""
        out = []
        for ev in self.events:
            if ev.kind != "X" or ev.name != name:
                continue
            if not (ev.track.startswith(track) if track.endswith(":")
                    else ev.track == track):
                continue
            if self.t0_ns <= ev.ts_ns <= self.t1_ns:
                out.append((ev.ts_ns, ev.ts_ns + ev.dur_ns))
        return sorted(out)

    def calls(self, *names: str) -> List[Tuple]:
        """The recorded calls of the entry points ``names`` made inside
        the window, in call order."""
        return [c for c in self.kernel_calls
                if c[0] in names and self.t0_ns <= c[-1] <= self.t1_ns]

    def decode_steps(self) -> List[Tuple[int, int]]:
        """The scheduler's decode steps: the engine's step and the tokens
        reaching the host (``decode+drain``)."""
        return self.spans("sched", "decode+drain")

    def delta(self, counter: str) -> int:
        return int(getattr(self.stats1, counter)) - \
            int(getattr(self.stats0, counter))


def mean_ms(spans: List[Tuple[int, int]]) -> Optional[float]:
    return (sum(b - a for a, b in spans) / len(spans) / 1e6) if spans \
        else None
