"""Low-overhead span/event recorder for the serving hot path (the port's
own copy of the reference's ``obs/trace.py``).

Design constraints, in order:

1. **Never perturb the thing being measured.** Timestamps come from
   ``time.perf_counter_ns`` (monotonic, ns resolution); recording an
   event is one tuple construction and one ring-buffer store — no
   allocation growth, no locks, no I/O. When tracing is off the engine
   and scheduler hold ``NULL_RECORDER`` whose methods are empty, so the
   instrumented code path is identical either way (the bit-identity
   tests pin this).
2. **Bounded memory.** Events land in a preallocated ring buffer;
   once full, the oldest events are overwritten (``dropped`` counts
   them). A trace of a million-token run costs the same memory as a
   ten-token run.
3. **Retroactive spans.** Hot code records ``t0 = now_ns()`` as a plain
   local (reading the clock is not emission) and emits the whole span
   later at a drain point via ``complete(track, name, t0, t1)``. This
   avoids begin/end pairing state in the hot loop: every emission call
   sits in an ``_obs_*`` helper of the engine or the scheduler, called
   after the step's stats and tokens reached the host.

Tracks are plain strings — ``req:3``, ``slot:0``, ``lane:cpu``,
``sched`` — and become Perfetto threads in the Chrome export.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional


def now_ns() -> int:
    """Monotonic nanosecond clock all trace timestamps come from."""
    return time.perf_counter_ns()


class TraceEvent(NamedTuple):
    """One recorded happening. ``kind`` is a Chrome trace-event phase:
    ``"X"`` complete span (``dur_ns`` set), ``"i"`` instant, ``"C"``
    counter sample (scalar in ``args["value"]``)."""
    kind: str
    track: str
    name: str
    ts_ns: int
    dur_ns: int
    args: Optional[Dict[str, Any]]


class TraceRecorder:
    """Preallocated ring buffer of :class:`TraceEvent`.

    The emission methods (``complete`` / ``instant`` / ``counter`` /
    ``span``) are called only from the ``_obs_*`` drain helpers on the
    serving path."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._ring: List[Optional[TraceEvent]] = [None] * self.capacity
        self._head = 0          # next write index
        self._count = 0         # events currently held (<= capacity)
        self.dropped = 0        # events overwritten after wraparound
        self.t0_ns = now_ns()   # trace epoch: export rebases onto this

    @property
    def enabled(self) -> bool:
        return True

    def __len__(self) -> int:
        return self._count

    def _push(self, ev: TraceEvent) -> None:
        if self._count == self.capacity:
            self.dropped += 1
        else:
            self._count += 1
        self._ring[self._head] = ev
        self._head = (self._head + 1) % self.capacity

    # -- emission API (drain points only) ---------------------------------

    def complete(self, track: str, name: str, t0_ns: int, t1_ns: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a span retroactively from two clock readings."""
        self._push(TraceEvent("X", track, name, t0_ns,
                              max(0, t1_ns - t0_ns), args))

    def instant(self, track: str, name: str,
                args: Optional[Dict[str, Any]] = None,
                ts_ns: Optional[int] = None) -> None:
        """Record a point-in-time happening (eviction, prefix hit, ...)."""
        self._push(TraceEvent("i", track, name,
                              now_ns() if ts_ns is None else ts_ns,
                              0, args))

    def counter(self, track: str, name: str, value: float,
                ts_ns: Optional[int] = None) -> None:
        """Sample a gauge (pages in use, queue depth, ...)."""
        self._push(TraceEvent("C", track, name,
                              now_ns() if ts_ns is None else ts_ns,
                              0, {"value": value}))

    def span(self, track: str, name: str,
             args: Optional[Dict[str, Any]] = None) -> "_Span":
        """Context manager emitting one complete span on exit. For
        host-side scopes outside the hot loop (e.g. ``serve.py`` run
        phases); hot code uses ``complete`` at the drain instead."""
        return _Span(self, track, name, args)

    # -- reading ---------------------------------------------------------

    def events(self) -> List[TraceEvent]:
        """Events in emission order (oldest surviving first)."""
        if self._count < self.capacity:
            out = self._ring[: self._count]
        else:
            out = self._ring[self._head:] + self._ring[: self._head]
        return [ev for ev in out if ev is not None]

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events())


class _Span:
    __slots__ = ("_rec", "_track", "_name", "_args", "_t0")

    def __init__(self, rec: TraceRecorder, track: str, name: str,
                 args: Optional[Dict[str, Any]]):
        self._rec = rec
        self._track = track
        self._name = name
        self._args = args
        self._t0 = 0

    def __enter__(self) -> "_Span":
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.complete(self._track, self._name, self._t0, now_ns(),
                           self._args)


class NoopRecorder:
    """Drop-in stand-in when tracing is off: every emission is a no-op,
    so instrumented code never branches on whether tracing is enabled.
    Clock reads still work (``now_ns`` is module-level)."""

    capacity = 0
    dropped = 0
    t0_ns = 0

    @property
    def enabled(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def complete(self, track, name, t0_ns, t1_ns, args=None) -> None:
        pass

    def instant(self, track, name, args=None, ts_ns=None) -> None:
        pass

    def counter(self, track, name, value, ts_ns=None) -> None:
        pass

    def span(self, track, name, args=None) -> "_NoopSpan":
        return _NOOP_SPAN

    def events(self) -> List[TraceEvent]:
        return []

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(())


class _NoopSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SPAN = _NoopSpan()
NULL_RECORDER = NoopRecorder()
