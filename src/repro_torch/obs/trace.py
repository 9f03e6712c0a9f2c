"""The clock and the no-op trace recorder.

Tracing itself is not ported yet: the engine and scheduler hold
``NULL_RECORDER``, whose methods do nothing, at the same call sites where
the reference emits spans, so a later recorder plugs in unchanged.
"""
from __future__ import annotations

import time


def now_ns() -> int:
    """Monotonic nanosecond clock all timestamps come from."""
    return time.perf_counter_ns()


class NoopRecorder:
    """Accepts every emission and records nothing."""

    def complete(self, *args, **kwargs) -> None:
        pass


NULL_RECORDER = NoopRecorder()
