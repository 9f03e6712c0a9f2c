"""Tracing and metrics for the collaborative serving stack (the port's
counterpart of the reference's ``obs`` package).

* ``trace``   — ``TraceRecorder``: a preallocated ring buffer of spans,
  instants and counter samples on the monotonic clock, plus the
  ``NULL_RECORDER`` no-op twin used when tracing is off.
* ``metrics`` — ``LogHistogram``: streaming log-bucket histograms that
  yield p50/p95/p99 for TTFT, TPOT and admission stall without storing
  raw samples.
* ``export``  — Chrome trace-event JSON (loadable in Perfetto /
  ``chrome://tracing``) with one track per request, per slot and per
  dispatch lane, and a structural validator
  (``python -m repro_torch.obs.export PATH``).

Drain-point rule: emission calls — ``complete`` / ``instant`` /
``counter`` / ``span`` — happen only inside the engine's and the
scheduler's ``_obs_*`` helpers, called after the step's stats and
tokens reached the host. Device work is timed by bracketing the calls
that queue it at the drain, never by a sync added for the trace.
"""
from .metrics import LogHistogram
from .trace import (NULL_RECORDER, NoopRecorder, TraceEvent, TraceRecorder,
                    now_ns)
from .export import (chrome_trace, validate_chrome_trace,
                     write_chrome_trace)

__all__ = [
    "LogHistogram",
    "NULL_RECORDER",
    "NoopRecorder",
    "TraceEvent",
    "TraceRecorder",
    "now_ns",
    "chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
]
