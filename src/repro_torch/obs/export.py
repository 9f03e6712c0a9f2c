"""Chrome trace-event JSON export and structural validation (the port's
own copy of the reference's ``obs/export.py``).

``chrome_trace`` converts a :class:`~repro_torch.obs.trace.TraceRecorder`'s
ring into the Chrome trace-event format (the JSON-array-of-events
dialect wrapped in ``{"traceEvents": [...]}``) loadable in Perfetto or
``chrome://tracing``. Every track string becomes its own named thread
under one process, so requests (``req:N``), slots (``slot:N``) and
dispatch lanes (``lane:*``) render as parallel swimlanes; timestamps
are rebased to the recorder's epoch and expressed in microseconds as
the format requires.

``validate_chrome_trace`` is the structural checker
(``python -m repro_torch.obs.export PATH [--require-lifecycle]``):
phase/field invariants per event, monotone non-negative durations, and
thread-name metadata covering every referenced track.
``lifecycle_coverage`` additionally maps each request track to the
lifecycle span names present, which proves every request's
queued/prefill/decode phases made it into the trace.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Set

from .trace import TraceEvent

PID = 1
# the span names a complete request lifecycle must produce (cancelled
# requests legitimately miss later phases)
LIFECYCLE_SPANS = ("queued", "prefill", "decode")


def _tid_map(events: Iterable[TraceEvent]) -> Dict[str, int]:
    """Stable track → tid assignment: scheduler first, then lanes,
    slots and requests in sorted order so Perfetto's track list reads
    top-down the way the stack does."""
    tracks: Set[str] = {ev.track for ev in events}

    def rank(track: str):
        for i, prefix in enumerate(("sched", "engine", "lane:", "slot:",
                                    "req:")):
            if track.startswith(prefix):
                # numeric suffixes sort numerically (req:2 before req:10)
                tail = track.split(":", 1)[-1]
                num = int(tail) if tail.isdigit() else -1
                return (i, num, track)
        return (99, -1, track)

    return {t: tid for tid, t in enumerate(sorted(tracks, key=rank), 1)}


def chrome_trace(recorder) -> Dict[str, Any]:
    """Render a recorder (or anything with ``events()`` and ``t0_ns``)
    as a Chrome trace-event JSON object."""
    events = recorder.events()
    tids = _tid_map(events)
    out: List[Dict[str, Any]] = []
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "name": "thread_name", "pid": PID,
                    "tid": tid, "args": {"name": track}})
    epoch = recorder.t0_ns
    for ev in events:
        ts_us = (ev.ts_ns - epoch) / 1000.0
        rec: Dict[str, Any] = {"ph": ev.kind, "name": ev.name,
                               "pid": PID, "tid": tids[ev.track],
                               "ts": ts_us}
        if ev.kind == "X":
            rec["dur"] = ev.dur_ns / 1000.0
        if ev.kind == "i":
            rec["s"] = "t"  # thread-scoped instant
        if ev.args is not None:
            rec["args"] = dict(ev.args)
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": recorder.dropped}}


def write_chrome_trace(recorder, path: str) -> Dict[str, Any]:
    data = chrome_trace(recorder)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return data


def validate_chrome_trace(data: Dict[str, Any]) -> List[str]:
    """Return a list of structural problems (empty == valid)."""
    problems: List[str] = []
    if not isinstance(data, dict) or "traceEvents" not in data:
        return ["top level must be an object with a traceEvents list"]
    events = data["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be a list"]

    named_tids: Set[int] = set()
    used_tids: Set[int] = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("M", "X", "i", "C"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        if ev.get("pid") != PID or not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: bad pid/tid")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                named_tids.add(ev["tid"])
            continue
        used_tids.add(ev["tid"])
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: complete span without "
                                f"non-negative dur")
        if ph == "C" and "value" not in ev.get("args", {}):
            problems.append(f"event {i}: counter without args.value")
    for tid in sorted(used_tids - named_tids):
        problems.append(f"tid {tid} has events but no thread_name "
                        f"metadata")
    return problems


def lifecycle_coverage(data: Dict[str, Any]) -> Dict[str, Set[str]]:
    """Map each request track name to the lifecycle span names it
    recorded. Requires valid thread-name metadata."""
    names_by_tid = {ev["tid"]: ev["args"]["name"]
                    for ev in data.get("traceEvents", [])
                    if ev.get("ph") == "M"
                    and ev.get("name") == "thread_name"}
    cover: Dict[str, Set[str]] = {}
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        track = names_by_tid.get(ev.get("tid"), "")
        if track.startswith("req:"):
            cover.setdefault(track, set()).add(ev["name"])
    return cover


def main(argv=None) -> int:
    """Command line: ``python -m repro_torch.obs.export TRACE.json``."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON artifact")
    ap.add_argument("path")
    ap.add_argument("--require-lifecycle", action="store_true",
                    help="additionally require every req:* track to "
                         "carry the full queued/prefill/decode span set")
    args = ap.parse_args(argv)

    with open(args.path) as f:
        data = json.load(f)
    problems = validate_chrome_trace(data)
    cover = lifecycle_coverage(data)
    if args.require_lifecycle:
        if not cover:
            problems.append("no req:* tracks in trace")
        for track, spans in sorted(cover.items()):
            missing = [s for s in LIFECYCLE_SPANS if s not in spans]
            if missing:
                problems.append(f"{track}: missing lifecycle span(s) "
                                f"{', '.join(missing)}")
    for p in problems:
        print(f"trace-validate: {p}", file=sys.stderr)
    n_events = len([e for e in data.get("traceEvents", [])
                    if isinstance(e, dict) and e.get("ph") != "M"])
    print(f"trace-validate: {args.path}: {n_events} event(s), "
          f"{len(cover)} request track(s)"
          + (": FAIL" if problems else ": OK"))
    return 1 if problems else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
