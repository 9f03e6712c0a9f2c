"""Fault tolerance: heartbeats, straggler detection, supervised train loop
(the port's copy of the reference's ``runtime/fault_tolerance.py``, plain
Python and numpy).

At 1000+ nodes the failure model is: some worker stops heartbeating
(hardware fault / preemption), or heartbeats but runs slow (straggler —
thermal throttling, a bad HBM stack, a flaky ICI link). The supervisor
composes three mechanisms, all unit-testable without real failures:

  FailureDetector   — per-worker phi-style timeout detector over a
                      heartbeat table (monotonic timestamps).
  StragglerMonitor  — per-step duration EWMA + robust z-score; flags
                      workers whose step times exceed median + k·MAD. The
                      mitigation at scale is checkpoint-and-exclude
                      (shrink the data axis); locally we record decisions.
  TrainSupervisor   — drives step(); on a detected failure restores the
                      latest checkpoint and replans the mesh via
                      runtime.elastic (the data pipeline is a pure
                      function of `step`, so replay is exact).

A gang-scheduled SPMD step dies with any lost worker; recovery is
restart-from-checkpoint with a (possibly smaller) mesh — exactly what plan_reshard + CheckpointManager implement. There is
deliberately no attempt at per-worker hot-swap inside a step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class FailureDetector:
    timeout_s: float = 30.0
    _last_beat: Dict[int, float] = field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None):
        self._last_beat[worker] = time.monotonic() if now is None else now

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(w for w, t in self._last_beat.items()
                      if now - t > self.timeout_s)

    def alive_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(w for w, t in self._last_beat.items()
                      if now - t <= self.timeout_s)


@dataclass
class StragglerMonitor:
    """Flags workers whose step durations are median + k*MAD outliers."""
    k: float = 5.0
    window: int = 20
    _hist: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, worker: int, step_s: float):
        h = self._hist.setdefault(worker, [])
        h.append(step_s)
        if len(h) > self.window:
            h.pop(0)

    def stragglers(self) -> List[int]:
        if len(self._hist) < 2:
            return []
        means = {w: float(np.mean(h)) for w, h in self._hist.items() if h}
        vals = np.array(list(means.values()))
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med))) + 1e-9
        return sorted(w for w, m in means.items() if m > med + self.k * mad)


class TrainSupervisor:
    """Restart-from-checkpoint supervision around a step callable.

    step_fn(state, step_idx) -> state; save_fn(step, state);
    restore_fn() -> (state, step). `inject_failure` hooks let tests drive
    failure scenarios deterministically.
    """

    def __init__(self, step_fn: Callable, save_fn: Callable,
                 restore_fn: Callable, ckpt_every: int = 100,
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.restarts = 0
        self.detector = FailureDetector()
        self.straggler = StragglerMonitor()

    def run(self, state, start_step: int, num_steps: int,
            failure_at: Optional[int] = None):
        """Runs steps [start_step, start_step+num_steps); `failure_at`
        raises a simulated fault at that step (tests)."""
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.monotonic()
                if failure_at is not None and step == failure_at:
                    failure_at = None      # fail exactly once
                    raise RuntimeError("injected worker failure")
                state = self.step_fn(state, step)
                self.straggler.record(0, time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self.restore_fn()
        return state, step
