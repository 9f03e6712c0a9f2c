"""Faults planted under the timed path: each breaks what the program serves
in one way, and the correctness check has to call a run with it not
correct. The check's tests plant them at a CPU size
(``perfbench/tests/test_perfbench_run.py``); ``perfbench/limits.py
--fault <name>`` reads them on the card at a cell's own size.

Each fault is ``fault(patch)``, where ``patch(owner, name, value)`` sets
an attribute (pytest's ``monkeypatch.setattr``, or ``planted``'s own,
which puts everything back on leaving).
"""
from __future__ import annotations

import copy
from contextlib import contextmanager

import numpy as np
import torch


def _engine():
    from repro_torch.serving.engine import CollaborativeEngine
    return CollaborativeEngine


def altered_token(patch) -> None:
    """Every token altered where it is produced (the engine's sampler)."""
    E = _engine()
    orig = E.select_tokens

    def select(self, logits, *a, **k):
        return (orig(self, logits, *a, **k) + 1) % logits.shape[-1]
    patch(E, "select_tokens", select)


def one_slot(patch) -> None:
    """The tokens of one slot of the decode batch altered where they are
    produced (with one slot: every token)."""
    E = _engine()
    orig = E.select_tokens

    def select(self, logits, *a, **k):
        out = orig(self, logits, *a, **k)
        if logits.shape[0] > 1 or self.ecfg.max_batch == 1:
            out = out.clone()
            out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    patch(E, "select_tokens", select)


def unchanged_state(patch) -> None:
    """A decode step that returns its state unchanged: it runs on a copy,
    so its KV write and position never reach the batch."""
    E = _engine()
    orig = E.decode_batch

    def step(self, tokens, state, active):
        logits, _ = orig(self, tokens, copy.deepcopy(state), active)
        return logits, state
    patch(E, "decode_batch", step)


def half_batch(patch) -> None:
    """Half of the batch left out of a decode step, its rows given the
    mean of the rest."""
    E = _engine()
    orig = E.decode_batch

    def step(self, tokens, state, active):
        act = np.asarray(active, bool).copy()
        rows = np.nonzero(act)[0]
        left = rows[len(rows) // 2:] if len(rows) > 1 else rows[:0]
        act[left] = False
        logits, state = orig(self, tokens, state, act)
        if left.size:
            kept = torch.as_tensor(rows[:len(rows) // 2])
            logits[torch.as_tensor(left)] = logits[kept].float().mean(
                0, keepdim=True).to(logits.dtype)
            state["pos"][torch.as_tensor(left)] += 1
        return logits, state
    patch(E, "decode_batch", step)


FAULTS = {f.__name__: f for f in (altered_token, one_slot, unchanged_state,
                                  half_batch)}


@contextmanager
def planted(name: str):
    """The fault ``name`` in place while inside."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, value)
    FAULTS[name](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
