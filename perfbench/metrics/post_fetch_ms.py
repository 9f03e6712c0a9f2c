"""Tiers: the ``post_fetch`` spans a decode step (each layer's commit, its
slot writes queued on the copy stream, and its stats), mean over the
window's steps."""
from perfbench.metrics._phases import step_ms


def read(r):
    return step_ms(r, "post_fetch")
