"""Tiers: the ``execute`` spans a decode step (each layer's dispatch
buffer, weight staging, grouped kernels' launches and combine), mean over
the window's steps."""
from perfbench.metrics._phases import step_ms


def read(r):
    return step_ms(r, "execute")
