"""Whole decode step: the mean gap between two tokens of one request, over
every gap of the traced window (the time per output token a user sees)."""
from perfbench.window import gaps


def read(r):
    g = gaps(r.served, r.t0, r.t1)
    return 1e3 * sum(g) / len(g) if g else None
