"""Whole decode step: the 95th percentile of the gaps between two tokens
of one request, pooled over the requests of the traced window."""
from perfbench.window import gaps, p95


def read(r):
    g = gaps(r.served, r.t0, r.t1)
    return 1e3 * p95(g) if g else None
