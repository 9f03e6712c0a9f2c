"""Scheduler: tokens that reached their clients inside the traced window
over its seconds (the rate a user sees; read per layer, since on a shared
host its runs spread too widely for an end-to-end bound)."""
from perfbench.window import tokens_in


def read(r):
    n = tokens_in(r.served, r.t0, r.t1)
    return n / (r.t1 - r.t0) if n else None
