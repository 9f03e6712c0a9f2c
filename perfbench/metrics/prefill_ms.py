"""Scheduler: mean time from a request's admission to its first token (the
scheduler's per-request ``prefill`` span: the padded prefill forward, the
first token and the warming replay), over the requests that retired in the
window."""
from perfbench.reading import mean_ms


def read(r):
    return mean_ms(r.spans("req:", "prefill"))
