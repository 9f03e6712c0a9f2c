"""Cache manager: the ``probe`` spans a decode step (each layer's cache
access, landing, grouping and lookup on the host), mean over the
window's steps."""
from perfbench.metrics._phases import step_ms


def read(r):
    return step_ms(r, "probe")
