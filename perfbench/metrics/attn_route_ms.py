"""Engine: the ``attn_route`` spans a decode step (each layer's norms,
attention, residual, router and top-k), mean over the window's steps."""
from perfbench.metrics._phases import step_ms


def read(r):
    return step_ms(r, "attn_route")
