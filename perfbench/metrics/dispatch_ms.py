"""Engine: mean length of a decode step's ``dispatch`` span (the layer
loop, with its per-layer syncs)."""
from perfbench.reading import mean_ms


def read(r):
    return mean_ms(r.spans("engine", "dispatch"))
