"""Engine: mean length of a ``warm_replay`` span (one a prefill advance:
the prompt's routing replayed in chunks through probe and commit, whose
post-fetch copies experts into the cached layers' slots). The scheduler
runs it after the request's first token is sampled, so it lands in the
first inter-token gap."""
from perfbench.reading import mean_ms


def read(r):
    return mean_ms(r.spans("engine", "warm_replay"))
