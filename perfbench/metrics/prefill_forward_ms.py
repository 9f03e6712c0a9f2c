"""Engine: mean length of a ``prefill_forward`` span (an admission's padded
prefill forward, every layer's expert table copied in, up to its routing
reaching the host). A card's reading, as the other phase readers
(``_phases.py``): None without a device trace."""
from perfbench.reading import mean_ms


def read(r):
    if r.device is None:
        return None
    return mean_ms(r.spans("engine", "prefill_forward"))
