"""Engine: mean length of a ``prefill_forward`` span (an admission's padded
prefill forward, up to its routing reaching the host: each layer's
resident experts read from their slots in HBM, only the others copied in
over PCIe from the pinned host tier). A card's reading, as the other
phase readers (``_phases.py``): None without a device trace."""
from perfbench.reading import mean_ms


def read(r):
    if r.device is None:
        return None
    return mean_ms(r.spans("engine", "prefill_forward"))
