"""Engine: the share of the prefill forwards' expert-table reads served
from a resident expert's slot in HBM rather than over PCIe from the
pinned host tier (``EngineStats.prefill_forward_resident`` /
``prefill_forward_experts``), over the window. A card's reading, as the
engine's other copy readers (``_phases.py``): None without a device
trace, and None where the program has no such counters."""

COUNTERS = ("prefill_forward_resident", "prefill_forward_experts")


def read(r):
    if r.device is None or not all(hasattr(r.stats1, k) for k in COUNTERS):
        return None
    reads = r.delta("prefill_forward_experts")
    return 100.0 * r.delta("prefill_forward_resident") / reads if reads > 0 \
        else None
