"""Tiers: the share of the prefill forwards' host-tier expert reads (the
reads not served from a resident expert's slot) that were queued on the
copy stream before their layer asked for its table
(``EngineStats.prefill_forward_ahead`` / (``prefill_forward_experts`` -
``prefill_forward_resident``)), over the window. A card's reading, as
``prefill_resident_share``: None without a device trace, and None where
the program has no such counters."""

COUNTERS = ("prefill_forward_ahead", "prefill_forward_resident",
            "prefill_forward_experts")


def read(r):
    if r.device is None or not all(hasattr(r.stats1, k) for k in COUNTERS):
        return None
    host = r.delta("prefill_forward_experts") - \
        r.delta("prefill_forward_resident")
    return 100.0 * r.delta("prefill_forward_ahead") / host if host > 0 \
        else None
