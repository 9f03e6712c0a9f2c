"""Tiers: expert-weight bytes copied host to device a decoded token
(``EngineStats.stage_h2d_bytes``, missed experts staged from the pinned
host tier, plus ``slot_h2d_bytes``, slot writes from it), over the
window."""
from perfbench.metrics._phases import bytes_per_token_mb


def read(r):
    return bytes_per_token_mb(r, ("stage_h2d_bytes", "slot_h2d_bytes"))
