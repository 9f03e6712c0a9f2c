"""Tiers: expert-weight bytes copied device to device a decoded token
(``EngineStats.stage_d2d_bytes``, resident experts staged from the slot
buffer, plus ``slot_d2d_bytes``, slot writes from the staging buffer),
over the window."""
from perfbench.metrics._phases import bytes_per_token_mb


def read(r):
    return bytes_per_token_mb(r, ("stage_d2d_bytes", "slot_d2d_bytes"))
