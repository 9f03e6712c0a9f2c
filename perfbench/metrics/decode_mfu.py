"""Whole decode step: the model FLOPs of the window's decoded tokens (the
configuration's reference module's ``decode_flops``: for attention + MoE,
2 a active parameter plus attention over the keys each saw) over the
decode steps' wall time at the card's bf16 peak."""
from perfbench import manifest, roofline
from perfbench.window import decode_positions


def read(r):
    steps = r.decode_steps()
    keys = decode_positions(r.served, r.t0, r.t1)
    if not steps or not keys:
        return None
    wall = sum(b - a for a, b in steps) / 1e9
    reference = manifest.module("reference", r.cfg["reference"], r.root)
    return 100.0 * reference.decode_flops(r.cfg, keys) / (
        wall * roofline.BF16_FLOPS)
