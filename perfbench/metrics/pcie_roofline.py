"""Tiers: the least time the window's decode steps could take on the host
link (the host->device bytes the profiler recorded inside them, over PCIe
5.0 x16's 64 GB/s) as a share of their wall time."""
from perfbench import devtrace
from perfbench.roofline import PCIE_H2D_BYTES_PER_S


def read(r):
    steps = r.decode_steps()
    if r.device is None or not steps:
        return None
    nbytes = devtrace.overlap_bytes(r.device.ops, steps, "HtoD")
    if nbytes <= 0:
        return None
    wall = sum(b - a for a, b in steps) / 1e9
    return 100.0 * (nbytes / PCIE_H2D_BYTES_PER_S) / wall
