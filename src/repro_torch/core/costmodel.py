"""The paper's measured per-expert timings, as far as the host lane's
dispatch policy reads them (the port's own copy of part of the
reference's ``core/costmodel.py``).

These numbers are the paper's testbed (AMD 7960X + RTX 4090 over PCIe
4.0 x16), not the H100's: the port keeps them so that its CPU/fetch split
of cache-miss groups equals the reference's decision for decision. Table
III's "expert comp/comm time" rows are per MoE layer *pair* (top-2
experts); per-expert values are half. ``act_transfer_ms`` is the
activation round trip (attention output to the host and back).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class PaperModelTimings:
    name: str
    num_layers: int
    num_experts: int
    top_k: int
    expert_mb: float                   # per-expert weight size
    gpu_pair_ms: float                 # top-2 expert FFN on GPU (cached)
    comm_pair_ms: float                # PCIe fetch of the top-2 pair
    cpu_pair_ms: Dict[int, float]      # threads -> top-2 expert FFN on CPU
    act_transfer_ms: float = 0.11      # attention output D2H + result H2D
    other_layer_ms: float = 0.70       # attention/router/norm etc. per layer
    # Table IV power (W) per OMP_NUM_THREADS
    cpu_power_w: Dict[int, float] = None
    gpu_power_w: Dict[int, float] = None


MIXTRAL_TIMINGS = PaperModelTimings(
    name="mixtral-8x7b", num_layers=32, num_experts=8, top_k=2,
    expert_mb=340.0,
    gpu_pair_ms=0.25, comm_pair_ms=28.02,
    cpu_pair_ms={1: 44.12, 2: 25.53, 4: 18.34, 8: 15.76, 16: 10.96, 24: 7.34},
    cpu_power_w={1: 86.1, 2: 91.7, 4: 100.3, 8: 111.0, 16: 133.4, 24: 147.5},
    gpu_power_w={1: 91.6, 2: 92.8, 4: 101.0, 8: 103.4, 16: 99.6, 24: 97.9},
)

PHI35_TIMINGS = PaperModelTimings(
    name="phi35-moe", num_layers=32, num_experts=16, top_k=2,
    expert_mb=152.0,
    gpu_pair_ms=0.11, comm_pair_ms=12.26,
    cpu_pair_ms={1: 22.73, 2: 12.80, 4: 8.58, 8: 6.39, 16: 3.92, 24: 3.36},
    cpu_power_w={1: 84.4, 2: 88.4, 4: 92.0, 8: 98.4, 16: 110.1, 24: 118.3},
    gpu_power_w={1: 97.4, 2: 100.7, 4: 105.9, 8: 109.2, 16: 106.0, 24: 109.2},
    other_layer_ms=0.70,
)

PAPER_TIMINGS = {"mixtral-8x7b": MIXTRAL_TIMINGS, "phi35-moe": PHI35_TIMINGS}


def cpu_pair_ms(t: PaperModelTimings, threads: int) -> float:
    """Interpolate the measured thread scaling (1/T-ish between samples)."""
    pts = sorted(t.cpu_pair_ms)
    if threads in t.cpu_pair_ms:
        return t.cpu_pair_ms[threads]
    if threads <= pts[0]:
        return t.cpu_pair_ms[pts[0]] * pts[0] / threads
    if threads >= pts[-1]:
        return t.cpu_pair_ms[pts[-1]] * pts[-1] / threads
    i = bisect.bisect_left(pts, threads)
    lo, hi = pts[i - 1], pts[i]
    # interpolate in 1/threads space (parallel-efficiency preserving)
    w = (1 / threads - 1 / lo) / (1 / hi - 1 / lo)
    return t.cpu_pair_ms[lo] * (1 - w) + t.cpu_pair_ms[hi] * w


def gpu_expert_ms(t: PaperModelTimings) -> float:
    return t.gpu_pair_ms / t.top_k


def fetch_expert_ms(t: PaperModelTimings) -> float:
    return t.comm_pair_ms / t.top_k


def cpu_expert_ms(t: PaperModelTimings, threads: int) -> float:
    return cpu_pair_ms(t, threads) / t.top_k
