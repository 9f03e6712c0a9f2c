"""Per-request sampling: typed parameters and a vectorized per-slot sampler
(counterpart of the reference's ``serving/sampling.py``).

Reproducibility is per request, as in the reference: each request owns a
base seed (``SamplingParams.seed``, or one drawn from the scheduler's
generator at admission), and its i-th generated token draws from a CPU
``torch.Generator`` seeded by :func:`step_seed` ``(base, i)`` —
independent of slot placement, batch composition or admission order. The
draws cannot reproduce the reference's ``jax.random`` bits; greedy
decoding is where the two agree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["SamplingParams", "GREEDY", "batch_arrays", "sample_tokens",
           "step_seed"]


@dataclass(frozen=True)
class SamplingParams:
    """How one request turns logits into tokens.

    greedy       — argmax decoding; all other knobs are ignored.
    temperature  — softmax temperature (>0) when sampling.
    top_k        — keep only the k highest-probability tokens (0 = off).
    top_p        — nucleus sampling mass (1.0 = off).
    seed         — per-request seed; None derives one from the scheduler's
                   generator at admission.
    """
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


GREEDY = SamplingParams()


def batch_arrays(params: Sequence[SamplingParams]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """[T] SamplingParams -> (greedy [T]b, temperature [T]f32,
    top_k [T]i32, top_p [T]f32)."""
    return (np.array([p.greedy for p in params], bool),
            np.array([p.temperature for p in params], np.float32),
            np.array([p.top_k for p in params], np.int32),
            np.array([p.top_p for p in params], np.float32))


def step_seed(base: int, index: int) -> int:
    """Seed of a request's ``index``-th draw from its base seed."""
    state = np.random.SeedSequence([int(base) & (2 ** 64 - 1),
                                    int(index)]).generate_state(1, np.uint64)
    return int(state[0] & np.uint64(2 ** 63 - 1))


def sample_tokens(logits: torch.Tensor, greedy, temperature, top_k, top_p,
                  seeds: Sequence[int]) -> torch.Tensor:
    """Vectorized per-slot next-token selection.

    logits [T, V]; greedy/temperature/top_k/top_p [T] (the params batch);
    seeds [T] per-row step seeds (ignored for greedy rows). Greedy rows take
    the argmax of the raw logits; sampling rows apply temperature, the
    row's top-k cut, then its nucleus cut, and draw with their own
    generator. Returns [T] int32 on the CPU."""
    lg = logits.float()
    dev = lg.device
    V = lg.shape[-1]
    greedy = torch.as_tensor(np.asarray(greedy), device=dev)
    temp = torch.as_tensor(np.asarray(temperature), device=dev)
    top_k = torch.as_tensor(np.asarray(top_k), device=dev).long()
    top_p = torch.as_tensor(np.asarray(top_p), device=dev)
    arg = lg.argmax(-1)

    scaled = lg / torch.clamp(temp, min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    keff = torch.where((top_k <= 0) | (top_k > V), torch.full_like(top_k, V),
                       top_k)
    kth = torch.gather(srt, 1, (keff - 1)[:, None])
    masked = torch.where(scaled < kth, float("-inf"), scaled)
    srt_m = torch.sort(masked, dim=-1, descending=True).values
    ps = torch.softmax(srt_m, dim=-1)
    keep = (torch.cumsum(ps, dim=-1) - ps) < top_p[:, None]
    pth = torch.where(keep, srt_m, float("inf")).amin(dim=-1, keepdim=True)
    masked = torch.where(masked < pth, float("-inf"), masked)

    probs = torch.softmax(masked, dim=-1).cpu()
    out = arg.cpu().to(torch.int32)
    for t in range(out.shape[0]):
        if not bool(greedy[t]):
            g = torch.Generator().manual_seed(int(seeds[t]))
            out[t] = int(torch.multinomial(probs[t], 1, generator=g))
    return out
