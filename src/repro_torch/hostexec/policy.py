"""Cost-model CPU/fetch decision for cache-miss experts (the port's copy
of the reference's ``hostexec/policy.py``).

On a cache miss the engine can either fetch the expert's weights over the
host link and compute on the card, or ship the activations to the CPU and
compute the expert FFN there (paper Table III). :class:`HostDispatchPolicy`
answers per miss group (one unique expert, ``tokens`` rows this step) from
the paper's :class:`~repro_torch.core.costmodel.PaperModelTimings`:

  CPU   lane: act_transfer_ms + tokens * cpu_expert_ms(threads)
  fetch lane: fetch_expert_ms + tokens * gpu_expert_ms

Both are linear in the token count, so the decision collapses to a small
boolean table indexed by tokens per group (:meth:`decision_table`).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.core.costmodel import MIXTRAL_TIMINGS, PAPER_TIMINGS, \
    PaperModelTimings, cpu_expert_ms, fetch_expert_ms, gpu_expert_ms

__all__ = ["HostDispatchPolicy", "timings_for"]


def timings_for(name: str) -> PaperModelTimings:
    """The paper's timings for a model config name (reduced configs keep
    the arch name). Unknown archs fall back to the Mixtral timings with a
    ``UserWarning``: their host-dispatch decisions are uncalibrated."""
    for key, tm in PAPER_TIMINGS.items():
        if name == key or name.startswith(tm.name):
            return tm
    warnings.warn(
        f"no calibrated paper timings for arch {name!r}: falling back to "
        f"the Mixtral 8x7B timings ({MIXTRAL_TIMINGS.name}) — host-dispatch "
        f"cost decisions for this model are uncalibrated",
        UserWarning, stacklevel=2)
    return MIXTRAL_TIMINGS


@dataclass(frozen=True)
class HostDispatchPolicy:
    """Per-miss CPU-vs-fetch decision from the paper's cost model."""
    timings: PaperModelTimings
    threads: int

    def cpu_ms(self, tokens: int) -> float:
        """Host lane: activation round trip + multithreaded expert FFN."""
        return self.timings.act_transfer_ms \
            + tokens * cpu_expert_ms(self.timings, self.threads)

    def fetch_ms(self, tokens: int) -> float:
        """Device lane: weight fetch over the host link + GPU expert FFN."""
        return fetch_expert_ms(self.timings) \
            + tokens * gpu_expert_ms(self.timings)

    def prefers_cpu(self, tokens: int) -> bool:
        """True when the host lane beats fetch+compute for a miss group of
        ``tokens`` assignments (empty groups never dispatch)."""
        if tokens < 1:
            return False
        return self.cpu_ms(tokens) < self.fetch_ms(tokens)

    def decision_table(self, max_tokens: int) -> np.ndarray:
        """[max_tokens + 1] bool — ``table[c]``: run a c-token miss group
        on the CPU."""
        return np.asarray([self.prefers_cpu(c)
                           for c in range(max_tokens + 1)], bool)
