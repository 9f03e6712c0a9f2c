"""Elastic scaling: replan the mesh when workers are lost / added (the
port's copy of the reference's ``runtime/elastic.py``).

Policy: keep the "model" axis fixed (TP/EP degree is an architectural
choice — expert divisibility, layout), shrink/grow the "data" axis to the
largest size the surviving chip count supports, and require the global
batch to stay divisible (the data pipeline reshards by pure function of
step, so no data is lost or duplicated).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pods: int
    dropped_chips: int

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_reshard(alive_chips: int, model: int = 16, pods: int = 1,
                 global_batch: int = 256,
                 min_data: int = 1) -> Optional[ElasticPlan]:
    """Largest (pods, data, model) mesh that fits the surviving chips."""
    per_pod = alive_chips // pods
    data = per_pod // model
    while data >= min_data:
        if data * model * pods <= alive_chips and global_batch % (data * pods) == 0:
            return ElasticPlan(data=data, model=model, pods=pods,
                               dropped_chips=alive_chips - data * model * pods)
        data -= 1
    return None
