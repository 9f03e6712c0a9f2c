"""Cache replacement policies: the shared PolicySpec and slot flags (the
port's own copy of the reference's ``core/policies.py`` constants)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class PolicySpec:
    """What one eviction policy does (paper §IV-D).

    inserts_on_miss — False for the static-random baseline: its expert set
                      is pinned at init and never replaced.
    refresh_on_hit  — LRU touch-refresh; FIFO stamps on insert only.
    needs_key       — static placement draws its pinned experts at init.
    """
    name: str
    inserts_on_miss: bool
    refresh_on_hit: bool
    needs_key: bool

    @property
    def is_static(self) -> bool:
        return not self.inserts_on_miss


POLICY_SPECS: Dict[str, PolicySpec] = {
    "lru": PolicySpec("lru", inserts_on_miss=True, refresh_on_hit=True,
                      needs_key=False),
    "fifo": PolicySpec("fifo", inserts_on_miss=True, refresh_on_hit=False,
                       needs_key=False),
    "random": PolicySpec("random", inserts_on_miss=False,
                         refresh_on_hit=False, needs_key=True),
}


def policy_spec(name: str) -> PolicySpec:
    try:
        return POLICY_SPECS[name]
    except KeyError:
        raise ValueError(f"unknown cache policy {name!r}; "
                         f"have {sorted(POLICY_SPECS)}") from None


# Slot provenance/transfer flags.
FLAG_DEMAND = 0      # demand-resident (or empty slot)
FLAG_SPEC = 1        # speculative insert, transfer landed
FLAG_PENDING = 2     # speculative insert, transfer in flight
