"""Cache replacement policies: the shared PolicySpec, the slot flags and
the numpy twin of the cache (the port's own copy of the reference's
``core/policies.py``).

``PolicySpec`` and the flags are what the host-side cache
(:mod:`repro_torch.core.cache`) and :class:`NumpyCache` both consume, so
the two cannot drift. :class:`NumpyCache` services the same sequential
semantics as :func:`repro_torch.core.cache.access_ex` and ``reserve``, in
plain numpy: the discrete-event simulator
(:mod:`repro_torch.core.simulator`) feeds it millions of router
decisions.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.config import CacheConfig


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


@dataclass
class NumpyCache:
    """The N-index M-way cache in numpy: ``tags``/``age``/``flags`` [N, M]
    int64, the access clock, and demand hit, access, speculative-hit and
    reservation counters. The static-random policy pins M distinct experts
    a set, drawn from ``np.random.default_rng(seed)``."""
    ccfg: CacheConfig
    num_experts: int = 0
    seed: int = 0
    tags: np.ndarray = field(init=False)
    age: np.ndarray = field(init=False)
    flags: np.ndarray = field(init=False)
    clock: int = field(init=False, default=0)
    hits: int = field(init=False, default=0)
    accesses: int = field(init=False, default=0)
    spec_hits: int = field(init=False, default=0)
    reserved: int = field(init=False, default=0)

    def __post_init__(self):
        n, m = self.ccfg.num_indexes, self.ccfg.num_ways
        self.spec = policy_spec(self.ccfg.policy)
        self.tags = np.full((n, m), -1, np.int64)
        self.age = np.zeros((n, m), np.int64)
        self.flags = np.zeros((n, m), np.int64)
        if self.spec.is_static:
            rng = np.random.default_rng(self.seed)
            assert self.num_experts >= m
            for i in range(n):
                self.tags[i] = rng.permutation(self.num_experts)[:m]

    def access(self, layer: int, experts) -> List[bool]:
        """Service one layer's picks in order; returns the hit flags. A
        tag hit on a PENDING reservation reports a miss and inserts
        nothing; the first demand hit on a landed SPEC entry counts in
        ``spec_hits`` and promotes it to demand provenance."""
        out = []
        covered = layer < self.tags.shape[0]
        for e in experts:
            self.accesses += 1
            if not covered or e < 0:
                out.append(False)
                continue
            row_t, row_a = self.tags[layer], self.age[layer]
            row_f = self.flags[layer]
            ways = np.nonzero(row_t == e)[0]
            tag_hit = ways.size > 0
            pending = tag_hit and row_f[ways[0]] == FLAG_PENDING
            hit = tag_hit and not pending
            out.append(bool(hit))
            self.hits += int(hit)
            if self.spec.is_static:
                continue
            if tag_hit:
                way = ways[0]
                if self.spec.refresh_on_hit:
                    row_a[way] = self.clock
                if row_f[way] == FLAG_SPEC:
                    self.spec_hits += 1
                if not pending:
                    row_f[way] = FLAG_DEMAND
            else:
                empty = np.nonzero(row_t < 0)[0]
                way = empty[0] if empty.size else int(np.argmin(row_a))
                row_t[way] = e
                row_a[way] = self.clock
                row_f[way] = FLAG_DEMAND
            self.clock += 1
        return out

    def reserve(self, layer: int, experts, protect=None,
                priority=None) -> List[bool]:
        """Speculatively insert predicted experts (no demand accounting),
        with :func:`repro_torch.core.cache.reserve`'s rules: a way holding
        an expert of ``protect`` (default: the batch) is never the victim
        (the pick is skipped if it would be), ``priority`` adds to the
        inserted entry's age stamp, a present expert is left untouched and
        fresh inserts stay PENDING until :meth:`land`. Returns the issued
        flags."""
        out = []
        covered = layer < self.tags.shape[0]
        if protect is None:
            protect = experts
        if priority is None:
            priority = [0] * len(experts)
        batch = np.asarray([e for e in protect if e >= 0], np.int64)
        for e, pr in zip(experts, priority):
            if not covered or e < 0 or self.spec.is_static:
                out.append(False)
                continue
            row_t, row_a, row_f = (self.tags[layer], self.age[layer],
                                   self.flags[layer])
            if (row_t == e).any():
                out.append(False)
                self.clock += 1
                continue
            empty = np.nonzero(row_t < 0)[0]
            if empty.size:
                way = int(empty[0])
            else:
                prot = np.isin(row_t, batch)
                if prot.all():
                    out.append(False)
                    self.clock += 1
                    continue
                way = int(np.argmin(np.where(prot, np.iinfo(np.int64).max,
                                             row_a)))
            row_t[way] = e
            row_a[way] = self.clock + int(pr)
            row_f[way] = FLAG_PENDING
            self.clock += 1
            self.reserved += 1
            out.append(True)
        return out

    def land(self) -> None:
        """Mark every PENDING reservation as arrived (PENDING -> SPEC)."""
        self.flags[self.flags == FLAG_PENDING] = FLAG_SPEC

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)


def random_policy_hit_probs(num_experts: int, num_ways: int,
                            top_k: int = 2) -> Tuple[float, float]:
    """The paper's §IV-D closed forms for the static-random cache (top-2):

    P(>=1 of 2 experts hit) = 1 - (n-M)/n * (n-M-1)/(n-1)
    P(both hit)             = M/n * (M-1)/(n-1)
    """
    n, M = num_experts, num_ways
    p_any = 1.0 - ((n - M) / n) * ((n - M - 1) / (n - 1))
    p_both = (M / n) * ((M - 1) / (n - 1))
    return p_any, p_both
