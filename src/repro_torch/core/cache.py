"""The paper's expert cache: N-index, M-way set-associative (counterpart of
the reference's ``core/cache.py``).

The paper's cache manager lives on the host, and so does this one: the
state is four small CPU ``int32`` tensors and every operation runs on the
host, so deciding a copy never needs a device round trip. The semantics,
including the sequential servicing of one layer's picks (a duplicate pick
refreshes twice, an insert at pick i is visible to pick i+1), match the
reference bit for bit:

  tags      [N, M] — resident expert id per slot, -1 = empty
  age       [N, M] — last-access clock (LRU) / insertion clock (FIFO)
  clock     []     — global access counter
  in_flight [N, M] — FLAG_DEMAND / FLAG_SPEC / FLAG_PENDING provenance

Layers >= N are beyond coverage: accesses miss and inserts are suppressed.

``reserve`` inserts *predicted* experts for a later probe (speculative
prefetch) with the demand path's victim rule but none of a demand access's
effects: it reports no hit, leaves an expert already present (resident or
PENDING) untouched and never reserves under the static policy. A new
reservation is PENDING until ``land`` (the next probe) marks it SPEC.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import CacheConfig
from .policies import FLAG_DEMAND, FLAG_PENDING, FLAG_SPEC, policy_spec

I32 = torch.int32
PROTECTED = torch.iinfo(I32).max     # a protected way's victim score


class CacheState(NamedTuple):
    tags: torch.Tensor
    age: torch.Tensor
    clock: torch.Tensor
    in_flight: torch.Tensor

    @property
    def num_indexes(self) -> int:
        return self.tags.shape[0]

    @property
    def num_ways(self) -> int:
        return self.tags.shape[1]


def init_cache_state(ccfg: CacheConfig, num_experts: int = 0,
                     generator: Optional[torch.Generator] = None
                     ) -> CacheState:
    """Empty cache; the static-random policy pins M distinct experts per
    set drawn from ``generator`` (a CPU generator)."""
    spec = policy_spec(ccfg.policy)
    n, m = ccfg.num_indexes, ccfg.num_ways
    tags = torch.full((n, m), -1, dtype=I32)
    if spec.needs_key:
        if generator is None or num_experts <= 0:
            raise ValueError("static-random policy needs a generator and "
                             "the expert count")
        for i in range(n):
            tags[i] = torch.randperm(num_experts, generator=generator)[:m]
    return CacheState(tags=tags, age=torch.zeros((n, m), dtype=I32),
                      clock=torch.zeros((), dtype=I32),
                      in_flight=torch.zeros((n, m), dtype=I32))


def lookup(state: CacheState, layer: int, experts: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only probe. experts [A] -> (hit [A] bool, way [A] int32). A
    PENDING reservation is not a hit."""
    n = state.num_indexes
    row = layer if layer < n else 0
    tags_l, flag_l = state.tags[row], state.in_flight[row]
    eq = tags_l[None, :] == experts[:, None]                 # [A, M]
    way = eq.to(torch.uint8).argmax(dim=1).to(I32)
    hit = eq.any(dim=1) & (layer < n) & (experts >= 0) \
        & (flag_l[way.long()] != FLAG_PENDING)
    return hit, way


def access_ex(state: CacheState, layer: int, experts: torch.Tensor,
              policy: str
              ) -> Tuple[CacheState, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Probe + update for one layer's picks, serviced in order.

    experts [A] int32 (duplicates allowed; entries < 0 are masked). Returns
    (new state, hit [A] bool, way [A] int32 — -1 for masked, uncovered or
    static-policy misses, spec_served [A] bool — hits on a landed
    speculative entry, which the hit promotes to demand provenance)."""
    spec = policy_spec(policy)
    n = state.num_indexes
    covered = layer < n
    row = layer if covered else 0
    picks = [int(e) for e in experts.tolist()]

    if spec.is_static:
        hit, way = lookup(state._replace(
            in_flight=torch.zeros_like(state.in_flight)), layer, experts)
        ways = torch.where(hit, way, torch.full_like(way, -1))
        return state, hit, ways, torch.zeros_like(hit)

    tags_l = state.tags[row].tolist()
    age_l = state.age[row].tolist()
    flag_l = state.in_flight[row].tolist()
    clock = int(state.clock)
    hits, spec_served, ways = [], [], []
    for e in picks:
        valid = covered and e >= 0
        tag_hit = valid and e in tags_l
        if tag_hit:
            way = tags_l.index(e)
        else:   # empty ways first (score -1), else the min-age way
            scores = [-1 if t < 0 else a for t, a in zip(tags_l, age_l)]
            way = scores.index(min(scores))
        pending = tag_hit and flag_l[way] == FLAG_PENDING
        hits.append(tag_hit and not pending)
        spec_served.append(tag_hit and flag_l[way] == FLAG_SPEC)
        refresh = valid if spec.refresh_on_hit else (valid and not tag_hit)
        if valid:
            tags_l[way] = e
        if refresh:
            age_l[way] = clock
        if valid and not pending:
            flag_l[way] = FLAG_DEMAND
        clock += 1
        ways.append(way if valid else -1)

    new = _put_row(state, row, tags_l, age_l, clock, flag_l)
    return (new, torch.tensor(hits, dtype=torch.bool),
            torch.tensor(ways, dtype=I32),
            torch.tensor(spec_served, dtype=torch.bool))


def reserve(state: CacheState, layer: int, experts: torch.Tensor,
            policy: str, protect: Optional[torch.Tensor] = None,
            priority: Optional[torch.Tensor] = None
            ) -> Tuple[CacheState, torch.Tensor, torch.Tensor]:
    """Speculatively insert predicted experts, serviced in order.

    experts [A] int32 (duplicates and -1 masks allowed). A way holding an
    expert of ``protect`` (default: the batch itself) is never the victim;
    if the victim is protected the pick is skipped. ``priority`` [A]
    (default 0) is added to the inserted entry's age stamp, so later
    min-age evictions take low-priority reservations first. Every pick
    advances the clock. Returns (new state, issued [A] bool — picks whose
    reservation claimed a slot, way [A] int32 — the claimed way, -1 where
    nothing was issued)."""
    spec = policy_spec(policy)
    A = experts.shape[0]
    if spec.is_static:
        return (state, torch.zeros(A, dtype=torch.bool),
                torch.full((A,), -1, dtype=I32))
    covered = layer < state.num_indexes
    row = layer if covered else 0
    picks = [int(e) for e in experts.tolist()]
    prot = {int(e) for e in (experts if protect is None else protect).tolist()}
    prio = [0] * A if priority is None else [int(p) for p in priority.tolist()]
    tags_l = state.tags[row].tolist()
    age_l = state.age[row].tolist()
    flag_l = state.in_flight[row].tolist()
    clock = int(state.clock)
    issued, ways = [], []
    for e, p in zip(picks, prio):
        valid = covered and e >= 0
        present = valid and e in tags_l
        # protected ways rank above every age (the reference's int32 max);
        # empty ways (-1) never count as protected
        guarded = [t >= 0 and t in prot for t in tags_l]
        scores = [-1 if t < 0 else (PROTECTED if g else a)
                  for t, a, g in zip(tags_l, age_l, guarded)]
        victim = scores.index(min(scores))
        insert = valid and not present and not guarded[victim]
        if insert:
            tags_l[victim], age_l[victim] = e, clock + p
            flag_l[victim] = FLAG_PENDING
        clock += 1
        issued.append(insert)
        ways.append(victim if insert else -1)
    return (_put_row(state, row, tags_l, age_l, clock, flag_l),
            torch.tensor(issued, dtype=torch.bool),
            torch.tensor(ways, dtype=I32))


def _put_row(state: CacheState, row: int, tags_l, age_l, clock: int,
             flag_l) -> CacheState:
    """A new state with set ``row`` replaced and the clock advanced."""
    def put(full, vals):
        out = full.clone()
        out[row] = torch.tensor(vals, dtype=I32)
        return out
    return CacheState(put(state.tags, tags_l), put(state.age, age_l),
                      torch.tensor(clock, dtype=I32),
                      put(state.in_flight, flag_l))


def land(state: CacheState) -> CacheState:
    """Mark every PENDING reservation as arrived (PENDING -> SPEC)."""
    f = state.in_flight
    return state._replace(in_flight=torch.where(
        f == FLAG_PENDING, torch.full_like(f, FLAG_SPEC), f))


def slot_id(layer, way, num_ways: int):
    """Flat slot index into the [N*M, ...] cache weight buffer."""
    return layer * num_ways + way
