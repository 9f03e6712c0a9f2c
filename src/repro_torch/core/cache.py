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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import CacheConfig
from .policies import FLAG_DEMAND, FLAG_PENDING, FLAG_SPEC, policy_spec

I32 = torch.int32


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

    def put(full, row_vals):
        out = full.clone()
        out[row] = torch.tensor(row_vals, dtype=I32)
        return out
    new = CacheState(put(state.tags, tags_l), put(state.age, age_l),
                     torch.tensor(clock, dtype=I32),
                     put(state.in_flight, flag_l))
    return (new, torch.tensor(hits, dtype=torch.bool),
            torch.tensor(ways, dtype=I32),
            torch.tensor(spec_served, dtype=torch.bool))


def land(state: CacheState) -> CacheState:
    """Mark every PENDING reservation as arrived (PENDING -> SPEC)."""
    f = state.in_flight
    return state._replace(in_flight=torch.where(
        f == FLAG_PENDING, torch.full_like(f, FLAG_SPEC), f))


def slot_id(layer, way, num_ways: int):
    """Flat slot index into the [N*M, ...] cache weight buffer."""
    return layer * num_ways + way
