"""The engine's prefill forward reads resident experts from the cache's
slot buffer and only the others from the host tier
(``repro_torch.core.collaborative.forward_experts``), on the reduced
Mixtral on the CPU.

The weights' values do not depend on where they are read from, so every
forward must be bitwise the forward over the layers' own host tables
(``moe._experts``, what every caller without a source reads): logits, KV
and routing ``torch.equal``. Each case builds two engines the same way
and runs the same forward on both, one with the source and one with it
dropped, in these cache situations: cold (all host), warmed by a served
request, the static-random policy's preloaded slots, a PENDING
reservation (read from the host, never from its slot), a cache that
covers fewer layers than the model, the segment-streamed forward and the
static batch's ``prefill`` with B > 1. Each forward leaves the cache
state (tags, ages, flags, clock) and the slots as it found them, and the
engine's counters count, forward by forward, what ``cache.lookup`` on
the state before it finds resident. Then a scheduler run serves the same
greedy tokens with the source and without it.
"""
import numpy as np
import pytest
import torch
from unittest import mock

from repro_torch import build
from repro_torch.config import get_config, reduced
from repro_torch.core import cache as cache_lib
from repro_torch.core import collaborative as collab
from repro_torch.models import init_params, transformer

torch.set_num_threads(2)

CFG = reduced(get_config("mixtral-8x7b"))
L, E = CFG.num_layers, CFG.moe.num_experts
PROMPT, NEW = 12, 6
SERVING = dict(max_batch=1, capacity=PROMPT + NEW + 2, prefill_chunk=8)
LRU = dict(num_indexes=L, num_ways=6, policy="lru")
BACKBONE = transformer.backbone


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _prompts(n, length=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size,
                                                (n, length))


def _serve_one(engine, sched):
    """Warm the cache as the previous request's decode leaves it."""
    sched.submit(_prompts(1, seed=1)[0], max_new_tokens=NEW)
    sched.run()


def _pending(engine, sched):
    """A served request, then a reservation for a layer-1 expert that is
    not resident, left PENDING, its slot overwritten: a read from the slot
    would show in the outputs."""
    _serve_one(engine, sched)
    tags = engine.tiers.state.tags[1].tolist()
    e = next(x for x in range(E) if x not in tags)
    pred = torch.tensor([[e, -1]], dtype=torch.int32)
    engine.tiers, _, _, n = collab.prefetch(engine.tiers, 1, pred,
                                            engine.ecfg.cache)
    assert n == 1
    way = engine.tiers.state.tags[1].tolist().index(e)
    slot = cache_lib.slot_id(1, way, engine.ecfg.cache.num_ways)
    for s in engine.tiers.slots:
        s[slot].fill_(3.0)
    table, _ = collab.forward_experts(engine.tiers, 1, engine.ecfg.cache)
    for t, h in zip(table, engine.tiers.host):
        assert torch.equal(t[e], h[1, e])


def _ticket(engine):
    """The admission forward (the scheduler's ``start_prefill``, routing
    traced for the warming replay) of one prompt."""
    t = engine.start_prefill(_prompts(1, seed=2)[0])
    kv = t.state["scan"]["s0"]
    return [t.logits, kv["k"], kv["v"], t.top_i]


def _streamed(engine):
    """A segment-streamed prefill to its end; the routing of each segment
    is what its warming replay receives."""
    routes = []
    warm = engine._warm_chunk

    def seen(top_i, active):
        routes.append(top_i.clone())
        return warm(top_i, active)

    with mock.patch.object(engine, "_warm_chunk", seen):
        t = engine.start_prefill(_prompts(1, seed=2)[0])
        while not engine.advance_prefill(t):
            pass
    kv = t.state["scan"]["s0"]
    return [t.logits, kv["k"], kv["v"], *routes]


def _static(engine):
    """The static batch's bypass ``prefill`` of B = 3 prompts, and the same
    forward's routing."""
    batch = _prompts(3, seed=3)
    logits, state = engine.prefill(batch)
    _, _, trace = engine._padded_prefill(batch, want_trace=True)
    kv = state["scan"]["s0"]
    return [logits, kv["k"], kv["v"], trace["top_i"]]


CASES = {
    # name: (cache, serving overrides, preparation, forward, resident?)
    "cold_lru": (LRU, {}, None, _ticket, False),
    "warm_lru": (LRU, {}, _serve_one, _ticket, True),
    "random_preloaded": (dict(LRU, policy="random"), {}, None, _ticket,
                         True),
    "pending_prefetch": (dict(LRU, num_ways=4), dict(prefetch=True),
                         _pending, _ticket, True),
    "partial_coverage": (dict(LRU, num_indexes=1), {}, _serve_one, _ticket,
                         True),
    "segment_stream": (LRU, dict(prefill_segment=4), _serve_one, _streamed,
                       True),
    "static_batch": (LRU, {}, _serve_one, _static, True),
}


def _snapshot(tiers):
    return [t.clone() for t in (*tiers.state, *tiers.slots)]


def _resident(state):
    """[L] experts ``cache.lookup`` finds resident (PENDING excluded)."""
    return [int(cache_lib.lookup(state, layer, torch.arange(
        E, dtype=torch.int32))[0].sum()) for layer in range(L)]


def _run(params, case, source):
    """One engine prepared for ``case`` and its forward, with the slot
    source or with it dropped (the host tables). Returns (outputs, each
    backbone call's (resident experts a layer by lookup before it, the
    counters' deltas over it, the tiers before and after it), the
    engine's stats before the forward, engine)."""
    cache, serving, prep, forward, _ = CASES[case]
    engine, sched = build(CFG, cache=cache, serving=dict(SERVING, **serving),
                          params=params, seed=0, device="cpu")
    if prep is not None:
        prep(engine, sched)
    stats0, calls = engine.stats, []

    def backbone(*a, expert_source=None, **k):
        before, reads0 = _snapshot(engine.tiers), engine._forward_reads()
        hand = _resident(engine.tiers.state)
        out = BACKBONE(*a, expert_source=expert_source if source else None,
                       **k)
        reads = [b - a for a, b in zip(reads0, engine._forward_reads())]
        calls.append((hand, reads, before, _snapshot(engine.tiers)))
        return out

    with mock.patch.object(transformer, "backbone", backbone):
        outs = forward(engine)
    return outs, calls, stats0, engine


@pytest.mark.parametrize("case", list(CASES))
def test_forward_reads_slots_bitwise(params, case):
    got, calls, stats0, engine = _run(params, case, source=True)
    want, host_calls, _, _ = _run(params, case, source=False)
    assert len(got) == len(want) and calls
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{case}: output {i}"
    resident = 0
    for hand, (res, n), before, after in calls:
        # the forward only reads the cache state and the slots
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        assert (res, n) == (sum(hand), L * E)
        if case == "partial_coverage":      # layers >= N read the host
            assert hand[1:] == [0] * (L - 1)
        resident += res
    assert all(reads == [0, 0] for _, reads, _, _ in host_calls)
    s0, s1 = stats0, engine.stats
    assert s1.prefill_forward_resident - s0.prefill_forward_resident == \
        resident
    assert s1.prefill_forward_experts - s0.prefill_forward_experts == \
        len(calls) * L * E
    assert (resident > 0) == CASES[case][4], resident
    print(f"\n{case}: {len(calls)} forwards, {resident} of "
          f"{len(calls) * L * E} expert reads from the slots")


def test_served_tokens_equal_with_and_without_the_source(params):
    """Two slots, four requests: admissions land while the other slot
    decodes, and every greedy token and the cache's final state are the
    same whether the forwards read the slots or the host tables."""
    def serve(source):
        engine, sched = build(CFG, cache=LRU, serving=dict(
            SERVING, max_batch=2), params=params, seed=0, device="cpu")

        def backbone(*a, expert_source=None, **k):
            return BACKBONE(*a, expert_source=expert_source if source
                            else None, **k)

        with mock.patch.object(transformer, "backbone", backbone):
            reqs = [sched.submit(p, max_new_tokens=NEW)
                    for p in _prompts(4, seed=4)]
            sched.run()
        return [r.output for r in reqs], engine

    got, engine = serve(True)
    want, host = serve(False)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for x, y in zip(engine.tiers.state, host.tiers.state):
        assert torch.equal(x, y)
    assert engine.stats.prefill_forward_resident > 0
    assert host.stats.prefill_forward_experts == 0
