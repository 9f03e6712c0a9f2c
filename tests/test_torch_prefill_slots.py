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

Each forward's source (``collaborative.ForwardExperts``) queues layer
l+1's host-tier reads when it hands layer l its table, layer 0's before
the embedding (on the CPU the copies are synchronous). In the same cases
the forward runs with that lookahead and without it (each layer's table
read when it asks, as ``forward_experts`` alone): the tables each layer
gets equal ``forward_experts``' own, the outputs are bitwise equal, the
reads stop at the last MoE layer, no table outlives the forward, and
``prefill_forward_ahead`` counts exactly the reads queued before their
layer asked. A scheduler run serves the same greedy tokens with and
without the lookahead.
"""
import dataclasses
import gc
import weakref
from types import SimpleNamespace

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
LOOKAHEAD = collab.ForwardExperts
# the counters of a forward's expert reads, in the order ``_run`` reports
READS = ("prefill_forward_resident", "prefill_forward_experts",
         "prefill_forward_ahead")


class OneLayer:
    """A forward's source without the lookahead: each layer's table read
    when the layer asks (``forward_experts``), nothing queued ahead."""

    def __init__(self, tiers, ccfg):
        self.tiers, self.ccfg = tiers, ccfg

    def read(self, layer):
        table, resident = collab.forward_experts(self.tiers, layer,
                                                 self.ccfg)
        return table, resident, 0

    def close(self):
        pass


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


def _run(params, case, source, lookahead=True):
    """One engine prepared for ``case`` and its forward, with the slot
    source (queuing a layer ahead, or with ``lookahead`` False, each
    layer's reads when it asks) or with it dropped (the host tables).
    Returns what it saw: the forward's outputs; each backbone call's
    (resident experts a layer by lookup before it, the counters' deltas
    over it, the tiers before and after it); each table a layer was
    handed (layer, equal to ``forward_experts``' own, weak references);
    every layer whose host reads a source queued, in order; the engine's
    stats before the forward, and the engine."""
    cache, serving, prep, forward, _ = CASES[case]
    engine, sched = build(CFG, cache=cache, serving=dict(SERVING, **serving),
                          params=params, seed=0, device="cpu")
    if prep is not None:
        prep(engine, sched)
    stats0, calls, handed, issued = engine.stats, [], [], []
    issue = LOOKAHEAD._issue

    def seen_issue(self, layer):
        issued.append(layer)
        return issue(self, layer)

    def backbone(*a, expert_source=None, **k):
        before, stats0 = _snapshot(engine.tiers), engine.stats
        hand = _resident(engine.tiers.state)

        def seen(layer):
            table = expert_source(layer)
            want, _ = collab.forward_experts(engine.tiers, layer,
                                             engine.ecfg.cache)
            handed.append((layer, all(torch.equal(t, w)
                                      for t, w in zip(table, want)),
                           [weakref.ref(t) for t in table]))
            return table

        out = BACKBONE(*a, expert_source=seen if source else None, **k)
        stats1 = engine.stats
        reads = [getattr(stats1, k) - getattr(stats0, k) for k in READS]
        calls.append((hand, reads, before, _snapshot(engine.tiers)))
        return out

    with mock.patch.object(transformer, "backbone", backbone), \
            mock.patch.object(LOOKAHEAD, "_issue", seen_issue), \
            mock.patch.object(collab, "ForwardExperts",
                              LOOKAHEAD if lookahead else OneLayer):
        outs = forward(engine)
    gc.collect()
    return SimpleNamespace(outs=outs, calls=calls, handed=handed,
                           issued=issued, stats0=stats0, engine=engine)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_reads_slots_bitwise(params, case):
    run = _run(params, case, source=True)
    host = _run(params, case, source=False)
    got, calls, engine = run.outs, run.calls, run.engine
    want = host.outs
    assert len(got) == len(want) and calls
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{case}: output {i}"
    resident = 0
    for hand, (res, n, ahead), before, after in calls:
        # the forward only reads the cache state and the slots
        assert all(torch.equal(x, y) for x, y in zip(before, after))
        assert (res, n, ahead) == (sum(hand), L * E, L * E - sum(hand))
        if case == "partial_coverage":      # layers >= N read the host
            assert hand[1:] == [0] * (L - 1)
        resident += res
    assert all(reads == [0, 0, 0] for _, reads, _, _ in host.calls)
    s0, s1 = run.stats0, engine.stats
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


@pytest.mark.parametrize("case", list(CASES))
def test_lookahead_hands_each_layer_its_table(params, case):
    """The padded, segment-streamed and static-batch forwards with the
    lookahead and without it: bitwise equal outputs; every table handed
    equals ``forward_experts``' own on the state as it stands; each
    forward queues layers 0 .. L-1 once, in order, and nothing past the
    last; no handed table is alive once the forward has returned; the
    cache state and the slots are as before; ``prefill_forward_ahead``
    counts every host read with the lookahead and none without."""
    ahead, plain = (_run(params, case, source=True, lookahead=flag)
                    for flag in (True, False))
    assert len(ahead.outs) == len(plain.outs)
    for i, (a, b) in enumerate(zip(ahead.outs, plain.outs)):
        assert torch.equal(a, b), f"{case}: output {i}"
    for run, want_issued in ((ahead, list(range(L))), (plain, [])):
        n = len(run.calls)
        assert n > 0
        assert [layer for layer, _, _ in run.handed] == list(range(L)) * n
        assert all(equal for _, equal, _ in run.handed), case
        assert run.issued == want_issued * n
        assert not any(r() is not None for _, _, refs in run.handed
                       for r in refs), "a table outlived its forward"
        queued = 0
        for hand, (res, total, queued_ahead), before, after in run.calls:
            assert all(torch.equal(x, y) for x, y in zip(before, after))
            assert (res, total) == (sum(hand), L * E)
            assert queued_ahead == (total - res if run is ahead else 0)
            queued += queued_ahead
        s0, s1 = run.stats0, run.engine.stats
        assert s1.prefill_forward_ahead - s0.prefill_forward_ahead == queued
    assert ahead.engine.stats.prefill_forward_ahead > \
        ahead.stats0.prefill_forward_ahead


def test_served_tokens_equal_with_and_without_the_lookahead(params):
    """The scheduler run of the source's test, with the lookahead and
    without it: the same first and greedy tokens, the same final cache
    state and slots, and every host read of the forwards queued ahead."""
    def serve(source):
        engine, sched = build(CFG, cache=LRU, serving=dict(
            SERVING, max_batch=2), params=params, seed=0, device="cpu")
        with mock.patch.object(collab, "ForwardExperts", source):
            reqs = [sched.submit(p, max_new_tokens=NEW)
                    for p in _prompts(4, seed=4)]
            sched.run()
        return [r.output for r in reqs], engine

    got, engine = serve(LOOKAHEAD)
    want, plain = serve(OneLayer)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for x, y in zip((*engine.tiers.state, *engine.tiers.slots),
                    (*plain.tiers.state, *plain.tiers.slots)):
        assert torch.equal(x, y)
    s, p = engine.stats, plain.stats
    assert s.prefill_forward_ahead == \
        s.prefill_forward_experts - s.prefill_forward_resident > 0
    assert p.prefill_forward_ahead == 0
    assert (s.prefill_forward_resident, s.prefill_forward_experts) == \
        (p.prefill_forward_resident, p.prefill_forward_experts)


CFG4 = dataclasses.replace(CFG, num_layers=4)


@pytest.mark.parametrize("layers", [(0, 1, 2, 3), (0, 2, 3), (1, 2),
                                    (0, 0, 1, 3, 3)])
def test_lookahead_counts_the_reads_queued_ahead(layers):
    """A source read in another order than the forward's (a layer
    skipped, a layer read twice) on a four-layer model, two of whose
    layers the cache covers, partly warm: each table equals
    ``forward_experts``' own, also where the two tables are reused, and a
    read counts as ahead only where the layer before it queued it (layer
    0: the source, when made). Nothing is queued past the last layer,
    and nothing is held after ``close``."""
    engine, sched = build(CFG4, cache=dict(LRU, num_indexes=2),
                          serving=SERVING, seed=0, device="cpu")
    _serve_one(engine, sched)
    tiers, ccfg = engine.tiers, engine.ecfg.cache
    before = _snapshot(tiers)
    issued, issue = [], LOOKAHEAD._issue

    def seen_issue(self, layer):
        issued.append(layer)
        return issue(self, layer)

    with mock.patch.object(LOOKAHEAD, "_issue", seen_issue):
        src = collab.ForwardExperts(tiers, ccfg)
        prev, refs = -1, []
        for layer in layers:
            table, resident, ahead = src.read(layer)
            want, want_res = collab.forward_experts(tiers, layer, ccfg)
            assert all(torch.equal(t, w) for t, w in zip(table, want))
            assert resident == want_res
            assert ahead == (E - resident if layer == prev + 1 else 0)
            refs += [weakref.ref(t) for t in table]
            prev = layer
        del table
        src.close()
    gc.collect()
    assert all(r() is None for r in refs)
    assert max(issued) <= 3 and issued[0] == 0
    assert all(torch.equal(x, y) for x, y in zip(before, _snapshot(tiers)))
