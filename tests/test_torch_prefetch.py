"""Speculative prefetch in the port (``repro_torch.core.cache.reserve``,
``repro_torch.core.collaborative.prediction_votes`` / ``prefetch`` and the
engine's pipeline) against the reference's (``repro.core``), on the CPU.

The cases are those of the reference's ``tests/test_prefetch.py``. Cache
cases drive one state in each package with the same calls (:class:`Both`)
and compare every output and the whole state (tags, ages, clock, flags)
after every call: integer state, so exactly. Stage cases run on fp32
weights drawn from a seed; the slot buffers must equal the reference's
bit for bit (both copy the same host weights) and y agree within 1e-5,
as ``tests/test_torch_collaborative.py``. Engine cases run the port alone
at the reduced Mixtral (seeded weights) and compare it with itself:
prefetch moves residency, never logits, so those equalities are bitwise.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import collaborative as jcollab  # noqa: E402
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.config import CacheConfig, get_config, reduced  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.core.policies import FLAG_DEMAND, FLAG_PENDING, \
    FLAG_SPEC  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serving import CollaborativeEngine, EngineConfig  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("tags", "age", "clock", "in_flight")


def _i32(xs):
    return np.asarray(xs, np.int32)


class Both:
    """One cache state in each package, driven by the same calls; each call
    checks that outputs and states agree and returns the port's outputs as
    numpy."""

    def __init__(self, n, m, policy="lru", num_experts=0, tags=None):
        self.policy = policy
        self.j = jcache.init_cache_state(
            JaxCacheConfig(num_indexes=n, num_ways=m, policy=policy),
            num_experts, jax.random.PRNGKey(0) if policy == "random" else None)
        if tags is None:
            self.t = tcache.init_cache_state(
                CacheConfig(num_indexes=n, num_ways=m, policy=policy),
                num_experts, torch.Generator().manual_seed(0))
            # static placement: the port draws other experts; share them
            self.t = self.t._replace(tags=torch.from_numpy(
                np.asarray(self.j.tags).copy()))
        self.check()

    def check(self):
        for name in FIELDS:
            np.testing.assert_array_equal(
                getattr(self.t, name).numpy(),
                np.asarray(getattr(self.j, name)), err_msg=name)

    def access(self, layer, experts):
        e = _i32(experts)
        self.j, jh, jw, jsp = jcache.access_ex(
            self.j, jnp.int32(layer), jnp.asarray(e), self.policy)
        self.t, th, tw, tsp = tcache.access_ex(
            self.t, layer, torch.from_numpy(e), self.policy)
        for a, b in ((th, jh), (tw, jw), (tsp, jsp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        self.check()
        return th.numpy(), tsp.numpy()

    def reserve(self, layer, experts, protect=None, priority=None):
        e = _i32(experts)
        jkw, tkw = {}, {}
        if protect is not None:
            jkw["protect"] = jnp.asarray(_i32(protect))
            tkw["protect"] = torch.from_numpy(_i32(protect))
        if priority is not None:
            jkw["priority"] = jnp.asarray(_i32(priority))
            tkw["priority"] = torch.from_numpy(_i32(priority))
        self.j, ji, jw = jcache.reserve(self.j, jnp.int32(layer),
                                        jnp.asarray(e), self.policy, **jkw)
        self.t, ti, tw = tcache.reserve(self.t, layer, torch.from_numpy(e),
                                        self.policy, **tkw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        self.check()
        return ti.numpy(), tw.numpy()

    def land(self):
        self.j, self.t = jcache.land(self.j), tcache.land(self.t)
        self.check()

    def lookup(self, layer, experts):
        e = _i32(experts)
        jh, jw = jcache.lookup(self.j, jnp.int32(layer), jnp.asarray(e))
        th, tw = tcache.lookup(self.t, layer, torch.from_numpy(e))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        return th.numpy()


# -- reserve / land semantics ------------------------------------------------

@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_reservation_invisible_same_step_visible_next(policy):
    c = Both(2, 2, policy)
    issued, _ = c.reserve(1, [4, 6])
    assert issued.tolist() == [True, True]
    assert (c.t.in_flight[1] == FLAG_PENDING).all()
    # same step: the probe and the demand access both miss the PENDING
    # reservations, and the access neither re-inserts nor evicts
    assert not c.lookup(1, [4, 6]).any()
    tags = c.t.tags.clone()
    hits, spec = c.access(1, [4, 6])
    assert not hits.any() and not spec.any()
    assert torch.equal(c.t.tags, tags)
    # next probe boundary: landed, they serve hits credited once to the
    # speculative channel
    c.land()
    assert (c.t.in_flight[1] == FLAG_SPEC).all()
    hits, spec = c.access(1, [4, 6])
    assert hits.all() and spec.all()
    hits, spec = c.access(1, [4, 6])
    assert hits.all() and not spec.any()


def test_reserve_has_no_demand_observable_effects():
    """Reserving experts already present changes nothing (no age refresh):
    1 stays the LRU victim of the next demand insert."""
    c = Both(1, 2)
    c.access(0, [1, 2])
    before = [getattr(c.t, f).clone() for f in ("tags", "age", "in_flight")]
    issued, ways = c.reserve(0, [1, 2])
    assert not issued.any() and (ways == -1).all()
    after = [getattr(c.t, f) for f in ("tags", "age", "in_flight")]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    c.access(0, [3])
    assert 1 not in c.t.tags[0].tolist() and 2 in c.t.tags[0].tolist()


def test_reserve_does_not_duplicate_in_flight_fetches():
    c = Both(1, 4)
    assert c.reserve(0, [5])[0].all()
    # re-reserving, in the same step or after landing, issues nothing
    assert not c.reserve(0, [5, 5])[0].any()
    c.land()
    assert not c.reserve(0, [5])[0].any()


def test_reserve_batch_protection():
    """Reserving pick B must not evict predicted pick A of the same batch;
    with every way protected the pick is skipped, not forced."""
    c = Both(1, 2)
    c.access(0, [1])            # oldest way: expert 1
    c.access(0, [2])
    issued, _ = c.reserve(0, [1, 3])
    assert issued.tolist() == [False, True]
    assert set(c.t.tags[0].tolist()) == {1, 3}
    c1 = Both(1, 1)
    c1.access(0, [7])
    assert not c1.reserve(0, [7, 3])[0].any()
    assert int(c1.t.tags[0, 0]) == 7
    # an explicit protect set guards ways the batch does not name
    c2 = Both(1, 2)
    c2.access(0, [1])
    c2.access(0, [2])
    issued, ways = c2.reserve(0, [3], protect=[1, 3])
    assert issued.tolist() == [True] and set(c2.t.tags[0].tolist()) == {1, 3}


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_reserve_priority_ranks_retention(policy):
    """``priority`` adds to the reservation's age stamp: a later demand
    insert evicts the lowest-priority reservation, claim order unchanged."""
    c = Both(2, 3, policy)
    issued, _ = c.reserve(0, [1, 2, 3], priority=[0, 5, 0])
    assert issued.all()
    c.land()
    hits, _ = c.access(0, [7])
    assert not hits.any()
    assert set(c.t.tags[0].tolist()) == {7, 2, 3}


def test_reserve_static_policy_and_coverage():
    c = Both(2, 2, "random", num_experts=8)
    tags = c.t.tags.clone()
    assert not c.reserve(0, [1, 2])[0].any()
    assert torch.equal(c.t.tags, tags)
    c2 = Both(2, 2)
    issued, ways = c2.reserve(5, [1, 2])           # beyond coverage
    assert not issued.any() and (ways == -1).all()
    assert (c2.t.tags == -1).all() and int(c2.t.clock) == 2


def test_demand_insert_over_pending_way_clears_flag():
    c = Both(1, 1)
    assert c.reserve(0, [4])[0].all()
    hits, _ = c.access(0, [6])                      # evicts pending 4
    assert not hits.any()
    assert int(c.t.tags[0, 0]) == 6
    assert int(c.t.in_flight[0, 0]) == FLAG_DEMAND


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_reserve_streams_match_reference(policy):
    """Random interleavings of access / reserve (with protect sets and
    priorities) / land: outputs and the whole state equal the reference's
    after every call."""
    rng = np.random.default_rng(5 if policy == "lru" else 6)
    for _ in range(4):
        n, m = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        e = int(rng.integers(max(m, 2), 9))
        c = Both(n, m, policy)
        for _ in range(25):
            layer = int(rng.integers(0, n + 1))
            ex = rng.integers(-1, e, size=int(rng.integers(1, 6)))
            op = int(rng.integers(0, 4))
            if op == 0:
                c.access(layer, ex)
            elif op == 1:
                c.reserve(layer, ex)
            elif op == 2:
                prot = rng.integers(-1, e, size=int(rng.integers(0, 4)))
                c.reserve(layer, ex, protect=prot,
                          priority=rng.integers(0, 4, size=ex.size))
            else:
                c.land()


def test_prediction_votes_match_reference():
    got = tcollab.prediction_votes(torch.tensor([3, 5, 3, -1, 3],
                                                dtype=torch.int32))
    assert got.tolist() == [3, 1, 3, 0, 3]
    assert tcollab.prediction_votes(
        torch.tensor([-1, -1, 2], dtype=torch.int32)).tolist() == [0, 0, 1]
    rng = np.random.default_rng(7)
    for _ in range(20):
        p = rng.integers(-1, 6, size=int(rng.integers(1, 12))).astype(np.int32)
        np.testing.assert_array_equal(
            tcollab.prediction_votes(torch.from_numpy(p)).numpy(),
            np.asarray(jcollab.prediction_votes(jnp.asarray(p))))


# -- the prefetch stage --------------------------------------------------------

L, E, D, F = 3, 4, 16, 32


def _tiers(seed, ccfg_kw=None):
    """The same fp32 tiers in both packages (weights drawn from ``seed``)."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((L, E, D, F), (L, E, D, F), (L, E, F, D))]
    kw = dict(num_indexes=2, num_ways=2, policy="lru", **(ccfg_kw or {}))
    jcfg, tcfg = JaxCacheConfig(**kw), CacheConfig(**kw)
    jt = jcollab.init_tiers(*(jnp.asarray(w) for w in ws), jcfg,
                            num_experts=E)
    tt = tcollab.init_tiers(*(tensor_from_numpy(w, "cpu") for w in ws), tcfg,
                            num_experts=E, device="cpu")
    return jt, tt, jcfg, tcfg


def _same_tiers(tt, jt):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tt.state, name).numpy(),
                                      np.asarray(getattr(jt.state, name)),
                                      err_msg=name)
    for ts, js in zip(tt.slots, (jt.slot_w1, jt.slot_w3, jt.slot_w2)):
        np.testing.assert_array_equal(tensor_to_numpy(ts), np.asarray(js))


def test_prefetch_stage_populates_next_layer_probe():
    """prefetch() at layer 1 puts the predicted experts' host weights in
    their slots; the next probe hits them (credited to the speculative
    channel) and y is unchanged against never-prefetched tiers."""
    jt, tt, jcfg, tcfg = _tiers(2)
    _, tref, _, _ = _tiers(2)
    ti = np.asarray([[0, 1], [1, 2]], np.int32)
    tw = np.asarray([[0.5, 0.5], [0.6, 0.4]], np.float32)
    x = np.random.default_rng(2).standard_normal((2, D)).astype(np.float32)
    jt, jrep, jiss, jn = jcollab.prefetch(jt, jnp.int32(1), jnp.asarray(ti),
                                          jcfg)
    tt, rep, iss, n = tcollab.prefetch(tt, 1, torch.from_numpy(ti), tcfg)
    assert n == int(jn) == 2          # ways = 2: the protected inserts only
    np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(iss.numpy(), np.asarray(jiss))
    _same_tiers(tt, jt)
    st = tcache.land(tt.state)
    res, way = tcache.lookup(st, 1, torch.tensor([0, 1], dtype=torch.int32))
    assert res.all()
    for e, w in zip([0, 1], way.tolist()):
        assert torch.equal(tt.slot_w1[1 * tcfg.num_ways + w], tt.host_w1[1, e])
    y_pf, tt, s_pf = tcollab.collaborative_moe(
        tt, 1, torch.from_numpy(x), torch.from_numpy(ti), torch.from_numpy(tw),
        tcfg)
    y_rf, tref, s_rf = tcollab.collaborative_moe(
        tref, 1, torch.from_numpy(x), torch.from_numpy(ti),
        torch.from_numpy(tw), tcfg)
    np.testing.assert_allclose(y_pf.numpy(), y_rf.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert s_pf["prefetch_hits"] >= 2
    assert s_pf["hits"] >= s_rf["hits"] + 2


@pytest.mark.parametrize("rank_votes", [False, True])
def test_prefetch_pipeline_matches_reference(rank_votes):
    """A seeded stream of probe -> execute -> commit -> prefetch(l+1), as
    the engine drives it: hits, fetches, issued groups, the cache state
    and the slot buffers equal the reference's after every stage; y within
    1e-5 (fp32 sums over D = 16 terms)."""
    jt, tt, jcfg, tcfg = _tiers(3)
    rng = np.random.default_rng(3)
    T, K = 3, 2
    for _ in range(30):
        layer = int(rng.integers(0, L))
        top_i = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
        pred = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
        pred = np.where(rng.random((T, K)) < 0.2, -1, pred).astype(np.int32)
        top_w = rng.random((T, K)).astype(np.float32)
        active = rng.random(T) < 0.8
        x = rng.standard_normal((T, D)).astype(np.float32)
        jpr = jcollab.probe(jt, jnp.int32(layer), jnp.asarray(top_i), jcfg,
                            active=jnp.asarray(active))
        jy, jhost = jcollab.execute(jt, jnp.int32(layer), jnp.asarray(x),
                                    jnp.asarray(top_w), jpr, jcfg)
        jt, jfetch = jcollab.commit(jt, jnp.int32(layer), jpr, jhost, jcfg)
        jt, jrep, jiss, jn = jcollab.prefetch(
            jt, jnp.int32(layer + 1), jnp.asarray(pred), jcfg,
            active=jnp.asarray(active), rank_votes=rank_votes)
        act = torch.from_numpy(active)
        tpr = tcollab.probe(tt, layer, torch.from_numpy(top_i), tcfg,
                            active=act)
        ty, staged = tcollab.execute(tt, layer, torch.from_numpy(x),
                                     torch.from_numpy(top_w), tpr, tcfg)
        tt, tfetch = tcollab.commit(tt, layer, tpr, staged, tcfg)
        tt, rep, iss, n = tcollab.prefetch(tt, layer + 1,
                                           torch.from_numpy(pred), tcfg,
                                           active=act, rank_votes=rank_votes)
        np.testing.assert_array_equal(tpr.hits.numpy(), np.asarray(jpr.hits))
        np.testing.assert_array_equal(tpr.spec_hits.numpy(),
                                      np.asarray(jpr.spec_hits))
        np.testing.assert_array_equal(tfetch.numpy(), np.asarray(jfetch))
        np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep))
        np.testing.assert_array_equal(iss.numpy(), np.asarray(jiss))
        assert n == int(jn)
        _same_tiers(tt, jt)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)


# -- the engine's pipeline (port alone, reduced Mixtral) ------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mixtral-8x7b"))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _serve(cfg, params, slots=2, n=3, seed=1, **ecfg):
    """Greedy requests through the scheduler; returns (outputs, stats, the
    logits rows every token was chosen from)."""
    ccfg = CacheConfig(num_indexes=cfg.num_layers, num_ways=2, policy="lru")
    engine = CollaborativeEngine(cfg, params, EngineConfig(
        cache=ccfg, max_batch=slots, capacity=64, **ecfg), seed=3)
    sched = ContinuousBatchingScheduler(engine)
    rows = []
    decode = engine.decode_batch

    def decode_batch(tokens, state, active):
        logits, state = decode(tokens, state, active)
        rows.append(logits.clone())
        return logits, state
    engine.decode_batch = decode_batch
    rng = np.random.default_rng(seed)
    for _ in range(n):
        sched.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 9))),
                     max_new_tokens=12)
    outs = sched.run()
    return outs, sched.stats, rows


def test_prefetch_changes_residency_never_logits(setup):
    """The acceptance pair: bitwise equal logits and tokens with prefetch
    on and off, a strictly higher demand hit rate with it on."""
    cfg, params = setup
    out_off, s_off, l_off = _serve(cfg, params, prefetch=False)
    out_on, s_on, l_on = _serve(cfg, params, prefetch=True)
    assert len(l_off) == len(l_on)
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    for rid in out_off:
        np.testing.assert_array_equal(out_on[rid], out_off[rid])
    print(f"\nhit rate {s_on.hit_rate:.4f} with prefetch, {s_off.hit_rate:.4f} "
          f"without; issued={s_on.prefetch_issued} spec_hits="
          f"{s_on.prefetch_hits} wasted={s_on.prefetch_wasted} "
          f"predicted {s_on.predicted_correct}/{s_on.predicted}")
    assert s_on.hit_rate > s_off.hit_rate
    assert s_on.prefetch_issued > 0 and s_on.prefetch_hits > 0
    assert s_off.prefetch_issued == s_off.prefetch_hits == 0
    assert s_off.predicted == 0
    assert s_on.accesses == s_on.hits + s_on.host_assignments
    assert s_on.prefetch_hits <= s_on.hits
    assert 0 < s_on.predicted_correct <= s_on.predicted


def test_confidence_gate_cuts_reservations_never_tokens(setup):
    """prefetch_min_prob gates reservations on the router probability: a
    strict gate predicts less, a gate above every pick probability
    predicts nothing, and the tokens never move."""
    cfg, params = setup
    out_open, s_open, _ = _serve(cfg, params, prefetch=True)
    out_gate, s_gate, _ = _serve(cfg, params, prefetch=True,
                                 prefetch_min_prob=0.35)
    out_shut, s_shut, _ = _serve(cfg, params, prefetch=True,
                                 prefetch_min_prob=0.999)
    for rid in out_open:
        np.testing.assert_array_equal(out_open[rid], out_gate[rid])
        np.testing.assert_array_equal(out_open[rid], out_shut[rid])
    print(f"\npredicted: open {s_open.predicted}, gate 0.35 "
          f"{s_gate.predicted}, gate 0.999 {s_shut.predicted}")
    assert 0 < s_gate.predicted < s_open.predicted
    assert s_gate.prefetch_wasted <= s_open.prefetch_wasted
    assert s_shut.predicted == s_shut.prefetch_issued == 0
    assert s_shut.prefetch_wasted == 0


def test_rank_votes_changes_retention_never_tokens(setup):
    """prefetch_rank_votes stamps reservations with their vote counts:
    the claimed set (issued count) and the predictions are the same, the
    tokens bitwise equal."""
    cfg, params = setup
    out_rv, s_rv, _ = _serve(cfg, params, prefetch=True)
    out_nr, s_nr, _ = _serve(cfg, params, prefetch=True,
                             prefetch_rank_votes=False)
    for rid in out_rv:
        np.testing.assert_array_equal(out_rv[rid], out_nr[rid])
    assert s_rv.prefetch_issued == s_nr.prefetch_issued
    assert s_rv.predicted == s_nr.predicted


def test_scheduler_prefetch_counters_monotone(setup):
    """Counters only grow tick by tick and the rates stay guarded."""
    cfg, params = setup
    ccfg = CacheConfig(num_indexes=cfg.num_layers, num_ways=2, policy="lru")
    sched = ContinuousBatchingScheduler(CollaborativeEngine(
        cfg, params, EngineConfig(cache=ccfg, max_batch=2, capacity=64,
                                  prefetch=True), seed=3))
    s = sched.stats
    assert s.hit_rate == 0.0 and s.prediction_accuracy == 0.0
    assert s.prefetch_waste_rate == 0.0
    rng = np.random.default_rng(0)
    for _ in range(3):
        sched.submit(rng.integers(0, cfg.vocab_size, 6), max_new_tokens=5)
    prev = sched.stats
    while any(sl is not None for sl in sched.slots) or sched.queue:
        sched.step()
        cur = sched.stats
        for k in ("prefetch_issued", "prefetch_hits", "prefetch_wasted",
                  "predicted", "predicted_correct", "hits", "accesses"):
            assert getattr(cur, k) >= getattr(prev, k), k
        prev = cur
    assert prev.prefetch_issued > 0 and prev.predicted > 0
    assert 0.0 <= prev.prediction_accuracy <= 1.0
