"""The paper's offline tooling in the port against the reference's: router
traces, the numpy cache twin, the closed forms, the cache sizing, the
discrete-event simulator, the EP-cache planner, the host-side cache's
``access`` and seed oracle, trace capture from a live model, and the
sequential MoE oracle.

Everything numpy is held EXACTLY equal to the reference from the same
seeds (traces bit for bit, every statistic, every field of every
simulator result, cache states and counters). The torch cache operations
are held to the reference's and to the port's numpy twin on hypothesis'
random traces. Captured picks must be equal, a difference only at a
printed near tie of the router. The sequential oracle is exact in its
integer state and within 1e-5 in y at fp32 (sums of D = 16 or 32 terms
in another order).
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.config as jconfig  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import collaborative as jcollab  # noqa: E402
from repro.core import ep_cache as jep  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import router_trace as jrt  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.costmodel import PAPER_TIMINGS as JTIMINGS  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
import repro_torch.config as tconfig  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                tensor_from_numpy)
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import ep_cache as tep  # noqa: E402
from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core import router_trace as trt  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(2)

ROUTE_TIE = 0.01          # as tests/test_torch_serving.py
MODELS = ("mixtral-8x7b", "phi35-moe")


def _tc(module, **kw):
    return module.TraceConfig(**kw)


@pytest.fixture(scope="module")
def traces():
    """The 800 x 32 traces of tests/test_simulator.py, one per paper model
    (E = 8 and 16), from both packages."""
    out = {}
    for name in MODELS:
        E = JTIMINGS[name].num_experts
        kw = dict(num_tokens=800, num_layers=32, num_experts=E)
        out[name] = (jrt.synthetic_trace(_tc(jrt, **kw)),
                     trt.synthetic_trace(_tc(trt, **kw)))
    return out


# -- traces ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_tokens=64, num_layers=4, num_experts=8),
    dict(num_tokens=50, num_layers=6, num_experts=16, top_k=4, seed=3),
    dict(num_tokens=40, num_layers=3, num_experts=128, top_k=8,
         stickiness=0.3, zipf_s=0.8, layer_corr=0.5, seed=9)])
def test_synthetic_trace_and_stats_equal(kw):
    j = jrt.synthetic_trace(_tc(jrt, **kw))
    t = trt.synthetic_trace(_tc(trt, **kw))
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)
    assert trt.trace_stats(t) == jrt.trace_stats(j)


def test_paper_traces_equal_bit_for_bit(traces):
    for name, (j, t) in traces.items():
        np.testing.assert_array_equal(t, j)
        assert trt.trace_stats(t) == jrt.trace_stats(j), name


# -- the numpy twin and the closed forms --------------------------------------

@pytest.mark.parametrize("policy", ["lru", "fifo", "random"])
def test_numpy_cache_equal_with_reservations(traces, policy):
    """Demand accesses with reservations and landings between them, as the
    simulator's ours_prefetch drives them: every counter and the state."""
    trace = traces["mixtral-8x7b"][0][:120]
    rng = np.random.default_rng(5)
    caches = [mod.NumpyCache(mod_cfg.CacheConfig(num_indexes=20, num_ways=3,
                                                 policy=policy),
                             num_experts=8, seed=4)
              for mod, mod_cfg in ((jpol, jconfig), (tpol, tconfig))]
    for t in range(trace.shape[0]):
        for layer in range(trace.shape[1]):
            picks = [int(e) for e in trace[t, layer]]
            outs = [c.access(layer, picks) for c in caches]
            assert outs[0] == outs[1]
            pred = [int(e) for e in rng.integers(-1, 8, 2)]
            prio = [int(p) for p in rng.integers(0, 3, 2)]
            outs = [c.reserve(layer + 1, pred, priority=prio) for c in caches]
            assert outs[0] == outs[1]
            if rng.random() < 0.5:
                for c in caches:
                    c.land()
    j, tc = caches
    for name in ("tags", "age", "flags"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(j, name))
    for name in ("clock", "hits", "accesses", "spec_hits", "reserved",
                 "hit_rate"):
        assert getattr(tc, name) == getattr(j, name), name


@pytest.mark.parametrize("n,m", [(8, 1), (8, 2), (8, 4), (16, 3), (128, 8)])
def test_random_policy_hit_probs_equal(n, m):
    assert tpol.random_policy_hit_probs(n, m) == \
        jpol.random_policy_hit_probs(n, m)


def test_config_sizing_and_registry_equal():
    assert tconfig.list_archs() == jconfig.list_archs()
    for arch in jconfig.list_archs():
        j, t = jconfig.get_config(arch), tconfig.get_config(arch)
        assert t.attn_free == j.attn_free, arch
        assert t.sub_quadratic == j.sub_quadratic, arch
        for bpp in (1, 2, 4):
            assert t.expert_bytes(bpp) == j.expert_bytes(bpp), arch
        if j.moe is None:
            continue
        for mem in (1 << 30, 19 << 30, 80 << 30):
            for ways in (1, 2, 4, 8):
                kw = dict(max_layers=j.num_layers, policy="fifo")
                try:
                    jc = jconfig.CacheConfig.from_memory(
                        mem, j.expert_bytes(), ways, **kw)
                except ValueError:
                    with pytest.raises(ValueError, match="too small"):
                        tconfig.CacheConfig.from_memory(
                            mem, t.expert_bytes(), ways, **kw)
                    continue
                tc = tconfig.CacheConfig.from_memory(
                    mem, t.expert_bytes(), ways, **kw)
                assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tconfig.base.FFNKind == jconfig.base.FFNKind


def test_paper_constants_equal():
    from repro.core import costmodel as jcost
    assert tcost.PREGATED_POWER_W == jcost.PREGATED_POWER_W
    assert tcost.PCIE_BW_GBPS == jcost.PCIE_BW_GBPS
    assert tcost.PREFETCH_PREDICTOR_ACCURACY == \
        jcost.PREFETCH_PREDICTOR_ACCURACY
    assert tsim.FIDDLER_OVERHEAD_MS == jsim.FIDDLER_OVERHEAD_MS
    for name in MODELS:
        assert dataclasses.asdict(tcost.PAPER_TIMINGS[name]) == \
            dataclasses.asdict(JTIMINGS[name])


# -- the simulator ------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_simulate_every_method_equal(traces, name):
    """Every field of SimResult for every method at 1, 12 and 24 threads
    (12: interpolated between the paper's measured counts); the cached
    methods at each candidate geometry at 24 threads."""
    jtr, ttr = traces[name]
    jt, tt = JTIMINGS[name], tcost.PAPER_TIMINGS[name]
    jb, tb = jsim.best_cache_config(jt), tsim.best_cache_config(tt)
    assert {m: dataclasses.asdict(c) for m, c in tb.items()} == \
        {m: dataclasses.asdict(c) for m, c in jb.items()}
    runs = [(m, th, 4) for m in ("ours", "ours_prefetch", "cpu_only",
                                 "on_demand", "pregated", "fiddler")
            for th in (1, 12, 24)]
    runs += [(m, 24, w) for m in ("ours", "ours_prefetch", "fiddler")
             for w in tb if w != 4]
    cut = {"ours": 400, "ours_prefetch": 300}    # test_simulator.py's
    for method, threads, ways in runs:
        tr, jr = ttr[:cut.get(method)], jtr[:cut.get(method)]
        got = tsim.simulate(tr, tt, threads, method, ccfg=tb[ways])
        want = jsim.simulate(jr, jt, threads, method, ccfg=jb[ways])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (method, threads, ways)
    got = tsim.simulate(ttr[:50], tt, 8, "fiddler")
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jsim.simulate(jtr[:50], jt, 8, "fiddler"))
    with pytest.raises(ValueError):
        tsim.simulate(ttr[:2], tt, 8, "nonsense")


@pytest.mark.parametrize("mem_gb,ways", [(19.0, (2, 4, 8)), (4.0, (1, 2)),
                                         (64.0, (8, 16, 32))])
def test_best_cache_config_equal(mem_gb, ways):
    for name in MODELS:
        got = tsim.best_cache_config(tcost.PAPER_TIMINGS[name], mem_gb, ways)
        want = jsim.best_cache_config(JTIMINGS[name], mem_gb, ways)
        assert {m: dataclasses.asdict(c) for m, c in got.items()} == \
            {m: dataclasses.asdict(c) for m, c in want.items()}


# -- the EP-cache planner -----------------------------------------------------

def _plan_equal(got, want):
    np.testing.assert_array_equal(got.hot_experts, want.hot_experts)
    for k in ("local_fraction", "a2a_bytes_baseline", "a2a_bytes_with_cache",
              "refresh_bytes", "traffic_ratio"):
        assert getattr(got, k) == getattr(want, k), k


def test_ep_cache_plans_and_traffic_equal(traces):
    rng = np.random.default_rng(3)
    e = np.arange(16)
    np.testing.assert_array_equal(tep.home_shard(e, 16, 4),
                                  jep.home_shard(e, 16, 4))
    prev_t = prev_j = None
    for _ in range(4):
        counts = rng.integers(0, 50, (3, 16))
        got = tep.plan_replication(counts, 4, 2, 1000, 64, prev_hot=prev_t)
        want = jep.plan_replication(counts, 4, 2, 1000, 64, prev_hot=prev_j)
        _plan_equal(got, want)
        prev_t, prev_j = got.hot_experts, want.hot_experts
    jtr, ttr = traces["phi35-moe"]
    for ep, m_hot, every in ((4, 2, 1), (8, 1, 5), (2, 4, 16)):
        assert tep.simulate_ep_cache(ttr[:200], ep, m_hot, 10 ** 6, 8192,
                                     every) == \
            jep.simulate_ep_cache(jtr[:200], ep, m_hot, 10 ** 6, 8192, every)


# -- the host-side cache against the numpy twin and the reference ------------

@st.composite
def trace_and_geometry(draw):
    n = draw(st.integers(1, 4))
    m = draw(st.integers(1, 4))
    e = draw(st.integers(max(m, 2), 10))
    layers = draw(st.integers(1, 6))        # may exceed n (coverage misses)
    steps = draw(st.lists(
        st.tuples(st.integers(0, layers - 1),
                  st.lists(st.integers(-1, e - 1), min_size=1, max_size=4)),
        min_size=1, max_size=10))
    return n, m, e, steps


@given(trace_and_geometry(), st.sampled_from(["lru", "fifo", "random"]))
@settings(max_examples=10, deadline=None, database=None, derandomize=True)
def test_access_equals_numpy_twin_and_reference(tg, policy):
    """The port's ``access`` and ``access_scan_reference`` against its
    numpy twin and the reference's ``access`` / ``access_scan_reference``
    on flag-free states: hits, ways and the whole state after each call
    (the static policy's placement copied from the twin). The twin's
    clock counts only covered, unmasked picks where the others count every
    pick: the ages' order, and so every eviction, is the same."""
    n, m, e, steps = tg
    tcfg = tconfig.CacheConfig(num_indexes=n, num_ways=m, policy=policy)
    jcfg = jconfig.CacheConfig(num_indexes=n, num_ways=m, policy=policy)
    twin = tpol.NumpyCache(tcfg, num_experts=e, seed=1)
    ts = tcache.init_cache_state(tcfg, e, torch.Generator().manual_seed(0))
    ts = ts._replace(tags=torch.from_numpy(twin.tags).to(torch.int32))
    tsr = ts
    js = jsr = jcache.CacheState(jnp.asarray(twin.tags, jnp.int32),
                                 jnp.zeros((n, m), jnp.int32),
                                 jnp.zeros((), jnp.int32),
                                 jnp.zeros((n, m), jnp.int32))
    for layer, experts in steps:
        ex = torch.tensor(experts, dtype=torch.int32)
        ts, th, tw = tcache.access(ts, layer, ex, policy)
        tsr, trh, trw = tcache.access_scan_reference(tsr, layer, ex, policy)
        js, jh, jw = jcache.access(js, jnp.int32(layer),
                                   jnp.asarray(experts, jnp.int32), policy)
        jsr, jrh, jrw = jcache.access_scan_reference(
            jsr, jnp.int32(layer), jnp.asarray(experts, jnp.int32), policy)
        nh = twin.access(layer, experts)
        assert th.tolist() == nh == list(np.asarray(jh))
        assert trh.tolist() == th.tolist() == list(np.asarray(jrh))
        assert tw.tolist() == list(np.asarray(jw))
        assert trw.tolist() == tw.tolist() == list(np.asarray(jrw))
        for a, b, c in ((ts, js, tsr), (tsr, jsr, ts)):
            for name in ("tags", "age", "clock", "in_flight"):
                np.testing.assert_array_equal(getattr(a, name).numpy(),
                                              np.asarray(getattr(b, name)))
                assert torch.equal(getattr(a, name), getattr(c, name))
        np.testing.assert_array_equal(ts.tags.numpy(), twin.tags)


# -- trace capture from a live model ------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b"])
def test_capture_trace_equal(arch, monkeypatch):
    """Teacher-forced capture on the reduced config from the same weights:
    equal picks; a pick that differs only at a near tie of the port's
    router (any routing of the tokens up to it, in a layer up to it) is
    reported with its gap."""
    jcfg = jconfig.reduced(jconfig.get_config(arch))
    tcfg = tconfig.reduced(tconfig.get_config(arch))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    S = 16
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, S))
    want = jrt.capture_trace(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    gaps = []
    route = tmoe.route

    def recording_route(w, x, k):
        probs, top_i, top_w = route(w, x, k)
        srt = torch.sort(probs, dim=-1, descending=True).values
        gaps.append((srt[:, k - 1] - srt[:, k])[:S].numpy())
        return probs, top_i, top_w
    monkeypatch.setattr(tmoe, "route", recording_route)
    got = trt.capture_trace(tcfg, tparams, tokens)
    n_moe = sum(tcfg.is_moe_layer(i) for i in range(tcfg.num_layers))
    assert got.shape == want.shape == (S, n_moe, tcfg.moe.top_k)
    assert got.dtype == np.int64
    diff = np.argwhere((got != want).any(-1))
    same = int((got == want).all(-1).sum())
    print(f"\n{arch}: {same}/{S * n_moe} (token, layer) picks equal")
    if diff.size:
        s, l = (int(v) for v in diff[0])
        # two route calls per MoE layer (the recorded one, the layer's own)
        low = float(np.min(np.stack(gaps[:2 * (l + 1)])[:, :s + 1]))
        print(f"{arch}: first differing pick at token {s}, MoE layer {l}; "
              f"smallest router gap up to it {low:.5f}")
        assert low < ROUTE_TIE


# -- the sequential oracle ----------------------------------------------------

L, E, D, F, T, K = 3, 6, 32, 48, 2, 2


def _tier_pair(policy, rng):
    w = [rng.standard_normal(s).astype(np.float32) * 0.1
         for s in ((L, E, D, F), (L, E, D, F), (L, E, F, D))]
    jcfg = jconfig.CacheConfig(num_indexes=2, num_ways=2, policy=policy)
    tcfg = tconfig.CacheConfig(num_indexes=2, num_ways=2, policy=policy)
    jt = jcollab.init_tiers(*(jnp.asarray(a) for a in w), jcfg,
                            num_experts=E, key=jax.random.PRNGKey(7))

    def port_tiers():
        tt = tcollab.init_tiers(*(tensor_from_numpy(a, "cpu") for a in w),
                                tcfg, num_experts=E,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
        # the static placement: the reference's, slots and all
        for slot, jslot in zip(tt.slots, (jt.slot_w1, jt.slot_w3,
                                          jt.slot_w2)):
            slot.copy_(torch.from_numpy(np.array(jslot)))
        return tt._replace(state=tt.state._replace(
            tags=torch.from_numpy(np.array(jt.state.tags))))
    return jt, port_tiers, jcfg, tcfg


def _dup_free(rng):
    return rng.permutation(E)[:T * K].reshape(T, K).astype(np.int32)


@pytest.mark.parametrize("policy", ["lru", "fifo", "random"])
def test_collaborative_moe_reference_matches_reference_oracle(policy):
    rng = np.random.default_rng(11)
    jt, port_tiers, jcfg, tcfg = _tier_pair(policy, rng)
    tt = port_tiers()
    x = rng.standard_normal((T, D)).astype(np.float32)
    tw = np.asarray([[0.6, 0.4], [0.5, 0.5]], np.float32)
    scan_ref = jax.jit(jcache.access_scan_reference,
                       static_argnames="policy")
    oracle = jax.jit(jcollab.collaborative_moe_reference,
                     static_argnames="ccfg")
    for layer in (0, 1, 2):
        for rep in range(3):
            ti = _dup_free(rng)
            _, jh, jw = scan_ref(
                jt.state, jnp.int32(layer), jnp.asarray(ti.reshape(-1)),
                policy=policy)
            _, th, tw_ = tcache.access_scan_reference(
                tt.state, layer, torch.from_numpy(ti.reshape(-1)), policy)
            assert th.tolist() == list(np.asarray(jh))
            assert tw_.tolist() == list(np.asarray(jw))
            jy, jt, js = oracle(
                jt, jnp.int32(layer), jnp.asarray(x), jnp.asarray(ti),
                jnp.asarray(tw), ccfg=jcfg)
            ty, tt, ts = tcollab.collaborative_moe_reference(
                tt, layer, torch.from_numpy(x), torch.from_numpy(ti),
                torch.from_numpy(tw), tcfg)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       rtol=1e-5, atol=1e-5)
            assert ts == {k: int(v) for k, v in js.items()}, (layer, rep)
            for name in ("tags", "age", "clock", "in_flight"):
                np.testing.assert_array_equal(
                    getattr(tt.state, name).numpy(),
                    np.asarray(getattr(jt.state, name)))
            for slot, jslot in zip(tt.slots, (jt.slot_w1, jt.slot_w3,
                                              jt.slot_w2)):
                np.testing.assert_array_equal(slot.numpy(),
                                              np.asarray(jslot))


@pytest.mark.parametrize("policy", ["lru", "fifo", "random"])
def test_grouped_path_matches_sequential_oracle(policy):
    """The port's probe -> execute -> commit against its own oracle on
    dup-free picks across cold, warm and uncovered layers (the reference's
    tests/test_collaborative.py:128-159): y within 1e-5, the demand
    counters and the cache tags exact, the slot buffers equal, and no more
    fetches than the oracle's (it also copies within-step evictions)."""
    rng = np.random.default_rng(0)
    _, port_tiers, _, tcfg = _tier_pair(policy, rng)
    tg, tr = port_tiers(), port_tiers()
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    tw = torch.tensor([[0.6, 0.4], [0.5, 0.5]])
    for layer in (0, 1, 2):
        for rep in range(3):
            ti = torch.from_numpy(_dup_free(rng))
            yg, tg, sg = tcollab.collaborative_moe(tg, layer, x, ti, tw, tcfg)
            yr, tr, sr = tcollab.collaborative_moe_reference(
                tr, layer, x, ti, tw, tcfg)
            np.testing.assert_allclose(yg.numpy(), yr.numpy(), rtol=1e-5,
                                       atol=1e-5)
            for k in ("hits", "accesses", "host_flops_assignments"):
                assert sg[k] == sr[k], (k, layer, rep)
            assert sg["fetched_experts"] <= sr["fetched_experts"]
            assert torch.equal(tg.slot_w1, tr.slot_w1)
            assert torch.equal(tg.state.tags, tr.state.tags)


def test_oracle_reads_the_stale_slot_on_duplicate_cold_picks():
    """The inherited limitation, mirrored: two tokens picking one cold
    expert; the oracle reports the second pick a hit and computes it from
    the still-empty slot (zeros), where the grouped path reads the host
    tier."""
    rng = np.random.default_rng(1)
    _, port_tiers, _, tcfg = _tier_pair("lru", rng)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    ti = torch.tensor([[0, 1], [0, 2]], dtype=torch.int32)
    tw = torch.tensor([[0.6, 0.4], [0.5, 0.5]])
    yr, _, sr = tcollab.collaborative_moe_reference(port_tiers(), 0, x, ti,
                                                    tw, tcfg)
    yg, _, sg = tcollab.collaborative_moe(port_tiers(), 0, x, ti, tw, tcfg)
    assert sr["hits"] == sg["hits"] == 1
    np.testing.assert_allclose(yr[0].numpy(), yg[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(yr[1].numpy(), yg[1].numpy(), atol=1e-3)
