"""The port's CPU miss lane (``repro_torch.hostexec`` and
``repro_torch.core.costmodel``) against the reference's
(``repro.hostexec``, ``repro.core.costmodel``), on the CPU.

The cases are those of the reference's ``tests/test_hostexec.py``:
  * the cost-model split and its decision table: equal to the
    reference's, decision for decision;
  * ``dispatch_plan``: the same partition and counts on the same probes;
  * the executor's FFN against the reference's ``host_expert_ffn`` and
    executor on the same numpy inputs (fp32 weights and activations,
    seeded): within 1e-5 relative (``tests/test_hostexec.py:159``'s
    tolerance), with equal census, affinity and fusion counters;
  * the host lane's y against the device lane's at fp32 within 1e-5, and
    its dispatch stats equal to the reference's;
  * ``EngineConfig`` validation and the engine's executor gating.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.core import collaborative as jcollab  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro import hostexec as jhost  # noqa: E402
from repro_torch import hostexec  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.config import CacheConfig, get_config, reduced  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import build, EngineConfig  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


# -- the cost-model split ---------------------------------------------------

def test_paper_timings_equal_reference():
    assert set(costmodel.PAPER_TIMINGS) == set(jcost.PAPER_TIMINGS)
    for name, tm in costmodel.PAPER_TIMINGS.items():
        assert dataclasses.asdict(tm) == dataclasses.asdict(
            jcost.PAPER_TIMINGS[name])
        for threads in (1, 2, 3, 5, 8, 12, 24, 32):
            assert costmodel.cpu_expert_ms(tm, threads) == \
                jcost.cpu_expert_ms(jcost.PAPER_TIMINGS[name], threads)
        assert costmodel.fetch_expert_ms(tm) == jcost.fetch_expert_ms(
            jcost.PAPER_TIMINGS[name])
        assert costmodel.gpu_expert_ms(tm) == jcost.gpu_expert_ms(
            jcost.PAPER_TIMINGS[name])


def test_split_picks_cpu_when_fetch_slower_and_gpu_otherwise():
    tm = dataclasses.replace(
        costmodel.MIXTRAL_TIMINGS, comm_pair_ms=20.0,
        cpu_pair_ms={1: 30.0, 8: 10.0}, act_transfer_ms=0.0, gpu_pair_ms=0.0)
    assert hostexec.HostDispatchPolicy(tm, threads=8).prefers_cpu(1)
    assert not hostexec.HostDispatchPolicy(tm, threads=1).prefers_cpu(1)


@pytest.mark.parametrize("name", sorted(costmodel.PAPER_TIMINGS))
def test_split_on_paper_timings(name):
    """Many threads put a one-token miss on the CPU, one thread keeps the
    fetch; every (threads, tokens) decision equals the reference's."""
    tm = costmodel.PAPER_TIMINGS[name]
    assert hostexec.HostDispatchPolicy(tm, threads=24).prefers_cpu(1)
    assert not hostexec.HostDispatchPolicy(tm, threads=1).prefers_cpu(1)
    for threads in range(1, 33):
        mine = hostexec.HostDispatchPolicy(tm, threads)
        ref = jhost.HostDispatchPolicy(jcost.PAPER_TIMINGS[name], threads)
        np.testing.assert_array_equal(mine.decision_table(16),
                                      ref.decision_table(16))
        assert mine.cpu_ms(3) == ref.cpu_ms(3)
        assert mine.fetch_ms(3) == ref.fetch_ms(3)


def test_decision_table_matches_policy_and_scales_with_tokens():
    """At 8 threads on Mixtral the CPU lane costs 0.11 + 7.88 t ms and the
    fetch lane 14.01 + 0.125 t ms: only one-token groups go to the CPU."""
    pol = hostexec.HostDispatchPolicy(costmodel.MIXTRAL_TIMINGS, threads=8)
    table = pol.decision_table(8)
    assert table.shape == (9,) and table.dtype == bool
    assert not table[0]
    for c in range(9):
        assert table[c] == pol.prefers_cpu(c)
    assert table.tolist() == [False, True] + [False] * 7
    assert pol.cpu_ms(1) == pytest.approx(0.11 + 7.88)
    assert pol.fetch_ms(1) == pytest.approx(14.01 + 0.125)


def test_timings_for_resolves_reduced_arch_names():
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert hostexec.timings_for("mixtral-8x7b") is \
            costmodel.MIXTRAL_TIMINGS
        assert hostexec.timings_for(reduced(get_config("mixtral-8x7b"))
                                    .name) is costmodel.MIXTRAL_TIMINGS
        assert hostexec.timings_for("phi35-moe") is \
            costmodel.PAPER_TIMINGS["phi35-moe"]
    with pytest.warns(UserWarning, match="uncalibrated"):
        assert hostexec.timings_for("unknown-arch") is \
            costmodel.MIXTRAL_TIMINGS


# -- the dispatcher stage ------------------------------------------------------

L, E, D, F = 3, 4, 16, 32


def _weights(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((L, E, D, F), (L, E, D, F), (L, E, F, D))]


def _tiers(seed):
    ws = _weights(seed)
    kw = dict(num_indexes=2, num_ways=2, policy="lru")
    jt = jcollab.init_tiers(*(jnp.asarray(w) for w in ws),
                            JaxCacheConfig(**kw), num_experts=E)
    tt = tcollab.init_tiers(*(tensor_from_numpy(w, "cpu") for w in ws),
                            CacheConfig(**kw), num_experts=E, device="cpu")
    return jt, tt, JaxCacheConfig(**kw), CacheConfig(**kw)


def _steps(seed, n, T=3, K=2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        top_i = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
        yield (int(rng.integers(0, L)), top_i.astype(np.int32),
               rng.random((T, K)).astype(np.float32), rng.random(T) < 0.8,
               rng.standard_normal((T, D)).astype(np.float32),
               rng.integers(0, 2, T * K + 1).astype(bool))


def test_dispatch_plan_partitions_miss_groups_only():
    """The same partition and counts as the reference's dispatch_plan on
    the same probes: resident groups never go to the CPU, padded groups
    never dispatch."""
    jt, tt, jcfg, tcfg = _tiers(0)
    for layer, top_i, top_w, active, x, table in _steps(0, 25):
        table[0] = False
        jpr = jcollab.probe(jt, jnp.int32(layer), jnp.asarray(top_i), jcfg,
                            active=jnp.asarray(active))
        tpr = tcollab.probe(tt, layer, torch.from_numpy(top_i), tcfg,
                            active=torch.from_numpy(active))
        for tab in (table, np.ones_like(table), np.zeros_like(table)):
            jc, jn = jhost.dispatch_plan(jpr, jnp.asarray(tab))
            tc, tn = hostexec.dispatch_plan(tpr, tab)
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            assert not (tc & tpr.resident).any()
            assert not (tc & (tpr.rep_e < 0)).any()
        _, jhost_w = jcollab.execute(jt, jnp.int32(layer), jnp.asarray(x),
                                     jnp.asarray(top_w), jpr, jcfg)
        jt, _ = jcollab.commit(jt, jnp.int32(layer), jpr, jhost_w, jcfg)
        _, st = tcollab.execute(tt, layer, torch.from_numpy(x),
                                torch.from_numpy(top_w), tpr, tcfg)
        tt, _ = tcollab.commit(tt, layer, tpr, st, tcfg)


def test_host_expert_ffn_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    w1 = rng.standard_normal((16, 32)).astype(np.float32)
    w3 = rng.standard_normal((16, 32)).astype(np.float32)
    w2 = rng.standard_normal((32, 16)).astype(np.float32)
    got = hostexec.host_expert_ffn(*(torch.from_numpy(a)
                                     for a in (x, w1, w3, w2)))
    np.testing.assert_allclose(got.numpy(), jhost.host_expert_ffn(
        x, w1, w3, w2), **TOL)


@pytest.mark.parametrize("threads, fuse_small, chunk", [
    (1, 0, 32), (4, 0, 7), (8, 2, 5), (8, 4, 32)])
def test_executor_matches_reference_executor(threads, fuse_small, chunk):
    """compute_groups on the same inputs over a few steps: outputs within
    1e-5 of the reference executor's (the port upcasts ``chunk`` columns
    of d_ff at a time), and every telemetry counter but busy time equal."""
    w1, w3, w2 = _weights(4)
    mine = hostexec.HostExpertExecutor(
        *(torch.from_numpy(w) for w in (w1, w3, w2)), threads=threads,
        fuse_small=fuse_small, chunk=chunk)
    ref = jhost.HostExpertExecutor(w1, w3, w2, threads=threads,
                                   fuse_small=fuse_small)
    rng = np.random.default_rng(5)
    G, A = 5, 6
    for step in range(6):
        rep_e = rng.permutation(E + 1)[:G] - 1
        counts = np.where(rep_e >= 0, rng.integers(1, A + 1, G), 0)
        run = (rep_e >= 0) & (rng.random(G) < 0.8)
        xbuf = rng.standard_normal((G, A, D)).astype(np.float32)
        xbuf *= (np.arange(A)[None, :, None] < counts[:, None, None])
        layer = int(rng.integers(0, L))
        got = mine.compute_groups(layer, torch.from_numpy(rep_e),
                                  torch.from_numpy(run),
                                  torch.from_numpy(xbuf),
                                  torch.from_numpy(counts))
        want = ref.compute_groups(layer, rep_e, run, xbuf, counts)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for k in ("calls", "groups", "fused", "census_calls", "census_threads",
              "affinity_hits", "queue_peak"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert mine.busy_ns > 0
    mine.close()


def test_effective_threads_follows_census_curve():
    w = [torch.from_numpy(a) for a in _weights(5)]
    for threads in (1, 4, 8, 32):
        mine = hostexec.HostExpertExecutor(*w, threads=threads)
        ref = jhost.HostExpertExecutor(*(a.numpy() for a in w),
                                       threads=threads)
        for census in range(0, 60):
            assert mine._effective_threads(census) == \
                ref._effective_threads(census)
        mine.close()
    pool = hostexec.HostExpertExecutor(*w, threads=32)
    assert [pool._effective_threads(c) for c in (0, 5, 9, 12, 24)] == \
        [1, 5, 9, 10, 12]
    pool.close()


def test_host_lane_matches_device_lane_and_reference():
    """dispatch_execute with the thread pool against execute (the device
    lane) at fp32 within 1e-5, and its dispatch stats against the
    reference's dispatch_execute on the same stream; commit after either
    leaves the same cache state and slots."""
    jt, tt, jcfg, tcfg = _tiers(6)
    _, tdev, _, _ = _tiers(6)
    ex = hostexec.HostExpertExecutor(*tt.host, threads=4, fuse_small=1)
    for layer, top_i, top_w, active, x, table in _steps(6, 25):
        table[0] = False
        act = torch.from_numpy(active)
        jpr = jcollab.probe(jt, jnp.int32(layer), jnp.asarray(top_i), jcfg,
                            active=jnp.asarray(active))
        _, jhost_w, jstats = jhost.dispatch_execute(
            jt, jnp.int32(layer), jnp.asarray(x), jnp.asarray(top_w), jpr,
            jcfg, jnp.asarray(table), fuse_small=1)
        jt, _ = jcollab.commit(jt, jnp.int32(layer), jpr, jhost_w, jcfg)
        tpr = tcollab.probe(tt, layer, torch.from_numpy(top_i), tcfg,
                            active=act)
        y, st, dstats = hostexec.dispatch_execute(
            tt, layer, torch.from_numpy(x), torch.from_numpy(top_w), tpr,
            tcfg, table, ex, fuse_small=1)
        tt, fetch = tcollab.commit(tt, layer, tpr, st, tcfg)
        dpr = tcollab.probe(tdev, layer, torch.from_numpy(top_i), tcfg,
                            active=act)
        y_dev, st_dev = tcollab.execute(tdev, layer, torch.from_numpy(x),
                                        torch.from_numpy(top_w), dpr, tcfg)
        tdev, fetch_dev = tcollab.commit(tdev, layer, dpr, st_dev, tcfg)
        np.testing.assert_allclose(y.numpy(), y_dev.numpy(), **TOL)
        assert torch.equal(fetch, fetch_dev)
        for k, v in jstats.items():
            assert dstats[k] == int(v), k
        for a, b in zip(tt.slots + (tt.state.tags, tt.state.age),
                        tdev.slots + (tdev.state.tags, tdev.state.age)):
            assert torch.equal(a, b)
    assert ex.calls > 0 and ex.groups > 0
    ex.close()


def test_collaborative_moe_offloaded_matches_collaborative_moe():
    """Every non-resident group on the host executor: y within 1e-5 of the
    all-device composition; stats, cache state and slots equal."""
    _, tt, _, tcfg = _tiers(7)
    _, tref, _, _ = _tiers(7)
    ex = hostexec.HostExpertExecutor(*tt.host, threads=2)
    for layer, top_i, top_w, active, x, _ in _steps(7, 20):
        args = (layer, torch.from_numpy(x), torch.from_numpy(top_i),
                torch.from_numpy(top_w), tcfg)
        pr = tcollab.probe(tt, layer, torch.from_numpy(top_i), tcfg,
                           active=torch.from_numpy(active))
        misses = int((~pr.resident & (pr.rep_e >= 0)).sum())
        ran = ex.groups
        y, tt, s = tcollab.collaborative_moe_offloaded(
            tt, *args, ex, active=torch.from_numpy(active))
        y_ref, tref, s_ref = tcollab.collaborative_moe(
            tref, *args, active=torch.from_numpy(active))
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
        assert s == s_ref
        assert ex.groups - ran == misses    # the pool ran every miss
        for a, b in zip(tt.slots + (tt.state.tags,),
                        tref.slots + (tref.state.tags,)):
            assert torch.equal(a, b)
    assert ex.groups > 0
    ex.close()


# -- the engine -----------------------------------------------------------------

def test_engine_config_validation():
    ccfg = CacheConfig(num_indexes=2, num_ways=2)
    with pytest.raises(ValueError, match="host_threads"):
        EngineConfig(cache=ccfg, host_threads=0)
    with pytest.raises(ValueError, match="host_backend"):
        EngineConfig(cache=ccfg, host_backend="cuda")
    with pytest.raises(ValueError, match="prefetch_min_prob"):
        EngineConfig(cache=ccfg, prefetch_min_prob=1.5)
    with pytest.raises(ValueError, match="host_fuse_small"):
        EngineConfig(cache=ccfg, host_fuse_small=-1)
    with pytest.raises(NotImplementedError, match="no PyTorch meaning"):
        EngineConfig(cache=ccfg, host_compute=True, host_backend="jax")
    EngineConfig(cache=ccfg, prefetch=True, prefetch_min_prob=0.3,
                 host_compute=True, host_threads=4, host_fuse_small=2)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mixtral-8x7b"))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _run(cfg, params, **serving):
    engine, sched = build(cfg, serving=dict(max_batch=2, capacity=64,
                                            **serving),
                          seed=0, params=params, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        sched.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 9))),
                     max_new_tokens=8)
    return sched.run(), sched.stats, engine


def test_host_compute_serving_counts(setup):
    """The thread-pool lane end to end: valid tokens, the executor ran
    what the channel counts, the census fields come from it, and the
    channel stays zero with the lane off."""
    cfg, params = setup
    outs_off, s_off, _ = _run(cfg, params)
    outs, s, eng = _run(cfg, params, host_compute=True, host_threads=8)
    assert s.cpu_expert_calls > 0
    assert eng.host_executor is not None
    assert eng.host_executor.groups == s.cpu_expert_calls
    assert s.cpu_tokens >= s.cpu_expert_calls
    assert s.cpu_tokens <= s.host_assignments
    assert s.miss_expert_groups >= s.cpu_expert_calls
    assert s.fused_groups == s.cpu_expert_calls   # one-token groups, fuse 4
    assert 0.0 < s.cpu_offload_rate <= 1.0
    assert s.census_calls == eng.host_executor.census_calls
    assert s.host_busy_us == eng.host_executor.busy_ns // 1000
    same = sum(int(np.sum(outs[r] == outs_off[r])) for r in outs)
    print(f"\nhost lane tokens equal to the device lane's: {same}/"
          f"{sum(len(o) for o in outs.values())}")
    for toks in outs.values():
        assert len(toks) == 8
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert s_off.cpu_expert_calls == s_off.cpu_tokens == 0
    assert s_off.miss_expert_groups == 0
    eng.host_executor.close()


def test_single_thread_cost_model_keeps_misses_on_gpu(setup):
    """One thread: the paper's timings keep every miss on the fetch lane,
    so no executor is built and nothing dispatches."""
    cfg, params = setup
    _, s, eng = _run(cfg, params, host_compute=True, host_threads=1)
    assert not eng.dispatch_policy.prefers_cpu(1)
    assert eng.host_executor is None
    assert s.cpu_expert_calls == s.cpu_tokens == 0
    assert s.miss_expert_groups > 0


def test_serve_cli_prefetch_and_host_lane_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--device", "cpu", "--tokens", "4", "--prompt", "6",
                    "--requests", "3", "--concurrency", "2", "--indexes",
                    "2", "--prefetch", "--host-compute", "--host-threads",
                    "4", "--host-fuse-small", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert "prefetch: issued=" in out and "host execution:" in out
    assert "host_compute(callback, 4t)" in out


def test_pool_stress_outputs_equal_single_thread():
    """More workers than groups' worth of cores, a short switch interval:
    the pool's disjoint row writes and its locked busy-time sum survive
    the interleaving; outputs equal the one-thread lane bitwise, and
    every dispatch is counted."""
    import sys
    w = [torch.from_numpy(a) for a in _weights(9)]
    pool = hostexec.HostExpertExecutor(*w, threads=16, chunk=8)
    solo = hostexec.HostExpertExecutor(*w, threads=1, chunk=8)
    rng = np.random.default_rng(9)
    G, A = 12, 3
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(5):
            rep_e = rng.integers(0, E, G)
            xbuf = torch.from_numpy(
                rng.standard_normal((G, A, D)).astype(np.float32))
            run = torch.ones(G, dtype=torch.bool)
            got = pool.compute_groups(step % L, rep_e, run, xbuf)
            assert torch.equal(got, solo.compute_groups(step % L, rep_e,
                                                         run, xbuf))
    finally:
        sys.setswitchinterval(interval)
    assert pool.calls == 5 and pool.groups == 5 * G
    assert pool.census_calls == 5 and pool.busy_ns > 0
    pool.close()
