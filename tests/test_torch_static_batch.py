"""The engine's static-batch path (``prefill``, ``prefill_request``,
``generate``) against the reference's, on the reduced Mixtral.

Both packages build the model from the SAME weights (the reference's
``init_params``, carried over by ``repro_torch.bridge``) and generate 16
greedy tokens for 4 prompts of 8 tokens, with the cache covering both
layers (N = 2, M = 2, lru), with prefetch off and on. The port runs on the
CPU (its kernels' plain versions).

What must agree, and how (the reasons are ``test_torch_serving.py``'s):
greedy tokens, a divergence only at a near tie (the reference's logit gap
below ``NEAR_TIE`` or the port's router gap below ``ROUTE_TIE`` at a
decode step before it), printed; the counters that do not depend on
routing exactly; the cache's integer state and the routing-dependent
counters by replaying the port's probes and prefetches through the
reference's stages, exactly (and equal to the reference's own run where
every token agreed). Then the reference's own engine tests
(``tests/test_serving_engine.py``) on the port's engine, the first token
of ``prefill_request`` with and without warming and the seeded-sampling
contract (the refusal under ``kv_paged`` is
``test_torch_paged_serving.py::test_dense_only_paths_refuse_paged``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.core import collaborative as jcollab  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import CollaborativeEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import CacheConfig, get_config, reduced  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.serving import CollaborativeEngine, EngineConfig  # noqa: E402
from repro_torch.serving import SamplingParams  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from test_torch_serving import NEAR_TIE, ROUTE_TIE  # noqa: E402

torch.set_num_threads(2)

B, PROMPT, STEPS, CAPACITY = 4, 8, 16, 64
CACHE = dict(num_indexes=2, num_ways=2, policy="lru")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return dict(jcfg=jcfg, jparams=jparams,
                tcfg=reduced(get_config("mixtral-8x7b")), tparams=tparams,
                prompts=prompts)


def _engine(models, cache=CACHE, **serving):
    ecfg = EngineConfig(cache=CacheConfig(**cache), capacity=CAPACITY,
                        **serving)
    return CollaborativeEngine(models["tcfg"], models["tparams"], ecfg,
                               seed=3)


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "prefetch"])
def runs(request, models):
    prefetch = request.param
    mp = pytest.MonkeyPatch()
    je = JaxEngine(models["jcfg"], models["jparams"], JaxEngineConfig(
        cache=JaxCacheConfig(**CACHE), capacity=CAPACITY,
        prefetch=prefetch), key=jax.random.PRNGKey(3))
    jrows = []
    jselect = je.select_tokens

    def recording_select(logits, *a, **k):
        jrows.append(np.asarray(logits, np.float32))
        return jselect(logits, *a, **k)
    mp.setattr(je, "select_tokens", recording_select)
    jout, jstats = je.generate(models["prompts"], STEPS)

    te = _engine(models, prefetch=prefetch)
    ops, gaps, step, predicting = [], [], [], [False]
    probe, prefetch_fn = tcollab.probe, tcollab.prefetch
    route, decode, predict = tengine.route, te._decode_step, te._predict

    def recording_probe(tiers, layer, top_i, ccfg, active=None):
        pr = probe(tiers, layer, top_i, ccfg, active=active)
        ops.append(("probe", layer, top_i.to("cpu").numpy().copy(),
                    torch.as_tensor(active).numpy().copy(), pr.state))
        return pr

    def recording_prefetch(tiers, layer, pred_i, ccfg, active=None,
                           rank_votes=False):
        out = prefetch_fn(tiers, layer, pred_i, ccfg, active=active,
                          rank_votes=rank_votes)
        ops.append(("prefetch", layer, pred_i.numpy().copy(),
                    torch.as_tensor(active).numpy().copy(), out[0].state,
                    rank_votes))
        return out

    def recording_route(w, x, k):
        probs, top_i, top_w = route(w, x, k)
        if not predicting[0]:
            srt = torch.sort(probs, dim=-1, descending=True).values
            step.append((srt[:, k - 1] - srt[:, k]).numpy())
        return probs, top_i, top_w

    def flagged_predict(*a, **k):
        predicting[0] = True
        try:
            return predict(*a, **k)
        finally:
            predicting[0] = False

    def recording_decode(*a, **k):
        step.clear()
        out = decode(*a, **k)
        gaps.append(np.min(np.stack(step), axis=0))
        return out
    mp.setattr(tcollab, "probe", recording_probe)
    mp.setattr(tcollab, "prefetch", recording_prefetch)
    mp.setattr(tengine, "route", recording_route)
    mp.setattr(te, "_predict", flagged_predict)
    mp.setattr(te, "_decode_step", recording_decode)
    tout, tstats = te.generate(models["prompts"], STEPS)
    mp.undo()
    return dict(prefetch=prefetch, jout=jout, jstats=jstats, jrows=jrows,
                tout=tout, tstats=tstats, ops=ops,
                gaps=np.stack(gaps, 1))              # [B, STEPS - 1]


def _first_divergence(runs):
    """Per row: None, or (token index, reference logit gap, smallest
    port router gap at the decode steps before it)."""
    out = []
    for r in range(B):
        diff = np.nonzero(runs["jout"][r] != runs["tout"][r])[0]
        if diff.size == 0:
            out.append(None)
            continue
        s = int(diff[0])
        ref = runs["jrows"][s][r]
        gap = float(ref[runs["jout"][r, s]] - ref[runs["tout"][r, s]])
        out.append((s, gap, float(np.min(runs["gaps"][r, :s],
                                         initial=np.inf))))
    return out


def test_generate_greedy_tokens_match_reference(runs):
    jout, tout = runs["jout"], runs["tout"]
    assert tout.shape == jout.shape == (B, STEPS)
    assert tout.dtype == np.int32
    same = int((jout == tout).sum())
    print(f"\nprefetch={runs['prefetch']}: greedy token agreement "
          f"{same}/{jout.size} = {same / jout.size:.4f}")
    for r, div in enumerate(_first_divergence(runs)):
        if div is None:
            continue
        s, gap, route_gap = div
        print(f"row {r}: first differing token {s}, reference logit gap "
              f"{gap:.4f}, smallest router gap before it {route_gap:.4f}")
        assert gap <= NEAR_TIE or route_gap < ROUTE_TIE, (
            f"row {r} diverges at token {s} with no near tie")


def _replay(runs):
    """The port's probes and prefetches, in order, through the reference's
    stages; checks the cache state after each; returns the counters."""
    cfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    L, E = cfg.num_layers, cfg.moe.num_experts
    ccfg = JaxCacheConfig(**CACHE)
    w = jnp.zeros((L, E, 1, 1), jnp.float32)
    tiers = jcollab.init_tiers(w, w, w, ccfg, num_experts=E)
    c = dict.fromkeys(("hits", "fetched_experts", "host_assignments",
                       "prefetch_issued", "prefetch_hits"), 0)
    for i, (kind, layer, picks, active, state, *rest) in enumerate(
            runs["ops"]):
        if kind == "probe":
            pr = jcollab.probe(tiers, jnp.int32(layer), jnp.asarray(picks),
                               ccfg, active=jnp.asarray(active))
            _, host_w = jcollab.execute(
                tiers, jnp.int32(layer), jnp.zeros((picks.shape[0], 1)),
                jnp.zeros(picks.shape, jnp.float32), pr, ccfg)
            tiers, fetch = jcollab.commit(tiers, jnp.int32(layer), pr,
                                          host_w, ccfg)
            st = pr.state
            c["hits"] += int(pr.hits.sum())
            c["fetched_experts"] += int(fetch.sum())
            c["host_assignments"] += int((pr.valid & ~pr.hits).sum())
            c["prefetch_hits"] += int(pr.spec_hits.sum())
        else:
            tiers, _, _, n = jcollab.prefetch(
                tiers, jnp.int32(layer), jnp.asarray(picks), ccfg,
                active=jnp.asarray(active), rank_votes=rest[0])
            st = tiers.state
            c["prefetch_issued"] += int(n)
        for name in ("tags", "age", "clock", "in_flight"):
            np.testing.assert_array_equal(
                getattr(state, name).numpy(), np.asarray(getattr(st, name)),
                err_msg=f"{name} after op {i} ({kind}, layer {layer})")
    return c


def test_generate_counters_match_reference(runs):
    js, ts = runs["jstats"], runs["tstats"]
    cfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    for name in ("accesses", "first_tokens", "tokens", "steps",
                 "generated_tokens", "per_layer_accesses"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.first_tokens == B and ts.tokens == B * (STEPS - 1)
    assert ts.accesses == ts.tokens * cfg.moe.top_k * cfg.num_layers
    got = _replay(runs)
    print(f"\nprefetch={runs['prefetch']}: port " + ", ".join(
        f"{k}={getattr(ts, k)}" for k in got) + "; reference run " +
        ", ".join(f"{k}={getattr(js, k)}" for k in got))
    for k, v in got.items():
        assert getattr(ts, k) == v, k
    assert (ts.prefetch_issued > 0) == runs["prefetch"]
    if np.array_equal(runs["jout"], runs["tout"]):
        for k in got:
            assert getattr(ts, k) == getattr(js, k), k


# -- the reference's tests/test_serving_engine.py on the port's engine ------

def test_cache_does_not_change_outputs(models):
    """The paper's claim: no accuracy trade-off. Greedy generations with a
    cache of every expert and with N = 1, M = 1 are bitwise equal."""
    cfg = models["tcfg"]
    full = _engine(models, cache=dict(num_indexes=cfg.num_layers,
                                      num_ways=cfg.moe.num_experts))
    none = _engine(models, cache=dict(num_indexes=1, num_ways=1))
    out_full, st_full = full.generate(models["prompts"], steps=STEPS)
    out_none, st_none = none.generate(models["prompts"], steps=STEPS)
    np.testing.assert_array_equal(out_full, out_none)
    assert st_full.hits > st_none.hits


def test_full_cache_reaches_full_hit_rate_after_warmup(models):
    cfg = models["tcfg"]
    eng = _engine(models, cache=dict(num_indexes=cfg.num_layers,
                                     num_ways=cfg.moe.num_experts))
    _, stats = eng.generate(models["prompts"][:1], steps=24)
    # every miss is a (layer, expert) first touch: nothing is evicted
    cold_bound = cfg.num_layers * cfg.moe.num_experts
    expected = (stats.accesses - cold_bound) / stats.accesses
    assert stats.hit_rate >= expected - 1e-6
    assert stats.fetched_experts <= cold_bound


def test_stats_accounting_consistent(models):
    eng = _engine(models)
    _, stats = eng.generate(models["prompts"], steps=12)
    assert stats.accesses == stats.hits + stats.host_assignments
    assert stats.fetched_experts <= stats.host_assignments


def test_generate_counts_first_tokens(models):
    eng = _engine(models)
    out, stats = eng.generate(models["prompts"], steps=12)
    assert out.shape == (B, 12)
    assert stats.first_tokens == B
    assert stats.tokens == B * 11                  # decode-step tokens only
    assert stats.generated_tokens == B * 12 == out.size
    # the per-request path counts exactly one first token
    eng2 = _engine(models)
    eng2.prefill_request(models["prompts"][0])
    assert eng2.stats.first_tokens == 1
    assert eng2.stats.tokens == 0


# -- prefill_request, prefill, refusal, sampling -----------------------------

def test_prefill_request_first_token_same_bypass_and_warming(models):
    """The warming replay moves residency, never logits: for every prompt
    the first token and the decode state are the same with
    ``prefill_chunk`` 0 (bypass) and 3 or 8 (warming), and equal to the
    reference's bypass token up to a near tie."""
    je = JaxEngine(models["jcfg"], models["jparams"], JaxEngineConfig(
        cache=JaxCacheConfig(**CACHE), capacity=CAPACITY, prefill_chunk=0),
        key=jax.random.PRNGKey(3))
    bypass = _engine(models, prefill_chunk=0)
    warm = [_engine(models, prefill_chunk=c) for c in (3, 8)]
    for prompt in models["prompts"]:
        tok, state = bypass.prefill_request(prompt)
        for eng in warm:
            t, s = eng.prefill_request(prompt)
            assert t == tok
            assert int(s["pos"]) == int(state["pos"]) == PROMPT
            for k in ("k", "v"):
                assert torch.equal(s["scan"]["s0"][k],
                                   state["scan"]["s0"][k])
        jtok, _ = je.prefill_request(prompt)
        if jtok != tok:
            logits, _ = je.prefill(prompt[None])
            row = np.asarray(logits[0, 0], np.float32)
            gap = float(row[jtok] - row[tok])
            print(f"\nfirst token differs from the reference's at a logit "
                  f"gap of {gap:.4f}")
            assert gap <= NEAR_TIE
    assert bypass.stats.prefill_accesses == 0
    assert all(e.stats.prefill_accesses > 0 for e in warm)
    assert bypass.stats.first_tokens == B


def test_prefill_returns_last_real_position_logits(models):
    """``prefill`` reads the logits at the last prompt token, pads after
    it masked out, and leaves the tiers untouched."""
    eng = _engine(models)
    state0 = eng.tiers.state
    logits, state = eng.prefill(models["prompts"])
    assert logits.shape == (B, 1, models["tcfg"].vocab_size)
    assert int(state["pos"]) == PROMPT
    short, _ = eng.prefill(models["prompts"][:, :PROMPT - 2])
    again, _ = eng.prefill(models["prompts"][:, :PROMPT - 2])
    assert torch.equal(short, again) and not torch.equal(short, logits)
    for name in ("tags", "age", "clock", "in_flight"):
        assert torch.equal(getattr(eng.tiers.state, name),
                           getattr(state0, name))
    assert eng.stats.accesses == eng.stats.prefill_accesses == 0


def test_seeded_sampling_contract(models):
    """Same seed, same tokens; another seed, other tokens; rows draw
    independently (two rows of one prompt do not sample alike); a seed in
    ``SamplingParams`` wins over the call's; a ``torch.Generator`` works
    as a seed; ``prefill_request`` needs one to sample."""
    sp = SamplingParams(greedy=False, temperature=2.0)
    rows = np.repeat(models["prompts"][:1], 2, axis=0)
    a, _ = _engine(models).generate(rows, 12, sp, seed=1)
    b, _ = _engine(models).generate(rows, 12, sp, seed=1)
    c, _ = _engine(models).generate(rows, 12, sp, seed=2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])
    d, _ = _engine(models).generate(
        rows, 12, SamplingParams(greedy=False, temperature=2.0, seed=1),
        seed=2)
    np.testing.assert_array_equal(a, d)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    e, _ = _engine(models).generate(rows, 12, sp, seed=g1)
    f, _ = _engine(models).generate(rows, 12, sp, seed=g2)
    np.testing.assert_array_equal(e, f)
    t1, _ = _engine(models).prefill_request(rows[0], sp, seed=5)
    t2, _ = _engine(models).prefill_request(rows[0], sp, seed=5)
    assert t1 == t2
    with pytest.raises(ValueError, match="seeds"):
        _engine(models).prefill_request(rows[0], sp)
