"""End to end: the port's serving stack against the reference's.

Both packages build the reduced Mixtral from the SAME weights (the
reference's ``init_params``, carried over by ``repro_torch.bridge``),
serve 6 greedy requests of 8 new tokens on 4 slots with the default cache
(N = L/2, M = 2, lru) and the warming prefill. The port runs on the CPU
here (plain versions of its kernels).

What must agree, and how:

* Tokens. Every op of the port agrees with the reference's op on its own
  bit for bit, but XLA compiles the reference's layer loop as one program
  and fuses reductions in another order (rmsnorm's mean, the attention
  sums), so hidden states differ by bf16 ulps. Where a choice is a near
  tie the two may pick differently, and the request's tokens diverge from
  there on: the token itself (the reference's logit gap between the two
  picks below ``NEAR_TIE``) or an expert pick on the way (the port's
  router gap between its K-th and (K+1)-th probability below
  ``ROUTE_TIE`` at one of the request's decode steps up to the
  divergence: a flipped expert changes that token's layer output and so
  every later step's attention). The test reports greedy agreement as a
  number and, for every request that diverges, the first differing step,
  the logit gap and the smallest router gap; it fails on a divergence
  that no near tie explains.
* Request accounting and every counter that does not depend on routing:
  exactly equal.
* Cache integer state: the port's hits and fetches are replayed from its
  own routing picks through the REFERENCE cache
  (``repro.core.collaborative.probe``/``commit``) and must match exactly;
  where both runs routed identically, hits and fetches must also equal
  the reference run's.
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
from repro.serving import build as jax_build  # noqa: E402
from repro_torch import build as torch_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

torch.set_num_threads(2)

SLOTS, REQUESTS, NEW, PROMPT = 4, 6, 8, 8
# bf16 logits of this model sit at |x| ~ 1-4, where a bf16 ulp is 1/128 to
# 1/32; a few ulps of accumulated drift can flip a gap of this size
NEAR_TIE = 0.125
# router logits come from h2 that differs by bf16 ulps (2^-8 relative)
# summed over D = 128 terms: a probability can move by ~1e-3
ROUTE_TIE = 0.01


def _submit_all(sched, vocab):
    """The reference serve entry point's request stream (seed 0)."""
    rng = np.random.default_rng(0)
    for _ in range(REQUESTS):
        plen = int(rng.integers(max(PROMPT // 2, 1), PROMPT + 1))
        sched.submit(rng.integers(0, vocab, plen), max_new_tokens=NEW)


def _record_logits(monkeypatch, sched):
    """Per request, the logits row each of its tokens was chosen from."""
    rows, last = {}, {}
    engine = sched.engine
    select, append = engine.select_tokens, sched._append

    def select_tokens(logits, *a, **k):
        last["l"] = np.asarray(jnp.asarray(logits, jnp.float32)) \
            if not isinstance(logits, torch.Tensor) else logits.float().numpy()
        return select(logits, *a, **k)

    def _append(req, tok, events):
        lg = last["l"]
        rows.setdefault(req.rid, []).append(lg[0] if lg.shape[0] == 1
                                            else lg[req.slot])
        return append(req, tok, events)

    monkeypatch.setattr(engine, "select_tokens", select_tokens)
    monkeypatch.setattr(sched, "_append", _append)
    return rows


def _record_route_gaps(monkeypatch, sched):
    """Per request, for each of its decode steps, the smallest gap over
    the layers between the port router's K-th and (K+1)-th probability."""
    gaps, step = {}, []
    route, decode = tengine.route, sched.engine.decode_batch

    def recording_route(w, x, k):
        probs, top_i, top_w = route(w, x, k)
        srt = torch.sort(probs, dim=-1, descending=True).values
        step.append((srt[:, k - 1] - srt[:, k]).numpy())
        return probs, top_i, top_w

    def decode_batch(tokens, state, active):
        step.clear()
        out = decode(tokens, state, active)
        low = np.min(np.stack(step), axis=0)
        for t, req in enumerate(sched.slots):
            if req is not None and active[t]:
                gaps.setdefault(req.rid, []).append(float(low[t]))
        return out

    monkeypatch.setattr(tengine, "route", recording_route)
    monkeypatch.setattr(sched.engine, "decode_batch", decode_batch)
    return gaps


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cache = dict(num_indexes=jcfg.num_layers // 2, num_ways=2, policy="lru")
    serving = dict(max_batch=SLOTS, capacity=PROMPT + NEW + 1,
                   prefill_chunk=8)
    _, jsched = jax_build(jcfg, cache=cache, serving=serving,
                          params=jparams, seed=0)
    jrows = _record_logits(mp, jsched)
    _submit_all(jsched, jcfg.vocab_size)
    jout = jsched.run()

    tcfg = reduced(get_config("mixtral-8x7b"))
    _, tsched = torch_build(tcfg, cache=cache, serving=serving,
                            params=tparams, seed=0, device="cpu")
    trows = _record_logits(mp, tsched)
    picks = []                   # the port's probes, in order
    probe, warm_chunk = tcollab.probe, tsched.engine._warm_chunk
    warming = [False]

    def recording_probe(tiers, layer, top_i, ccfg, active=None):
        picks.append((warming[0], layer, top_i.to("cpu").numpy().copy(),
                      torch.as_tensor(active).numpy().copy()))
        return probe(tiers, layer, top_i, ccfg, active=active)

    def recording_warm_chunk(*a, **k):
        warming[0] = True
        try:
            return warm_chunk(*a, **k)
        finally:
            warming[0] = False
    mp.setattr(tcollab, "probe", recording_probe)
    mp.setattr(tsched.engine, "_warm_chunk", recording_warm_chunk)
    route_gaps = _record_route_gaps(mp, tsched)
    _submit_all(tsched, tcfg.vocab_size)
    tout = tsched.run()
    mp.undo()
    return dict(jcfg=jcfg, jsched=jsched, jout=jout, jrows=jrows,
                tsched=tsched, tout=tout, trows=trows, picks=picks,
                cache=cache, route_gaps=route_gaps)


def test_serving_greedy_tokens_match_reference(runs):
    jout, tout = runs["jout"], runs["tout"]
    assert sorted(jout) == sorted(tout) == list(range(REQUESTS))
    same = sum(int(np.sum(jout[r] == tout[r])) for r in jout)
    total = sum(len(jout[r]) for r in jout)
    print(f"\ngreedy token agreement: {same}/{total} = {same / total:.4f}")
    for r in sorted(jout):
        diff = np.nonzero(jout[r] != tout[r])[0]
        if diff.size == 0:
            continue
        s = int(diff[0])
        ref = runs["jrows"][r][s]
        gap = float(ref[jout[r][s]] - ref[tout[r][s]])
        # token s comes from decode step s (token 0 from the prefill)
        route_gap = min(runs["route_gaps"][r][:s], default=np.inf)
        print(f"request {r}: first differing step {s} (reference token "
              f"{jout[r][s]}, port token {tout[r][s]}), reference logit gap "
              f"{gap:.4f}, smallest router gap up to it {route_gap:.4f}")
        assert gap <= NEAR_TIE or route_gap < ROUTE_TIE, (
            f"request {r} diverges at step {s} with no near tie: logit gap "
            f"{gap:.4f} > {NEAR_TIE} and router gap {route_gap:.4f} >= "
            f"{ROUTE_TIE}")


def test_serving_run_stats_match_reference(runs):
    js, ts = runs["jsched"].stats, runs["tsched"].stats
    for name in ("requests_submitted", "requests_finished",
                 "requests_active", "requests_queued", "prefill_pending",
                 "admission_stalls", "queue_rejected", "generated_tokens",
                 "accesses", "tokens", "steps", "first_tokens",
                 "prefill_accesses", "prefill_tokens", "prefill_chunks",
                 "prefetch_hits"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.per_layer_accesses == js.per_layer_accesses
    assert ts.generated_tokens == REQUESTS * NEW


def _replay_through_reference(runs):
    """Replay the port's routing picks through the reference's probe and
    commit (tiny stand-in weights: only the integer state matters).
    Returns (decode hits, decode fetches, warm hits, warm fetches)."""
    cfg = runs["jcfg"]
    L, E = cfg.num_layers, cfg.moe.num_experts
    ccfg = JaxCacheConfig(**runs["cache"])
    w = jnp.zeros((L, E, 1, 1), jnp.float32)
    tiers = jcollab.init_tiers(w, w, w, ccfg, num_experts=E)
    out = np.zeros(4, np.int64)
    for warm, layer, top_i, active in runs["picks"]:
        pr = jcollab.probe(tiers, jnp.int32(layer), jnp.asarray(top_i),
                           ccfg, active=jnp.asarray(active))
        _, host_w = jcollab.execute(
            tiers, jnp.int32(layer), jnp.zeros((top_i.shape[0], 1)),
            jnp.zeros(top_i.shape, jnp.float32), pr, ccfg)
        tiers, fetch = jcollab.commit(tiers, jnp.int32(layer), pr, host_w,
                                      ccfg)
        base = 2 if warm else 0
        out[base] += int(pr.hits.sum())
        out[base + 1] += int(fetch.sum())
    return tuple(int(v) for v in out)


def test_serving_cache_counters_match_reference(runs):
    ts, js = runs["tsched"].stats, runs["jsched"].stats
    hits, fetched, whits, wfetched = _replay_through_reference(runs)
    assert (ts.hits, ts.fetched_experts) == (hits, fetched)
    assert (ts.prefill_hits, ts.prefill_fetched) == (whits, wfetched)
    assert sum(ts.per_layer_hits) == ts.hits
    print(f"\nhits {ts.hits} vs reference run {js.hits}; fetches "
          f"{ts.fetched_experts} vs {js.fetched_experts}; prefill hits "
          f"{ts.prefill_hits} vs {js.prefill_hits}")
    if all(np.array_equal(runs["jout"][r], runs["tout"][r])
           for r in runs["jout"]) and (ts.prefill_hits == js.prefill_hits):
        assert (ts.hits, ts.fetched_experts) == (js.hits, js.fetched_experts)
