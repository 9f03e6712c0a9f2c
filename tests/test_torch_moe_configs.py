"""The collaborative engine on the MoE configs beyond Mixtral: the port's
serving stack against the reference's, as ``tests/test_torch_serving.py``
holds it for Mixtral, on

* ``phi35-moe`` reduced (the paper's second evaluation model);
* ``qwen3-moe-30b-a3b`` reduced;
* ``qwen3-moe-30b-a3b`` reduced with 16 experts and top-8 on both sides
  (``reduced`` caps experts at 8 and top-k at 2, so top-8 needs the
  override): 4 slots x 8 picks = 32 picks a layer a step.

Both packages build the model from the SAME weights (the reference's
``init_params``, carried by ``repro_torch.bridge``) and serve 6 greedy
requests of 8 new tokens on 4 slots. The cache covers both layers
(N = 2); M = 2 ways of 8 experts, and M = 8 of 16 under top-8, where a
step's 32 picks reach most of a layer's 16 experts.

What must agree, and how (the reasons are ``test_torch_serving.py``'s):
request accounting exactly; greedy tokens, a divergence only at a near
tie (the reference's logit gap below ``NEAR_TIE`` or a router gap below
``ROUTE_TIE`` on the way); the cache integer state, by replaying the
port's routing picks through the reference's probe and commit, exactly.
The host lane's cost model (fitted to the paper's testbed) must choose
the CPU or the fetch for every group size exactly as the reference's
does, with the published and the reduced configs' names.
"""
import dataclasses
import os
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.hostexec import policy as jpolicy  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import build as jax_build  # noqa: E402
from repro_torch import build as torch_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.hostexec import policy as tpolicy  # noqa: E402
from test_torch_serving import (NEAR_TIE, NEW, REQUESTS,  # noqa: E402
                                ROUTE_TIE, SLOTS, _record_logits,
                                _record_route_gaps,
                                _replay_through_reference, _submit_all)

torch.set_num_threads(2)

PROMPT = 8
# (case id, arch, top-8 override, cache ways)
CASES = [("phi35-moe", "phi35-moe", False, 2),
         ("qwen3-moe", "qwen3-moe-30b-a3b", False, 2),
         ("qwen3-moe-top8", "qwen3-moe-30b-a3b", True, 8)]


def _cfg(get, reduce, arch, top8):
    cfg = get(arch)
    if not top8:
        return reduce(cfg)
    return reduce(cfg, moe=dataclasses.replace(cfg.moe, num_experts=16,
                                               top_k=8, d_ff=128))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def runs(request):
    _, arch, top8, ways = request.param
    mp = pytest.MonkeyPatch()
    jcfg = _cfg(jax_get_config, jax_reduced, arch, top8)
    tcfg = _cfg(get_config, reduced, arch, top8)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cache = dict(num_indexes=jcfg.num_layers, num_ways=ways, policy="lru")
    serving = dict(max_batch=SLOTS, capacity=PROMPT + NEW + 1,
                   prefill_chunk=8)
    _, jsched = jax_build(jcfg, cache=cache, serving=serving,
                          params=jparams, seed=0)
    jrows = _record_logits(mp, jsched)
    _submit_all(jsched, jcfg.vocab_size)
    jout = jsched.run()

    _, tsched = torch_build(tcfg, cache=cache, serving=serving,
                            params=tparams, seed=0, device="cpu")
    trows = _record_logits(mp, tsched)
    picks, warming = [], [False]
    probe, warm_chunk = tcollab.probe, tsched.engine._warm_chunk

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
    return dict(jcfg=jcfg, tcfg=tcfg, jsched=jsched, jout=jout, jrows=jrows,
                tsched=tsched, tout=tout, trows=trows, picks=picks,
                cache=cache, route_gaps=route_gaps)


def test_engine_serves_the_config(runs):
    tcfg = runs["tcfg"]
    engine = runs["tsched"].engine
    assert engine.cfg.moe.num_experts == runs["jcfg"].moe.num_experts
    assert engine.cfg.moe.top_k == runs["jcfg"].moe.top_k
    K, E = tcfg.moe.top_k, tcfg.moe.num_experts
    widest = max(int((np.unique(top_i[active]) >= 0).sum())
                 for warm, _, top_i, active in runs["picks"] if not warm)
    print(f"\n{tcfg.name}: {E} experts top-{K}: at most {widest} distinct "
          f"experts a layer a step over {SLOTS * K} picks")
    assert widest <= min(E, SLOTS * K)


def test_greedy_tokens_match_reference(runs):
    jout, tout = runs["jout"], runs["tout"]
    assert sorted(jout) == sorted(tout) == list(range(REQUESTS))
    same = sum(int(np.sum(jout[r] == tout[r])) for r in jout)
    total = sum(len(jout[r]) for r in jout)
    print(f"\n{runs['tcfg'].name} (top-{runs['tcfg'].moe.top_k}): greedy "
          f"token agreement {same}/{total} = {same / total:.4f}")
    for r in sorted(jout):
        diff = np.nonzero(jout[r] != tout[r])[0]
        if diff.size == 0:
            continue
        s = int(diff[0])
        ref = runs["jrows"][r][s]
        gap = float(ref[jout[r][s]] - ref[tout[r][s]])
        route_gap = min(runs["route_gaps"][r][:s], default=np.inf)
        print(f"request {r}: first differing step {s}, reference logit gap "
              f"{gap:.4f}, smallest router gap up to it {route_gap:.4f}")
        assert gap <= NEAR_TIE or route_gap < ROUTE_TIE, (
            f"request {r} diverges at step {s} with no near tie")


def test_run_stats_match_reference(runs):
    js, ts = runs["jsched"].stats, runs["tsched"].stats
    for name in ("requests_submitted", "requests_finished",
                 "requests_active", "requests_queued", "prefill_pending",
                 "admission_stalls", "queue_rejected", "generated_tokens",
                 "accesses", "tokens", "steps", "first_tokens",
                 "prefill_accesses", "prefill_tokens", "prefill_chunks"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.per_layer_accesses == js.per_layer_accesses
    assert ts.accesses == ts.tokens * runs["tcfg"].moe.top_k \
        * runs["tcfg"].num_layers


def test_cache_state_matches_reference(runs):
    ts, js = runs["tsched"].stats, runs["jsched"].stats
    hits, fetched, whits, wfetched = _replay_through_reference(runs)
    assert (ts.hits, ts.fetched_experts) == (hits, fetched)
    assert (ts.prefill_hits, ts.prefill_fetched) == (whits, wfetched)
    print(f"\n{runs['tcfg'].name}: hits {ts.hits} vs reference run "
          f"{js.hits}; fetches {ts.fetched_experts} vs {js.fetched_experts}")
    if all(np.array_equal(runs["jout"][r], runs["tout"][r])
           for r in runs["jout"]) and ts.prefill_hits == js.prefill_hits:
        assert (ts.hits, ts.fetched_experts) == (js.hits, js.fetched_experts)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi35-moe",
                                  "qwen3-moe-30b-a3b"])
def test_host_lane_choice_matches_reference(arch):
    """The CPU-or-fetch decision for every group size, at the thread
    counts the paper measured and others, from the published and the
    reduced config's name. qwen3-moe has no timings of its own: both
    fall back to Mixtral's with a warning."""
    for cfg_t, cfg_j in ((get_config(arch), jax_get_config(arch)),
                         (reduced(get_config(arch)),
                          jax_reduced(jax_get_config(arch)))):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            tt = tpolicy.timings_for(cfg_t.name)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jt = jpolicy.timings_for(cfg_j.name)
        assert len(tw) == len(jw) == (arch == "qwen3-moe-30b-a3b")
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        for threads in (1, 3, 8, 12, 24, 32):
            tp = tpolicy.HostDispatchPolicy(tt, threads)
            jp = jpolicy.HostDispatchPolicy(jt, threads)
            for size in (4 * cfg_t.moe.top_k, 64):
                np.testing.assert_array_equal(
                    np.asarray(tp.decision_table(size)),
                    np.asarray(jp.decision_table(size)))
