"""End to end with prefetch (and the host lane) on: the port's serving
stack against the reference's, on the same weights and requests.

Both packages build the reduced Mixtral from the reference's
``init_params`` (the port's copy through ``repro_torch.bridge``) with
``prefetch=True`` and a cache that covers both layers (N = 2, M = 2, lru:
with slice 1's N = 1 every prediction would target an uncovered layer and
nothing would be reserved). Three runs:

* ``dense``: slice 1's request stream (``tests/test_torch_serving.py``:
  6 greedy requests of 8 new tokens on 4 slots);
* ``paged``: the paged stream of ``tests/test_torch_paged_parity.py``
  (page size 4, 4-token segments one a tick, prefix retention, a fork);
* ``host``: the dense stream with the host lane on as well
  (``host_compute=True``, 8 threads: the port's thread pool, the
  reference's in-graph lane).

What must agree, and how:

* Tokens (dense and paged): greedy agreement reported as a number, no
  lower than slice 1's 43 of 48; every divergence explained by a near tie
  as in ``tests/test_torch_serving.py``.
* Cache state, tick by tick: the port's own demand picks and predicted
  picks are replayed in order through the REFERENCE's ``probe`` /
  ``execute`` / ``commit`` and ``prefetch``; tags, ages, clock and flags
  (SPEC and PENDING included) must equal the port's after every probe and
  every prefetch, and the prefetch counters (issued, hits, wasted,
  predicted, predicted correct, scored with the reference engine's
  formula) must equal the port's exactly.
* Host lane: the dispatch counters (cpu_expert_calls, cpu_tokens,
  miss_expert_groups, fused_groups) replayed through the reference's
  ``dispatch_plan`` with its decision table must equal the port's.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import hostexec as jhost  # noqa: E402
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

SLOTS, REQUESTS, NEW, PROMPT, PS = 4, 6, 8, 8, 4
SLICE1_AGREEMENT = 43            # of 48, slice 1's dense path
NEAR_TIE, ROUTE_TIE = 0.125, 0.01     # as tests/test_torch_serving.py
CACHE = dict(num_indexes=2, num_ways=2, policy="lru")
SERVING = {
    "dense": dict(max_batch=SLOTS, capacity=PROMPT + NEW + 1,
                  prefill_chunk=8, prefetch=True),
    "paged": dict(max_batch=SLOTS, capacity=20, prefill_chunk=8,
                  kv_paged=True, page_size=PS, prefill_segment=4,
                  admit_chunks_per_tick=1, prefix_keep_pages=8,
                  prefetch=True),
    "host": dict(max_batch=SLOTS, capacity=PROMPT + NEW + 1,
                 prefill_chunk=8, prefetch=True, host_compute=True,
                 host_threads=8),
}
DISPATCH = ("cpu_expert_calls", "cpu_tokens", "miss_expert_groups",
            "fused_groups")
PREFETCH = ("prefetch_issued", "prefetch_hits", "prefetch_wasted",
            "predicted", "predicted_correct")


def _requests(vocab, paged):
    """Slice 1's stream; the paged run adds two requests opening with
    request 0's first full page (``tests/test_torch_paged_parity.py``)."""
    rng = np.random.default_rng(0)
    out = [(rng.integers(0, vocab, int(rng.integers(max(PROMPT // 2, 1),
                                                    PROMPT + 1))), NEW)
           for _ in range(REQUESTS)]
    if paged:
        more = np.random.default_rng(1)
        out += [(np.concatenate([out[0][0][:PS],
                                 more.integers(0, vocab, n)]), budget)
                for n, budget in ((3, NEW), (2, NEW + 4))]
    return out


def _drive(sched, vocab, paged):
    """Serve the stream tick by tick; the paged run forks once the queue
    is empty, as ``tests/test_torch_paged_parity.py`` does."""
    reqs = [sched.submit(p, max_new_tokens=n)
            for p, n in _requests(vocab, paged)]
    forked = None
    while sched.queue or any(s is not None for s in sched.slots):
        sched.step()
        if paged and forked is None and not sched.queue:
            live = [r for t, r in enumerate(sched.slots)
                    if r is not None and sched._tickets[t] is None
                    and len(r.generated) <= r.max_new_tokens - 2]
            if live and None in sched.slots:
                forked = min(live, key=lambda r: r.rid)
                sched.fork(forked.rid)
    return reqs


def _record_logits(mp, sched):
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

    mp.setattr(engine, "select_tokens", select_tokens)
    mp.setattr(sched, "_append", _append)
    return rows


def _serve(mode):
    mp = pytest.MonkeyPatch()
    paged = mode == "paged"
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    _, jsched = jax_build(jcfg, cache=CACHE, serving=SERVING[mode],
                          params=jparams, seed=0)
    jrows = _record_logits(mp, jsched)
    jreqs = _drive(jsched, jcfg.vocab_size, paged)

    tcfg = reduced(get_config("mixtral-8x7b"))
    _, tsched = torch_build(tcfg, cache=CACHE, serving=SERVING[mode],
                            params=tparams, seed=0, device="cpu")
    engine = tsched.engine
    _record_logits(mp, tsched)
    ops, gaps, step, flag = [], {}, [], {"warm": False, "predict": False}
    probe, prefetch = tcollab.probe, tcollab.prefetch
    warm_chunk, predict = engine._warm_chunk, engine._predict
    route, decode = tengine.route, engine.decode_batch

    def recording_probe(tiers, layer, top_i, ccfg, active=None):
        pr = probe(tiers, layer, top_i, ccfg, active=active)
        ops.append(("probe", flag["warm"], layer,
                    top_i.to("cpu").numpy().copy(),
                    torch.as_tensor(active).numpy().copy(), pr.state))
        return pr

    def recording_prefetch(tiers, layer, pred_i, ccfg, active=None,
                           rank_votes=False):
        out = prefetch(tiers, layer, pred_i, ccfg, active=active,
                       rank_votes=rank_votes)
        ops.append(("prefetch", rank_votes, layer, pred_i.numpy().copy(),
                    torch.as_tensor(active).numpy().copy(), out[0].state))
        return out

    def flagged(fn, key):
        def run(*a, **k):
            flag[key] = True
            try:
                return fn(*a, **k)
            finally:
                flag[key] = False
        return run

    def recording_route(w, x, k):
        probs, top_i, top_w = route(w, x, k)
        if not flag["predict"]:
            srt = torch.sort(probs, dim=-1, descending=True).values
            step.append((srt[:, k - 1] - srt[:, k]).numpy())
        return probs, top_i, top_w

    def decode_batch(tokens, state, active):
        step.clear()
        out = decode(tokens, state, active)
        low = np.min(np.stack(step), axis=0)
        for t, req in enumerate(tsched.slots):
            if req is not None and active[t]:
                gaps.setdefault(req.rid, []).append(float(low[t]))
        return out

    mp.setattr(tcollab, "probe", recording_probe)
    mp.setattr(tcollab, "prefetch", recording_prefetch)
    mp.setattr(engine, "_warm_chunk", flagged(warm_chunk, "warm"))
    mp.setattr(engine, "_predict", flagged(predict, "predict"))
    mp.setattr(tengine, "route", recording_route)
    mp.setattr(engine, "decode_batch", decode_batch)
    treqs = _drive(tsched, tcfg.vocab_size, paged)
    mp.undo()
    if engine.host_executor is not None:
        engine.host_executor.close()
    return dict(jcfg=jcfg, jsched=jsched, jreqs=jreqs, jrows=jrows,
                tsched=tsched, treqs=treqs, ops=ops, gaps=gaps)


@pytest.fixture(scope="module", params=["dense", "paged", "host"])
def runs(request):
    out = _serve(request.param)
    out["mode"] = request.param
    return out


def _replay(runs):
    """The port's probes and prefetches, in order, through the reference's
    stages; checks the state after each and returns the counters."""
    cfg = runs["jcfg"]
    L, E = cfg.num_layers, cfg.moe.num_experts
    ccfg = JaxCacheConfig(**CACHE)
    table = jnp.asarray(jhost.HostDispatchPolicy(
        jhost.timings_for(cfg.name), 8).decision_table(SLOTS * 2))
    ecfg = runs["tsched"].engine.ecfg
    fuse = ecfg.host_fuse_small

    @jax.jit
    def demand(tiers, layer, top_i, active):
        pr = jcollab.probe(tiers, layer, top_i, ccfg, active=active)
        _, host_w = jcollab.execute(
            tiers, layer, jnp.zeros((top_i.shape[0], 1)),
            jnp.zeros(top_i.shape, jnp.float32), pr, ccfg)
        tiers, fetch = jcollab.commit(tiers, layer, pr, host_w, ccfg)
        to_cpu, counts = jhost.dispatch_plan(pr, table)
        miss = (~pr.resident) & (pr.rep_e >= 0)
        dispatch = jnp.stack([
            to_cpu.sum(), jnp.where(to_cpu, counts, 0).sum(),
            (miss & (counts > 0)).sum(), (to_cpu & (counts <= fuse)).sum()])
        return (tiers, pr.state, pr.hits.sum(), fetch.sum(),
                pr.spec_hits.sum(), pr.flat_e, dispatch)

    def reserve(tiers, layer, pred_i, active, rank_votes):
        return jax.jit(jcollab.prefetch, static_argnames=(
            "ccfg", "rank_votes"))(tiers, layer, pred_i, ccfg,
                                   active=active, rank_votes=rank_votes)

    w = jnp.zeros((L, E, 1, 1), jnp.float32)
    tiers = jcollab.init_tiers(w, w, w, ccfg, num_experts=E)
    c = dict.fromkeys(PREFETCH + DISPATCH + ("hits", "fetched_experts"), 0)
    NG = min(SLOTS * 2, E + 1)
    pred_prev = rep_prev = issued_prev = None
    for i, (kind, arg, layer, picks, active, state) in enumerate(runs["ops"]):
        if kind == "probe":
            tiers, st, hits, fetch, spec, flat_e, dispatch = demand(
                tiers, jnp.int32(layer), jnp.asarray(picks),
                jnp.asarray(active))
            if not arg:                    # a decode step's probe
                if layer == 0:
                    pred_prev = np.full(picks.shape, -1, np.int32)
                    rep_prev = np.full((NG,), -1, np.int32)
                    issued_prev = np.zeros((NG,), bool)
                c["hits"] += int(hits)
                c["fetched_experts"] += int(fetch)
                c["prefetch_hits"] += int(spec)
                if ecfg.host_compute:     # the channel counts only then
                    for k, v in zip(DISPATCH, np.asarray(dispatch)):
                        c[k] += int(v)
                # the reference engine's scoring of the prediction
                valid = (pred_prev >= 0) & active[:, None]
                ok = (pred_prev[:, :, None] == picks[:, None, :]).any(-1)
                demanded = (rep_prev[:, None]
                            == np.asarray(flat_e)[None, :]).any(-1)
                c["predicted"] += int(valid.sum())
                c["predicted_correct"] += int((ok & valid).sum())
                c["prefetch_wasted"] += int((issued_prev & ~demanded).sum())
        else:
            tiers, rep_p, issued, n = reserve(
                tiers, jnp.int32(layer), jnp.asarray(picks),
                jnp.asarray(active), arg)
            st = tiers.state
            c["prefetch_issued"] += int(n)
            pred_prev, rep_prev = picks, np.asarray(rep_p)
            issued_prev = np.asarray(issued)
        for name in ("tags", "age", "clock", "in_flight"):
            np.testing.assert_array_equal(
                getattr(state, name).numpy(), np.asarray(getattr(st, name)),
                err_msg=f"{name} after op {i} ({kind}, layer {layer})")
    return c


def test_cache_state_and_counters_equal_tick_by_tick(runs):
    ts = runs["tsched"].stats
    assert sum(op[0] == "prefetch" for op in runs["ops"]) > 0
    got = _replay(runs)
    print(f"\n{runs['mode']}: " + ", ".join(
        f"{k}={getattr(ts, k)}" for k in got))
    for k, v in got.items():
        assert getattr(ts, k) == v, k
    assert ts.prefetch_issued > 0 and ts.predicted > 0
    if runs["mode"] == "host":
        assert ts.cpu_expert_calls > 0


def test_counters_independent_of_routing_equal(runs):
    js, ts = runs["jsched"].stats, runs["tsched"].stats
    for name in ("requests_submitted", "requests_finished", "generated_tokens",
                 "accesses", "tokens", "steps", "first_tokens",
                 "prefill_accesses", "prefill_tokens", "prefill_chunks",
                 "prefill_segments", "prefix_hits", "cow_forks"):
        assert getattr(ts, name) == getattr(js, name), name
    print(f"\n{runs['mode']}: port prefetch issued={ts.prefetch_issued} "
          f"hits={ts.prefetch_hits} wasted={ts.prefetch_wasted} predicted "
          f"{ts.predicted_correct}/{ts.predicted}; reference "
          f"{js.prefetch_issued}, {js.prefetch_hits}, {js.prefetch_wasted}, "
          f"{js.predicted_correct}/{js.predicted}")


def test_greedy_agreement_at_least_slice_1(runs):
    jreqs, treqs = runs["jreqs"], runs["treqs"]
    same = total = 0
    for j, t in zip(jreqs[:REQUESTS], treqs[:REQUESTS]):
        same += int(np.sum(j.output == t.output))
        total += len(j.output)
    print(f"\n{runs['mode']}: greedy token agreement {same}/{total} = "
          f"{same / total:.4f}")
    for j, t in zip(jreqs, treqs):
        diff = np.nonzero(j.output != t.output)[0]
        if diff.size == 0:
            continue
        s = int(diff[0])
        ref = runs["jrows"][j.rid][s]
        gap = float(ref[j.output[s]] - ref[t.output[s]])
        route_gap = min(runs["gaps"].get(t.rid, [])[:s], default=np.inf)
        print(f"request {t.rid}: first differing step {s}, reference logit "
              f"gap {gap:.4f}, smallest router gap up to it {route_gap:.4f}")
        assert gap <= NEAR_TIE or route_gap < ROUTE_TIE, t.rid
    assert same >= SLICE1_AGREEMENT
