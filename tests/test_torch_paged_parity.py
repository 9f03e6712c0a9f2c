"""The port's paged-KV + segment-streamed serving stack against the
reference's, on the same weights and the same requests.

Both packages build the reduced Mixtral from the reference's
``init_params`` (the port's copy through ``repro_torch.bridge``) with
``kv_paged`` (page size 4), ``prefill_segment`` 4, one segment per tick
and prefix retention, and serve slice 1's request stream (6 greedy
requests of 8 new tokens, ``tests/test_torch_serving.py``) followed by two
requests that open with request 0's first full page; once the queue is
empty and a slot is free, the lowest live, warmed request with two or
more tokens to go is forked into it.

What must agree, and how:

* Page bookkeeping, tick by tick: every slot's page-id row, the pool's
  refcounts, free list, retention LRU, commitments and prefix index.
  Pages follow token COUNTS, never token values, so this is exact.
* Request accounting and every counter that does not depend on routing
  (tokens, steps, accesses, prefill segments and tokens, prefix hits and
  skipped tokens, COW forks, pages in use and retained): exactly equal.
* Tokens: greedy agreement reported as a number over slice 1's six
  requests, no lower than slice 1's dense figure (43 of 48); a request
  that diverges must do so at a near tie, as in
  ``tests/test_torch_serving.py`` (the reference's logit gap below
  ``NEAR_TIE`` or the port's router gap below ``ROUTE_TIE``).
* Cache counters: the port's hits and fetches replayed from its own
  routing picks through the REFERENCE cache must match exactly.
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

SLOTS, REQUESTS, NEW, PROMPT, PS = 4, 6, 8, 8, 4
SLICE1_AGREEMENT = 43            # of 48, slice 1's dense path
NEAR_TIE, ROUTE_TIE = 0.125, 0.01     # as tests/test_torch_serving.py
SERVING = dict(max_batch=SLOTS, capacity=20, prefill_chunk=8,
               kv_paged=True, page_size=PS, prefill_segment=4,
               admit_chunks_per_tick=1, prefix_keep_pages=8)


def _requests(vocab):
    """(prompt, max_new_tokens): slice 1's request stream, then two
    requests opening with request 0's first full page, the last with a
    longer budget (it is the one still decoding when a slot frees)."""
    rng = np.random.default_rng(0)
    out = [(rng.integers(0, vocab, int(rng.integers(max(PROMPT // 2, 1),
                                                    PROMPT + 1))), NEW)
           for _ in range(REQUESTS)]
    more = np.random.default_rng(1)
    out += [(np.concatenate([out[0][0][:PS], more.integers(0, vocab, n)]),
             budget) for n, budget in ((3, NEW), (2, NEW + 4))]
    return out


def _pool_state(pool):
    return (list(pool._free), pool._ref.tolist(), list(pool._retained),
            pool._committed, sorted(pool._index.items()), pool.prefix_hits,
            pool.cow_forks, pool.pages_in_use)


def _drive(sched, vocab, trail):
    """Serve the stream tick by tick; fork once the queue is empty. Each
    tick appends (slot page rows, pool state) to ``trail``."""
    reqs = [sched.submit(p, max_new_tokens=n) for p, n in _requests(vocab)]
    engine, forked = sched.engine, None
    while sched.queue or any(s is not None for s in sched.slots):
        sched.step()
        trail.append((np.asarray(engine._slot_pages).copy(),
                      _pool_state(engine.kv_pool)))
        if forked is None and not sched.queue:
            live = [r for t, r in enumerate(sched.slots)
                    if r is not None and sched._tickets[t] is None
                    and len(r.generated) <= r.max_new_tokens - 2]
            if live and None in sched.slots:
                forked = (min(live, key=lambda r: r.rid),)
                forked += (sched.fork(forked[0].rid),)
    return reqs, forked


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


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    cache = dict(num_indexes=jcfg.num_layers // 2, num_ways=2, policy="lru")
    _, jsched = jax_build(jcfg, cache=cache, serving=SERVING,
                          params=jparams, seed=0)
    jrows = _record_logits(mp, jsched)
    jtrail = []
    jreqs, jfork = _drive(jsched, jcfg.vocab_size, jtrail)

    tcfg = reduced(get_config("mixtral-8x7b"))
    _, tsched = torch_build(tcfg, cache=cache, serving=SERVING,
                            params=tparams, seed=0, device="cpu")
    _record_logits(mp, tsched)
    picks, gaps, step = [], {}, []
    probe, warm_chunk = tcollab.probe, tsched.engine._warm_chunk
    route, decode = tengine.route, tsched.engine.decode_batch
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

    def recording_route(w, x, k):
        probs, top_i, top_w = route(w, x, k)
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
    mp.setattr(tsched.engine, "_warm_chunk", recording_warm_chunk)
    mp.setattr(tengine, "route", recording_route)
    mp.setattr(tsched.engine, "decode_batch", decode_batch)
    ttrail = []
    treqs, tfork = _drive(tsched, tcfg.vocab_size, ttrail)
    mp.undo()
    return dict(jcfg=jcfg, cache=cache, jsched=jsched, jreqs=jreqs,
                jfork=jfork, jtrail=jtrail, jrows=jrows, tsched=tsched,
                treqs=treqs, tfork=tfork, ttrail=ttrail, picks=picks,
                gaps=gaps)


def test_page_tables_equal_tick_by_tick(runs):
    jt, tt = runs["jtrail"], runs["ttrail"]
    assert len(jt) == len(tt)
    for i, ((jp, js), (tp, ts)) in enumerate(zip(jt, tt)):
        np.testing.assert_array_equal(tp, jp, err_msg=f"tick {i}")
        assert ts == js, f"pool state differs at tick {i}"
    assert runs["jfork"] is not None and runs["tfork"] is not None
    assert runs["tfork"][0].rid == runs["jfork"][0].rid


def test_counters_equal(runs):
    js, ts = runs["jsched"].stats, runs["tsched"].stats
    for name in ("requests_submitted", "requests_finished",
                 "requests_active", "requests_queued", "prefill_pending",
                 "admission_stalls", "queue_rejected", "generated_tokens",
                 "accesses", "tokens", "steps", "first_tokens",
                 "prefill_accesses", "prefill_tokens", "prefill_chunks",
                 "prefill_segments", "prefix_tokens_skipped",
                 "kv_pages_in_use", "prefix_hits", "cow_forks",
                 "prefix_pages_retained"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.per_layer_accesses == js.per_layer_accesses
    assert ts.prefix_hits >= 2 and ts.cow_forks >= 1
    assert ts.prefix_tokens_skipped > 0
    print(f"\nprefix_hits={ts.prefix_hits} skipped="
          f"{ts.prefix_tokens_skipped} cow_forks={ts.cow_forks} "
          f"segments={ts.prefill_segments} retained="
          f"{ts.prefix_pages_retained}")


def test_greedy_agreement_at_least_slice_1(runs):
    jreqs, treqs = runs["jreqs"], runs["treqs"]
    same = total = 0
    for j, t in zip(jreqs[:REQUESTS], treqs[:REQUESTS]):
        same += int(np.sum(j.output == t.output))
        total += len(j.output)
    print(f"\ngreedy token agreement (slice 1's requests, paged + "
          f"segment): {same}/{total} = {same / total:.4f}")
    for j, t in zip(jreqs, treqs):
        diff = np.nonzero(j.output != t.output)[0]
        if diff.size == 0:
            continue
        s = int(diff[0])
        ref = runs["jrows"][j.rid][s]
        gap = float(ref[j.output[s]] - ref[t.output[s]])
        route_gap = min(runs["gaps"].get(t.rid, [])[:s], default=np.inf)
        print(f"request {t.rid}: first differing step {s}, reference "
              f"logit gap {gap:.4f}, smallest router gap up to it "
              f"{route_gap:.4f}")
        assert gap <= NEAR_TIE or route_gap < ROUTE_TIE, t.rid
    assert same >= SLICE1_AGREEMENT
    jp, jc = runs["jfork"]
    tp, tc = runs["tfork"]
    np.testing.assert_array_equal(tc.output, tp.output)
    np.testing.assert_array_equal(jc.output, jp.output)


def test_cache_counters_replay_through_reference(runs):
    cfg = runs["jcfg"]
    L, E = cfg.num_layers, cfg.moe.num_experts
    ccfg = JaxCacheConfig(**runs["cache"])
    w = jnp.zeros((L, E, 1, 1), jnp.float32)

    @jax.jit
    def replay(tiers, layer, top_i, active):
        pr = jcollab.probe(tiers, layer, top_i, ccfg, active=active)
        _, host_w = jcollab.execute(
            tiers, layer, jnp.zeros((top_i.shape[0], 1)),
            jnp.zeros(top_i.shape, jnp.float32), pr, ccfg)
        tiers, fetch = jcollab.commit(tiers, layer, pr, host_w, ccfg)
        return tiers, pr.hits.sum(), fetch.sum()

    tiers = jcollab.init_tiers(w, w, w, ccfg, num_experts=E)
    out = np.zeros(4, np.int64)
    for warm, layer, top_i, active in runs["picks"]:
        tiers, hits, fetched = replay(tiers, jnp.int32(layer),
                                      jnp.asarray(top_i),
                                      jnp.asarray(active))
        base = 2 if warm else 0
        out[base] += int(hits)
        out[base + 1] += int(fetched)
    ts = runs["tsched"].stats
    assert (ts.hits, ts.fetched_experts, ts.prefill_hits,
            ts.prefill_fetched) == tuple(int(v) for v in out)
