"""The port's paged-KV and segment-streamed serving paths, inside the port.

On the reduced Mixtral (2 layers) on the CPU, where every kernel runs its
plain version. The paged pool gathers the same dense view the dense cache
scores, and a segment's rows run the same flash scan as the one-shot
prefill, so the generated tokens must be EQUAL across the modes: paged
vs dense, segment-streamed vs one-shot, a prefix hit vs a cold prompt, a
fork child vs its parent. Page accounting must balance: cancels and
retirements free pages, and at the end no table holds a page (retained
prefix pages aside; the pool's own invariant audit runs after every
tick).
"""
import numpy as np
import pytest
import torch

from repro_torch import build
from repro_torch.config import get_config, reduced
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig
from repro_torch.serving.kv_pool import PoolExhausted
from repro_torch.config import CacheConfig

torch.set_num_threads(2)

PS, NEW, SLOTS = 4, 6, 3
CAP = 28                       # prompts of up to 21 tokens + 6 new + 1


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mixtral-8x7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    stem = rng.integers(0, cfg.vocab_size, 12)          # 3 full pages
    prompts = []
    for i in range(6):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 10)))
        prompts.append(np.concatenate([stem, tail]) if i in (0, 3, 4)
                       else tail)
    return cfg, params, prompts


def _serve(setup, monkeypatch, **serving):
    cfg, params, prompts = setup
    monkeypatch.setenv("REPRO_DEBUG_INVARIANTS", "1")
    opts = dict(max_batch=SLOTS, capacity=CAP, prefill_chunk=4)
    opts.update(serving)
    engine, sched = build(cfg, cache=dict(num_indexes=1, num_ways=2),
                          serving=opts, params=params, seed=0, device="cpu")
    reqs = [sched.submit(p, max_new_tokens=NEW) for p in prompts]
    out = sched.run()
    assert sorted(out) == [r.rid for r in reqs]
    return engine, sched, out


@pytest.fixture(scope="module")
def dense(setup):
    mp = pytest.MonkeyPatch()
    try:
        return _serve(setup, mp)
    finally:
        mp.undo()


def _same_tokens(out, ref):
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=str(rid))


@pytest.mark.parametrize("serving", [
    dict(kv_paged=True, page_size=PS),
    dict(prefill_segment=4),
    dict(prefill_segment=8, admit_chunks_per_tick=1),
    dict(kv_paged=True, page_size=PS, prefill_segment=4,
         admit_chunks_per_tick=1, prefix_keep_pages=4),
], ids=["paged", "segment", "segment-overlap", "paged-segment-keep"])
def test_tokens_equal_dense_one_shot(setup, dense, monkeypatch, serving):
    engine, sched, out = _serve(setup, monkeypatch, **serving)
    _same_tokens(out, dense[2])
    st = sched.stats
    assert st.generated_tokens == len(setup[2]) * NEW
    assert st.accesses == st.tokens * engine.cfg.moe.top_k \
        * engine.cfg.num_layers
    if serving.get("prefill_segment"):
        assert st.prefill_segments > 0
    if serving.get("kv_paged"):
        # requests 3 and 4 open with request 0's three full pages; they
        # are admitted once request 0 retired, so without retention only
        # request 4 finds them (request 3's copy)
        hits = 2 if serving.get("prefix_keep_pages") else 1
        assert st.prefix_hits >= hits
        if serving.get("prefill_segment"):
            assert st.prefix_tokens_skipped >= hits * 3 * PS
        # every table freed; the gauge excludes retained prefix pages
        assert st.kv_pages_in_use == 0
        assert st.prefix_pages_retained <= serving.get("prefix_keep_pages",
                                                       0)
        engine.kv_pool.check_invariants()
    print(f"\n{serving}: prefix_hits={st.prefix_hits} skipped="
          f"{st.prefix_tokens_skipped} segments={st.prefill_segments} "
          f"retained={st.prefix_pages_retained}")


def test_prefix_hit_tokens_equal_cold_tokens(setup, monkeypatch):
    """The same prompt served cold, then again while its pages are
    indexed: the hit skips the shared span's forward and warm."""
    cfg, params, prompts = setup
    serving = dict(max_batch=SLOTS, capacity=CAP, prefill_chunk=4,
                   kv_paged=True, page_size=PS, prefill_segment=4,
                   prefix_keep_pages=8)
    engine, sched = build(cfg, cache=dict(num_indexes=1, num_ways=2),
                          serving=serving, params=params, seed=0,
                          device="cpu")
    cold = sched.submit(prompts[0], max_new_tokens=NEW)
    sched.run()
    skipped = engine.stats.prefix_tokens_skipped
    hit = sched.submit(prompts[0], max_new_tokens=NEW)
    sched.run()
    st = engine.stats
    assert st.prefix_hits == 1
    full = len(prompts[0]) // PS * PS         # every full page is shared
    assert st.prefix_tokens_skipped - skipped == min(full,
                                                     len(prompts[0]) - 1)
    np.testing.assert_array_equal(hit.output, cold.output)


def _paged_engine(setup, **extra):
    cfg, params, _ = setup
    serving = dict(max_batch=SLOTS, capacity=CAP, prefill_chunk=4,
                   kv_paged=True, page_size=PS)
    serving.update(extra)
    return build(cfg, cache=dict(num_indexes=1, num_ways=2),
                 serving=serving, params=params, seed=0, device="cpu")


def test_fork_child_equals_parent(setup):
    engine, sched = _paged_engine(setup)
    parent = sched.submit(setup[2][1], max_new_tokens=NEW)
    while len(parent.generated) < 2 or \
            (len(parent.prompt) + len(parent.generated) - 1) % PS == 0:
        sched.step()
    child = sched.fork(parent.rid)
    assert child.generated == parent.generated
    sched.run()
    assert engine.stats.cow_forks >= 1
    np.testing.assert_array_equal(child.output, parent.output)
    st = engine.stats
    assert st.kv_pages_in_use == 0
    engine.kv_pool.check_invariants()


def test_fork_contract(setup):
    engine, sched = _paged_engine(setup, prefill_segment=4,
                                  admit_chunks_per_tick=1)
    req = sched.submit(setup[2][0], max_new_tokens=NEW)
    sched.step()                       # admitted, still streaming
    with pytest.raises(ValueError, match="PREFILLING"):
        sched.fork(req.rid)
    with pytest.raises(ValueError, match="not in a live slot"):
        sched.fork(req.rid + 100)
    _, dense_sched = build(setup[0], serving=dict(capacity=CAP),
                           params=setup[1], device="cpu")
    with pytest.raises(RuntimeError, match="kv_paged"):
        dense_sched.fork(0)


def test_backpressure_holds_fifo_head(setup, dense):
    """A pool of one full request's pages: the FIFO head waits for pages
    (no skipping ahead), and every request still finishes with the dense
    run's tokens."""
    engine, sched = _paged_engine(setup, kv_pages=CAP // PS)
    prompts = setup[2]
    reqs = [sched.submit(p, max_new_tokens=NEW) for p in prompts]
    sched.step()
    assert sched.num_active == 1
    assert sched.queue[0] is reqs[1]
    assert not engine.can_admit(prompts[1], NEW)
    out = sched.run()
    assert sched.stats.admission_stalls > 0
    assert [r.rid for r in sched.finished] == [r.rid for r in reqs]
    _same_tokens(out, dense[2])


@pytest.mark.parametrize("segmented", [False, True])
def test_cancel_frees_pages(setup, segmented):
    extra = dict(prefill_segment=4, admit_chunks_per_tick=1) \
        if segmented else {}
    engine, sched = _paged_engine(setup, **extra)
    a = sched.submit(setup[2][0], max_new_tokens=NEW)
    b = sched.submit(setup[2][1], max_new_tokens=NEW)
    sched.step()
    in_use = engine.stats.kv_pages_in_use
    assert in_use > 0
    assert sched.cancel(a.rid)          # mid-decode or mid-stream
    assert engine.stats.kv_pages_in_use < in_use
    engine.kv_pool.check_invariants()
    sched.run()
    assert a.cancelled and len(b.output) == NEW
    assert engine.stats.kv_pages_in_use == 0
    engine.kv_pool.check_invariants()


def _overcommit(setup):
    """A pool of 10 pages: C (4 + 20 tokens, 6 pages) stays live while A
    (the 12-token stem, 4 pages) retires and retains its 3 full pages;
    B (stem + 2 tokens, 13 new: 7 pages) is then submitted. ``can_admit``
    counts the 3 retained pages as available AND as B's shared prefix, so
    B is admitted against 4 available pages that really are 1."""
    cfg, _, _ = setup
    rng = np.random.default_rng(5)
    stem = setup[2][0][:12]
    engine, sched = _paged_engine(setup, kv_pages=10, prefix_keep_pages=3)
    c = sched.submit(rng.integers(0, cfg.vocab_size, 4), max_new_tokens=20)
    a = sched.submit(stem, max_new_tokens=1)
    while a not in sched.finished:
        sched.step()
    assert engine.kv_pool.prefix_pages_retained == 3
    b_prompt = np.concatenate([stem, rng.integers(0, cfg.vocab_size, 2)])
    b = sched.submit(b_prompt, max_new_tokens=13)
    return engine, sched, b, c


def test_retained_prefix_overcommit_edge_in_the_scheduler(setup,
                                                          monkeypatch):
    """The pool keeps the reference's over-commit when an admission adopts
    retained prefix pages (see ``test_torch_kv_pool``). Through the
    scheduler: the audit names it on the admitting tick; without the
    audit, the tick whose decode append draws the missing page raises
    ``PoolExhausted`` out of ``step`` and commits nothing, so cancelling
    a request frees its pages and serving goes on, B's tokens equal to a
    cold serve of B alone."""
    monkeypatch.setenv("REPRO_DEBUG_INVARIANTS", "1")
    _, sched, _, _ = _overcommit(setup)
    with pytest.raises(AssertionError, match="over-committed"):
        sched.step()
    monkeypatch.delenv("REPRO_DEBUG_INVARIANTS")

    engine, sched, b, c = _overcommit(setup)
    pool = engine.kv_pool
    with pytest.raises(PoolExhausted, match="free list is empty"):
        sched.run()
    assert pool.available < 0 and b.slot >= 0
    assert 0 < len(b.generated) < 13 and len(c.generated) < 20
    assert sched.cancel(c.rid)
    out = sched.run()
    assert len(out[b.rid]) == 13 and pool.pages_in_use == 0
    pool.check_invariants()
    _, cold = _paged_engine(setup)
    want = cold.submit(b.prompt, max_new_tokens=13)
    cold.run()
    np.testing.assert_array_equal(out[b.rid], want.output)


def test_pause_and_resume_admission(setup):
    engine, sched = _paged_engine(setup)
    sched.pause_admission()
    req = sched.submit(setup[2][1], max_new_tokens=NEW)
    assert sched.run() == {} and sched.admission_paused   # nothing to drain
    sched.step()
    assert sched.stats.admission_stalls == 1 and list(sched.queue) == [req]
    sched.resume_admission()
    assert len(sched.run()[req.rid]) == NEW


def test_engine_config_options():
    cache = CacheConfig(num_indexes=1, num_ways=2)
    EngineConfig(cache=cache, capacity=32, kv_paged=True, page_size=8,
                 prefill_segment=8, prefix_keep_pages=2)
    for bad in (dict(kv_paged=True, page_size=5),
                dict(kv_paged=True, page_size=8, kv_pages=3),
                dict(prefix_keep_pages=2), dict(prefill_segment=-1),
                dict(page_size=0)):
        with pytest.raises(ValueError):
            EngineConfig(cache=cache, capacity=32, **bad)
    # prefetch and the host lane are ported and combine with paged KV;
    # the reference's in-graph host backend has no PyTorch meaning
    for ported in (dict(prefetch=True), dict(host_compute=True)):
        EngineConfig(cache=cache, capacity=32, kv_paged=True, page_size=8,
                     **ported)
        with pytest.raises(NotImplementedError):
            EngineConfig(cache=cache, capacity=32, host_backend="jax",
                         **ported)


@pytest.mark.parametrize("call", [
    lambda eng, p: eng.generate(p[None], steps=2),
    lambda eng, p: eng.prefill(p[None]),
    lambda eng, p: eng.prefill_chunked(p),
    lambda eng, p: eng.prefill_request(p)],
    ids=["generate", "prefill", "prefill_chunked", "prefill_request"])
def test_dense_only_paths_refuse_paged(setup, call):
    """The dense-KV conveniences refuse under kv_paged rather than bypass
    the pool (the reference's tests/test_paged_serving.py:160-171)."""
    engine, _ = _paged_engine(setup)
    with pytest.raises(RuntimeError, match="dense-KV path"):
        call(engine, setup[2][0])
    assert engine.kv_pool.pages_in_use == 0


def test_serve_cli_paged_segment_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--device", "cpu", "--kv-paged", "--page-size", "8",
                    "--prefill-segment", "8", "--tokens", "8", "--prompt",
                    "16", "--concurrency", "4", "--requests", "6",
                    "--prefix-keep-pages", "2"])
    out = capsys.readouterr().out
    assert "served 6 requests / 48 tokens" in out
    assert "segmented prefill:" in out and "paged KV: page_size=8" in out


@pytest.mark.parametrize("argv,want", [
    (["--kv-paged", "--prompt", "9", "--tokens", "4", "--page-size", "4"],
     dict(kv_paged=True, page_size=4, capacity=16)),
    (["--prefill-segment", "16", "--kv-pages", "64", "--kv-paged"],
     dict(prefill_segment=16, kv_pages=64, capacity=80)),
])
def test_serve_flags_reach_the_engine(argv, want, monkeypatch):
    """Capacity rounds up to whole pages under --kv-paged, as in the
    reference's launch/serve.py."""
    from repro_torch.launch import serve as serve_cli
    seen = {}

    def fake_build(cfg, cache=None, serving=None, **kw):
        seen.update(serving)
        raise SystemExit(0)
    monkeypatch.setattr(serve_cli, "build", fake_build)
    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu"] + argv)
    for k, v in want.items():
        assert seen[k] == v, k
