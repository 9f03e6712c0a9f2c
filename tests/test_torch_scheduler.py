"""The port's continuous-batching scheduler, engine options and entry
points, on the CPU at the reduced Mixtral (the port's own seeded weights).

These are behaviours the reference's ``tests/test_scheduler.py`` holds its
scheduler to, checked on the port: accounting across slots, slot reuse,
isolation of padded slots, cancellation, overlapped admission, the bounded
queue; and the port's own contract that unported options raise instead of
being ignored and that nothing falls back to the CPU unasked. Token
equalities are exact: residency and warming pace change where weights are
read from, never the numbers.
"""
import typing

import numpy as np
import pytest
import torch

from repro_torch import build
from repro_torch.config import CacheConfig, get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_params
from repro_torch.serving import (CollaborativeEngine,
                                 ContinuousBatchingScheduler, EngineConfig,
                                 QueueFull, SamplingParams)
from repro_torch.serving.stats import EngineStats

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mixtral-8x7b"))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(cfg, params, slots=4, capacity=64, **ecfg):
    ccfg = CacheConfig(num_indexes=cfg.num_layers, num_ways=2, policy="lru")
    return CollaborativeEngine(
        cfg, params, EngineConfig(cache=ccfg, max_batch=slots,
                                  capacity=capacity, **ecfg), seed=3)


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 9)))
            .astype(np.int32) for _ in range(n)]


def test_four_concurrent_requests_share_one_cache(setup):
    cfg, params = setup
    sched = ContinuousBatchingScheduler(_engine(cfg, params, slots=4))
    reqs = [sched.submit(p, max_new_tokens=6) for p in _prompts(cfg, 4)]
    sched.step()
    assert sched.num_active == 4
    outs = sched.run()
    assert sorted(outs) == [r.rid for r in reqs]
    st = sched.stats
    assert st.accesses == st.hits + st.host_assignments
    assert st.accesses == 4 * 5 * cfg.num_layers * cfg.moe.top_k
    assert st.tokens == 4 * 5 and st.first_tokens == 4
    assert st.generated_tokens == 4 * 6 == sum(len(o) for o in outs.values())
    assert sum(st.per_layer_hits) == st.hits
    assert st.requests_submitted == st.requests_finished == 4


def test_slots_recycle_when_requests_outnumber_slots(setup):
    cfg, params = setup
    sched = ContinuousBatchingScheduler(_engine(cfg, params, slots=2))
    reqs = [sched.submit(p, max_new_tokens=3 + i)
            for i, p in enumerate(_prompts(cfg, 5, seed=1))]
    outs = sched.run()
    for i, r in enumerate(reqs):
        assert len(outs[r.rid]) == 3 + i
    assert not sched.queue


def test_padded_slots_are_bitwise_invisible(setup):
    """Junk tokens and positions in inactive slots change neither the
    active row's logits nor the cache nor the counters."""
    cfg, params = setup
    prompt = _prompts(cfg, 1)[0]

    def run(junk_tok, junk_pos):
        eng = _engine(cfg, params, slots=4)
        ticket = eng.start_prefill(prompt, chunk=0)
        tok = eng.sample_first(ticket)
        state = eng.bind_slot(eng.init_slots(), ticket, 0)
        state["pos"][1:] = junk_pos
        tokens = np.full((4, 1), junk_tok, np.int64)
        tokens[0, 0] = tok
        logits, _ = eng.decode_batch(tokens, state,
                                     np.array([True, False, False, False]))
        return logits[0, 0], eng.tiers, eng.stats

    l1, t1, s1 = run(7, 0)
    l2, t2, s2 = run(301, 13)
    assert torch.equal(l1, l2)
    for a, b in zip(t1.state, t2.state):
        assert torch.equal(a, b)
    for a, b in zip(t1.slots, t2.slots):
        assert torch.equal(a, b)
    assert s1 == s2
    assert s1.accesses == cfg.num_layers * cfg.moe.top_k


def test_cancel_mid_decode_frees_slot_and_admits_waiting(setup):
    cfg, params = setup
    sched = ContinuousBatchingScheduler(_engine(cfg, params, slots=2))
    reqs = [sched.submit(p, max_new_tokens=8)
            for p in _prompts(cfg, 3, seed=3)]
    sched.step()
    victim = reqs[0]
    n_before = len(victim.generated)
    assert sched.cancel(victim.rid)
    assert victim.done and victim.cancelled and sched.num_active == 1
    finished, events = sched._tick()
    assert events[0] == (victim.rid, -1, True)
    assert victim in finished
    assert any(s is not None and s.rid == reqs[2].rid for s in sched.slots)
    outs = sched.run()
    assert len(outs[victim.rid]) == n_before < 8
    assert len(outs[reqs[1].rid]) == len(outs[reqs[2].rid]) == 8
    assert not sched.cancel(victim.rid)
    assert not sched.cancel(10_000)


def test_cancel_queued_request_and_stream_terminal_event(setup):
    cfg, params = setup
    sched = ContinuousBatchingScheduler(_engine(cfg, params, slots=1))
    seen = []
    r0 = sched.submit(_prompts(cfg, 1, seed=4)[0], max_new_tokens=3)
    rq = sched.submit(_prompts(cfg, 1, seed=5)[0], max_new_tokens=3,
                      on_token=lambda tok, done: seen.append((tok, done)))
    assert sched.cancel(rq.rid)
    assert seen == [(-1, True)]
    events = list(sched.stream())
    assert [e for e in events if e[0] == rq.rid] == [(rq.rid, -1, True)]
    r0_events = [e for e in events if e[0] == r0.rid]
    assert len(r0_events) == 3 and r0_events[-1][2]
    assert rq.output.size == 0


def test_cancel_finished_request_awaiting_retirement_is_noop(setup):
    cfg, params = setup
    sched = ContinuousBatchingScheduler(_engine(cfg, params, slots=1))
    req = sched.submit(_prompts(cfg, 1, seed=6)[0], max_new_tokens=2)
    sched.step()
    assert req.done and sched.slots[0] is req
    assert not sched.cancel(req.rid)
    assert not req.cancelled
    sched.step()
    assert sched.finished == [req]


def test_prefill_chunked_equals_the_ticket_path(setup):
    """The synchronous prefill + warming replay leaves the same logits,
    cache state and counters as a ticket advanced chunk by chunk."""
    cfg, params = setup
    prompt = _prompts(cfg, 1, seed=9)[0]
    a = _engine(cfg, params, slots=1, prefill_chunk=4)
    logits, state = a.prefill_chunked(prompt)
    b = _engine(cfg, params, slots=1, prefill_chunk=4)
    ticket = b.start_prefill(prompt)
    while not b.advance_prefill(ticket):
        pass
    assert torch.equal(logits, ticket.logits)
    assert int(state["pos"]) == len(prompt)
    for x, y in zip(a.tiers.state, b.tiers.state):
        assert torch.equal(x, y)
    assert a.stats == b.stats
    assert a.stats.prefill_chunks == -(-len(prompt) // 4)
    assert a.stats.prefill_tokens == len(prompt)
    assert a.stats.prefill_accesses == \
        len(prompt) * cfg.num_layers * cfg.moe.top_k
    with pytest.raises(ValueError, match="chunk"):
        a.prefill_chunked(prompt, chunk=0)


def _submit_mixed(sched, cfg, long_len=48, seed=11):
    rng = np.random.default_rng(seed)
    est = [sched.submit(rng.integers(0, cfg.vocab_size, 6),
                        max_new_tokens=16) for _ in range(2)]
    sched.step()
    while sched.prefill_pending:
        sched.step()
    newcomer = sched.submit(rng.integers(0, cfg.vocab_size, long_len),
                            max_new_tokens=6)
    return est, newcomer


def test_overlapped_admission_tokens_bit_identical(setup):
    cfg, params = setup

    def run(admit_chunks):
        eng = _engine(cfg, params, slots=3, capacity=96, prefill_chunk=4,
                      admit_chunks_per_tick=admit_chunks)
        sched = ContinuousBatchingScheduler(eng)
        _submit_mixed(sched, cfg)
        return sched.run(), sched.stats

    outs_sync, s_sync = run(0)
    outs_over, s_over = run(1)
    assert sorted(outs_sync) == sorted(outs_over)
    for rid in outs_sync:
        np.testing.assert_array_equal(outs_sync[rid], outs_over[rid])
    assert s_over.prefill_chunks == s_sync.prefill_chunks
    assert s_over.prefill_accesses == s_sync.prefill_accesses


def test_overlapped_admission_decodes_established_while_warming(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=3, capacity=96, prefill_chunk=4,
                  admit_chunks_per_tick=1)
    sched = ContinuousBatchingScheduler(eng)
    est, newcomer = _submit_mixed(sched, cfg)     # 48 tokens -> 12 chunks
    est_before = [len(r.generated) for r in est]
    chunks_before = eng.stats.prefill_chunks
    sched.step()
    assert sched.prefill_pending == 1 and len(newcomer.generated) == 1
    assert eng.stats.prefill_chunks == chunks_before + 1
    warm_ticks = 0
    while sched.prefill_pending:
        n_est = [len(r.generated) for r in est]
        sched.step()
        warm_ticks += 1
        assert [len(r.generated) for r in est] == [n + 1 for n in n_est]
    assert warm_ticks == 11
    assert len(newcomer.generated) == 2
    assert [len(r.generated) for r in est] == [n + 12 for n in est_before]
    assert len(sched.run()[newcomer.rid]) == 6


def test_bounded_queue_rejects_and_blocks(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=1)
    sched = ContinuousBatchingScheduler(eng, max_queue=1)
    prompts = _prompts(cfg, 4, seed=21)
    r0 = sched.submit(prompts[0], max_new_tokens=2)
    sched.step()
    r1 = sched.submit(prompts[1], max_new_tokens=2)
    with pytest.raises(QueueFull, match="max_queue"):
        sched.submit(prompts[2], max_new_tokens=2, block=False)
    assert sched.stats.queue_rejected == 1
    r3 = sched.submit(prompts[3], max_new_tokens=2)
    outs = sched.run()
    assert sorted(outs) == [r0.rid, r1.rid, r3.rid]
    with pytest.raises(ValueError, match="max_queue"):
        ContinuousBatchingScheduler(eng, max_queue=0)


def test_seeded_sampling_reproduces_per_request(setup):
    """A request's draws follow its own seed: the same stream twice gives
    the same tokens, another seed other tokens."""
    cfg, params = setup

    def run(seed):
        sched = ContinuousBatchingScheduler(_engine(cfg, params, slots=2))
        for i, p in enumerate(_prompts(cfg, 3, seed=8)):
            sched.submit(p, max_new_tokens=6, sampling=SamplingParams(
                greedy=False, temperature=1.0, seed=seed + i))
        return sched.run()

    a, b, c = run(5), run(5), run(50)
    assert all(np.array_equal(a[r], b[r]) for r in a)
    assert any(not np.array_equal(a[r], c[r]) for r in a)


def test_decode_steps_add_to_the_counters_their_stats_name(setup):
    """The engine's counter record holds exactly EngineStats' integer
    fields, and each decode step, with prefetch and the host lane on, adds
    to exactly the counters its per-layer stats name (the reference's
    ``host_flops_assignments`` to ``host_assignments``), and one step and
    its active tokens; no other counter moves."""
    cfg, params = setup
    engine = _engine(cfg, params, slots=2, prefetch=True, host_compute=True)
    ints = {k for k, t in typing.get_type_hints(EngineStats).items()
            if t is int}
    assert set(engine._counters) == ints
    seen, accumulate = [], engine._accumulate

    def spy(stats, n_active):
        before = dict(engine._counters)
        accumulate(stats, n_active)
        seen.append((stats, n_active, before, dict(engine._counters)))

    engine._accumulate = spy
    sched = ContinuousBatchingScheduler(engine)
    for p in _prompts(cfg, 3, seed=4):
        sched.submit(p, max_new_tokens=4)
    sched.run()
    assert seen
    for stats, n_active, before, after in seen:
        want = dict.fromkeys(after, 0)
        for s in stats:
            assert {"hits", "cpu_expert_calls", "stage_h2d_bytes",
                    "prefetch_issued", "predicted"} <= set(s)
            for k, v in s.items():
                want[{"host_flops_assignments": "host_assignments"}.get(
                    k, k)] += v
        want["tokens"] += n_active
        want["steps"] += 1
        assert {k: after[k] - before[k] for k in after} == want
    assert seen[-1][3]["accesses"] > 0


@pytest.mark.parametrize("name", ["host_compute", "prefetch"])
def test_unported_engine_options_raise(name):
    """Prefetch and the host lane are ported: the option runs; what still
    raises is the reference's in-graph host backend, which has no PyTorch
    meaning."""
    EngineConfig(cache=CacheConfig(num_indexes=1, num_ways=2), **{name: True})
    with pytest.raises(NotImplementedError, match="host_backend"):
        EngineConfig(cache=CacheConfig(num_indexes=1, num_ways=2),
                     host_backend="jax", **{name: True})


@pytest.mark.parametrize("flag", ["--prefetch", "--host-compute",
                                  "--prefetch-min-prob=0.5",
                                  "--host-threads=4", "--trace-out=t.json"])
def test_unported_serve_flags_raise(flag, capsys):
    """No serve flag is left unported: the prefetch, host lane and
    tracing flags parse, and --host-backend jax is an error with its
    reason."""
    args = serve_cli.parse_args([flag])
    assert args.trace_out == ("t.json" if flag.startswith("--trace-out")
                              else None)
    with pytest.raises(SystemExit):
        serve_cli.parse_args([flag, "--host-backend", "jax"])
    assert "no PyTorch meaning" in capsys.readouterr().err


def test_build_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("mixtral-8x7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--tokens", "2"])


def test_serve_entry_point_runs_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--tokens", "3", "--prompt", "6",
                    "--requests", "3", "--concurrency", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    assert "cache hit rate" in out
