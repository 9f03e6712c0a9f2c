"""The port's tracing (``repro_torch.obs``) against the reference's
(``repro.obs``).

Recorder mechanics and the Chrome export are mirrored case by case from
``tests/test_obs.py``. Then the reduced Mixtral is served by both
packages from the SAME weights (the reference's ``init_params``, carried
by ``repro_torch.bridge``), each with a ``TraceRecorder``, in three
modes: dense KV; paged KV with segment-streamed prefill, a prefix hit
and a fork; cross-layer prefetch with the CPU miss lane. What must hold:

* Structure: the set of (kind, track, name, arg keys) of the port's
  events equals the reference's. Two allowances: with the host lane, the
  reference's executor reports no busy time on the CPU backend, so it
  never emits its ``host_execute`` span; the port's does. And the port
  opens up its ``dispatch`` span, which the reference's jitted layer
  loop has no host phases for (``PORT_ONLY``): per-layer phase spans and
  a ``prefill_forward`` span per padded admission forward, whose args
  count its expert-table reads from the slots and from the host tier.
* The phases tile each layer inside their step's ``dispatch``, in layer
  order; their copy-byte args are the step's ``EngineStats`` deltas and
  a hand count from the probe results.
* Per-step lane split: each ``decode_step`` span's integer args
  (``tokens``, ``hit_experts``, ``fetched_experts``,
  ``cpu_expert_calls``) equal the reference's on every step of every
  tick before the first tick whose streamed tokens differ (the known
  near tie: request 5 at its 4th token, ROADMAP Queue 3), and equal the
  port's own ``EngineStats`` deltas on every step.
* Every prefill forward's expert reads (``EngineStats``'
  ``prefill_forward_resident`` / ``prefill_forward_experts`` /
  ``prefill_forward_ahead``, and the ``prefill_forward`` span's args)
  equal a hand count from ``cache.lookup`` on the cache state before it.
* Tracing is bit-neutral: the same tokens and counters with the
  recorder on and off.
* The trace validates, and every request's lifecycle is covered.
"""
import dataclasses
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.obs as jobs  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import build as jax_build  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch import build as torch_build  # noqa: E402
from repro_torch import hostexec  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.obs import (NULL_RECORDER, NoopRecorder,  # noqa: E402
                             TraceRecorder, chrome_trace,
                             validate_chrome_trace, write_chrome_trace)
from repro_torch.obs.export import LIFECYCLE_SPANS  # noqa: E402
from repro_torch.obs.export import lifecycle_coverage  # noqa: E402
from repro_torch.obs.export import main as validate_main  # noqa: E402
from repro_torch.obs.trace import now_ns  # noqa: E402
from test_torch_prefetch_parity import (NEW, PROMPT, PS,  # noqa: E402
                                        SLOTS, _requests)

torch.set_num_threads(2)

CACHE = dict(num_indexes=2, num_ways=2, policy="lru")
SERVING = {
    "dense": dict(max_batch=SLOTS, capacity=PROMPT + NEW + 1,
                  prefill_chunk=8),
    "paged": dict(max_batch=SLOTS, capacity=20, prefill_chunk=8,
                  kv_paged=True, page_size=PS, prefill_segment=4,
                  admit_chunks_per_tick=1, prefix_keep_pages=8),
    "host": dict(max_batch=SLOTS, capacity=PROMPT + NEW + 1,
                 prefill_chunk=8, prefetch=True, host_compute=True,
                 host_threads=8),
}
STEP_ARGS = ("tokens", "hit_experts", "fetched_experts", "cpu_expert_calls")
# the EngineStats field each decode_step arg is the per-step delta of
STEP_STATS = dict(tokens="tokens", hit_experts="hits",
                  fetched_experts="fetched_experts",
                  cpu_expert_calls="cpu_expert_calls")
# counters that are host wall time, not counts
TIMING = ("host_busy_us",)
# the engine's decode-layer phases, in order (prefetch with prefetch=True)
PHASES = ("attn_route", "picks", "probe", "execute", "post_fetch",
          "prefetch")
# the copy channel's counters, and the phase span whose d2d / h2d args
# carry each
COPY = {"stage_d2d_bytes": ("execute", "d2d_bytes"),
        "stage_h2d_bytes": ("execute", "h2d_bytes"),
        "slot_d2d_bytes": ("post_fetch", "d2d_bytes"),
        "slot_h2d_bytes": ("post_fetch", "h2d_bytes")}


# the prefill_forward span's args, and the counters of the forwards' reads
FORWARD_ARGS = ("ahead_experts", "d2d_bytes", "experts", "h2d_bytes",
                "resident_experts", "tokens")
FORWARD_READS = ("prefill_forward_resident", "prefill_forward_experts",
                 "prefill_forward_ahead")


def _port_only(mode):
    """Event shapes only the port emits (its host phases inside
    ``dispatch``; the padded forward's span where prefill is not
    segment-streamed)."""
    phases = PHASES if SERVING[mode].get("prefetch") else PHASES[:-1]
    args = {"execute": ("d2d_bytes", "h2d_bytes", "layer"),
            "post_fetch": ("d2d_bytes", "h2d_bytes", "layer")}
    out = {("X", "engine", p, args.get(p, ("layer",))) for p in phases}
    if not SERVING[mode].get("prefill_segment"):
        out.add(("X", "engine", "prefill_forward", FORWARD_ARGS))
    return out


# ---------------------------------------------------------------------------
# recorder mechanics (tests/test_obs.py's cases, against the port)
# ---------------------------------------------------------------------------

def test_obs_exports_the_reference_names():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in tobs.__all__:
        assert hasattr(tobs, name), name


def test_ring_buffer_wraparound_keeps_newest():
    rec = TraceRecorder(capacity=8)
    for i in range(20):
        rec.instant("t", f"ev{i}", ts_ns=rec.t0_ns + i)
    assert len(rec) == 8
    assert rec.dropped == 12
    names = [ev.name for ev in rec.events()]
    assert names == [f"ev{i}" for i in range(12, 20)]     # oldest-first
    ts = [ev.ts_ns for ev in rec.events()]
    assert ts == sorted(ts)


def test_recorder_capacity_validation_and_iter():
    with pytest.raises(ValueError):
        TraceRecorder(capacity=0)
    rec = TraceRecorder(capacity=4)
    rec.counter("t", "gauge", 3.5)
    (ev,) = list(rec)
    assert ev.kind == "C" and ev.args == {"value": 3.5}


def test_span_nesting_orders_child_before_parent():
    rec = TraceRecorder(capacity=16)
    with rec.span("t", "outer"):
        with rec.span("t", "inner", args={"k": 1}):
            pass
    inner, outer = rec.events()         # exit order: inner completes first
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.kind == outer.kind == "X"
    assert outer.ts_ns <= inner.ts_ns
    assert inner.ts_ns + inner.dur_ns <= outer.ts_ns + outer.dur_ns


def test_retroactive_complete_clamps_negative_duration():
    rec = TraceRecorder(capacity=4)
    t = now_ns()
    rec.complete("t", "span", t, t - 100)
    assert rec.events()[0].dur_ns == 0


def test_noop_recorder_is_inert():
    rec = NoopRecorder()
    assert not rec.enabled and len(rec) == 0
    rec.complete("t", "a", 0, 1)
    rec.instant("t", "b")
    rec.counter("t", "c", 1.0)
    with rec.span("t", "d"):
        pass
    assert rec.events() == [] and list(rec) == []
    assert NULL_RECORDER.enabled is False
    assert TraceRecorder().enabled is True


def test_trace_validator_flags_malformed_documents():
    assert validate_chrome_trace([]) != []
    assert validate_chrome_trace({"traceEvents": "nope"}) != []
    bad = {"traceEvents": [
        {"ph": "Z", "name": "x", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "X", "name": "y", "pid": 1, "tid": 2, "ts": -5},
    ]}
    problems = validate_chrome_trace(bad)
    assert any("unknown phase" in p for p in problems)
    assert any("bad ts" in p for p in problems)
    assert any("no thread_name" in p for p in problems)
    bad2 = {"traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "t"}},
        {"ph": "X", "name": "y", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "C", "name": "g", "pid": 1, "tid": 1, "ts": 0, "args": {}},
    ]}
    problems = validate_chrome_trace(bad2)
    assert any("without non-negative dur" in p for p in problems)
    assert any("without args.value" in p for p in problems)


def test_chrome_export_matches_the_reference_on_the_same_events():
    """The same events through both exporters: the same document."""
    trec, jrec = TraceRecorder(), jobs.TraceRecorder()
    jrec.t0_ns = trec.t0_ns
    for rec in (trec, jrec):
        t = rec.t0_ns
        rec.complete("req:10", "queued", t + 1000, t + 3000, {"a": 1})
        rec.complete("req:2", "decode", t + 2000, t + 2500)
        rec.instant("slot:1", "done", {"generated": 3}, ts_ns=t + 4000)
        rec.counter("lane:gpu", "hit_experts", 7, ts_ns=t + 5000)
        rec.complete("sched", "tick", t, t + 6000)
    assert chrome_trace(trec) == jobs.chrome_trace(jrec)
    assert LIFECYCLE_SPANS == jobs.export.LIFECYCLE_SPANS


# ---------------------------------------------------------------------------
# traced serving against the reference
# ---------------------------------------------------------------------------

def _drive(sched, vocab, paged):
    """Serve ``_requests``' stream (the paged run adds two requests that
    share request 0's first page) tick by tick; the paged run forks once
    the queue is empty. Returns (each tick's stream events, decode steps
    before each tick)."""
    for p, n in _requests(vocab, paged):
        sched.submit(p, max_new_tokens=n)
    ticks, steps_before = [], []
    forked = False
    while sched.queue or any(s is not None for s in sched.slots):
        steps_before.append(sched.engine._counters["steps"])
        _, events = sched._tick()
        ticks.append([(int(r), int(t), bool(d)) for r, t, d in events])
        if paged and not forked and not sched.queue:
            live = [r for t, r in enumerate(sched.slots)
                    if r is not None and sched._tickets[t] is None
                    and len(r.generated) <= r.max_new_tokens - 2]
            if live and None in sched.slots:
                sched.fork(min(live, key=lambda r: r.rid).rid)
                forked = True
    return ticks, steps_before


def _port_serve(tparams, mode, recorder):
    """The port's run; each decode step's EngineStats delta recorded (the
    copy channel's apart), and each of its layers' probe result and fetch
    mask; for each prefill forward, the experts ``cache.lookup`` finds
    resident on the state before it, of all it reads, and its delta of
    the forward-read counters."""
    tcfg = reduced(get_config("mixtral-8x7b"))
    engine, sched = torch_build(tcfg, cache=CACHE, serving=SERVING[mode],
                                params=tparams, seed=0, device="cpu",
                                recorder=recorder)
    deltas, copies, probes, forwards = [], [], [], []
    decode, commit = engine.decode_batch, tcollab.commit
    backbone = ttransformer.backbone
    L, E = tcfg.num_layers, tcfg.moe.num_experts

    def seen_backbone(*a, **k):
        state, before = engine.tiers.state, dataclasses.asdict(engine.stats)
        hand = sum(int(tcache.lookup(state, layer, torch.arange(
            E, dtype=torch.int32))[0].sum()) for layer in range(L))
        out = backbone(*a, **k)
        after = dataclasses.asdict(engine.stats)
        forwards.append(((hand, L * E, L * E - hand),
                         tuple(after[f] - before[f] for f in FORWARD_READS)))
        return out

    def seen_commit(tiers, layer, pr, staged, ccfg):
        tiers, fetch = commit(tiers, layer, pr, staged, ccfg)
        probes[-1].append((pr, fetch))
        return tiers, fetch

    def decode_batch(*a):
        before = dataclasses.asdict(engine.stats)
        probes.append([])
        tcollab.commit = seen_commit
        try:
            out = decode(*a)
        finally:
            tcollab.commit = commit
        after = dataclasses.asdict(engine.stats)
        deltas.append({arg: after[f] - before[f]
                       for arg, f in STEP_STATS.items()})
        copies.append({k: after[k] - before[k] for k in COPY})
        return out

    engine.decode_batch = decode_batch
    ttransformer.backbone = seen_backbone
    try:
        ticks, steps_before = _drive(sched, tcfg.vocab_size, mode == "paged")
    finally:
        ttransformer.backbone = backbone
    if engine.host_executor is not None:
        engine.host_executor.close()
    return dict(sched=sched, engine=engine, ticks=ticks,
                steps_before=steps_before, deltas=deltas, copies=copies,
                probes=probes, forwards=forwards)


def _serve(mode):
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jrec = jobs.TraceRecorder()
    _, jsched = jax_build(jcfg, cache=CACHE, serving=SERVING[mode],
                          params=jparams, seed=0, recorder=jrec)
    jticks, _ = _drive(jsched, jcfg.vocab_size, mode == "paged")
    trec = TraceRecorder()
    traced = _port_serve(tparams, mode, trec)
    plain = _port_serve(tparams, mode, None)
    return dict(jrec=jrec, jsched=jsched, jticks=jticks, trec=trec,
                traced=traced, plain=plain)


@pytest.fixture(scope="module", params=["dense", "paged", "host"])
def runs(request):
    return request.param, _serve(request.param)


def _shape(ev):
    return (ev.kind, ev.track, ev.name,
            None if ev.args is None else tuple(sorted(ev.args)))


def _decode_steps(rec):
    return [ev.args for ev in rec.events()
            if ev.track == "engine" and ev.name == "decode_step"]


def test_trace_structure_matches_reference(runs):
    mode, r = runs
    got = {_shape(ev) for ev in r["trec"].events()}
    want = {_shape(ev) for ev in r["jrec"].events()}
    if mode == "host":
        # the reference's executor reports no busy time on the CPU
        # backend, so its drain never places a host_execute span; the
        # port's thread pool is timed, and its span is the one addition
        assert r["jsched"].stats.host_busy_us == 0
        assert r["traced"]["sched"].stats.host_busy_us > 0
        want = want | {("X", "lane:cpu", "host_execute", ("queue_peak",))}
    want = want | _port_only(mode)
    assert got == want, (sorted(got - want), sorted(want - got))
    names = {ev.name for ev in r["trec"].events()}
    expect = {"decode_step", "dispatch", "execute+drain", "tick",
              "admission", "decode+drain", "queued", "prefill", "decode",
              "done", "occupied", "hit_experts", "fetched_experts",
              "cpu_expert_calls"}
    expect |= {"dense": {"warm_replay"},
               "paged": {"plan", "commit", "segment_stream",
                         "kv_pages_in_use", "prefix_hits", "cow_forks"},
               "host": {"warm_replay", "prefetch_reserve",
                        "host_execute"}}[mode]
    assert expect <= names, sorted(expect - names)
    assert r["trec"].dropped == 0 and r["jrec"].dropped == 0


def test_step_args_match_reference_and_own_stats(runs):
    mode, r = runs
    tsteps, jsteps = _decode_steps(r["trec"]), _decode_steps(r["jrec"])
    deltas = r["traced"]["deltas"]
    assert len(tsteps) == len(deltas) == len(jsteps)
    for i, (args, d) in enumerate(zip(tsteps, deltas)):
        assert {k: args[k] for k in STEP_ARGS} == d, f"step {i}"
    jt, tt = r["jticks"], r["traced"]["ticks"]
    assert len(jt) == len(tt)
    first = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b),
                 len(tt))
    n = r["traced"]["steps_before"][first] if first < len(tt) \
        else len(tsteps)
    for i in range(n):
        assert {k: tsteps[i][k] for k in STEP_ARGS} == \
            {k: jsteps[i][k] for k in STEP_ARGS}, f"step {i}"
    print(f"\n{mode}: per-step args equal on {n} of {len(tsteps)} decode "
          f"steps (first tick with other tokens: {first} of {len(tt)})")
    assert n > 0


def test_tracing_is_bit_neutral(runs):
    _, r = runs
    traced, plain = r["traced"], r["plain"]
    assert traced["ticks"] == plain["ticks"]
    assert traced["deltas"] == plain["deltas"]
    a = dataclasses.asdict(traced["sched"].stats.engine)
    b = dataclasses.asdict(plain["sched"].stats.engine)
    for k in TIMING:
        a.pop(k, None)
        b.pop(k, None)
    assert a == b


def test_trace_validates_and_covers_every_request(runs, tmp_path):
    _, r = runs
    doc = chrome_trace(r["trec"])
    assert validate_chrome_trace(doc) == []
    cover = lifecycle_coverage(doc)
    assert len(cover) == r["traced"]["sched"].stats.requests_finished
    for track, spans in cover.items():
        assert set(LIFECYCLE_SPANS) <= spans, (track, spans)
    path = tmp_path / "trace.json"
    write_chrome_trace(r["trec"], str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    assert validate_main([str(path), "--require-lifecycle"]) == 0


def _engine_spans(rec, names):
    return [ev for ev in rec.events()
            if ev.track == "engine" and ev.name in names]


def _step_phases(r, mode):
    """Each decode step's ``dispatch`` span and its phase spans, in
    emission order, and the phase names a layer."""
    rec = r["trec"]
    L = r["traced"]["engine"].cfg.num_layers
    names = PHASES if SERVING[mode].get("prefetch") else PHASES[:-1]
    steps = _engine_spans(rec, ("dispatch",))
    phases = _engine_spans(rec, PHASES)
    n = L * len(names)
    assert len(phases) == n * len(steps)
    return [(d, phases[i * n:(i + 1) * n])
            for i, d in enumerate(steps)], names, L


def _check_tiling(steps, names, L):
    """Each step's phase spans lie inside its ``dispatch``, in layer
    order, back to back within a layer and without overlap. Returns the
    share of each ``dispatch`` they cover."""
    cover = []
    for disp, ph in steps:
        assert [(ev.name, ev.args["layer"]) for ev in ph] == \
            [(name, layer) for layer in range(L) for name in names]
        assert disp.ts_ns <= ph[0].ts_ns
        assert ph[-1].ts_ns + ph[-1].dur_ns <= disp.ts_ns + disp.dur_ns
        for i, (a, b) in enumerate(zip(ph, ph[1:])):
            if (i + 1) % len(names):            # the same layer
                assert a.ts_ns + a.dur_ns == b.ts_ns, (a, b)
            else:
                assert a.ts_ns + a.dur_ns <= b.ts_ns, (a, b)
        cover.append(sum(ev.dur_ns for ev in ph) / max(disp.dur_ns, 1))
    return cover


def test_layer_phases_tile_each_step_inside_dispatch(runs):
    """The phases tile each layer inside their step's ``dispatch``, in
    layer order; ``prefetch`` appears only with prefetch on."""
    mode, r = runs
    steps, names, L = _step_phases(r, mode)
    assert steps
    seen = {ev.name for _, ph in steps for ev in ph}
    assert ("prefetch" in seen) == bool(SERVING[mode].get("prefetch"))
    cover = _check_tiling(steps, names, L)
    print(f"\n{mode}: the phases cover {min(cover):.3f}-{max(cover):.3f} "
          f"of dispatch over {len(steps)} steps of {L} layers")


def test_layer_phases_cover_dispatch():
    """All but the embedding before the first layer and the final norm
    and logits after the last: at least 95% of the median step's
    ``dispatch`` on the CPU, with 8 of the reduced Mixtral's layers (at 2
    those fixed costs alone come near 5%). The median, since a loaded host
    can stall any one step inside those gaps (one step of 14 read 0.82
    beside test workers)."""
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              num_layers=8)
    rec = TraceRecorder()
    _, sched = torch_build(cfg, cache=dict(num_indexes=8, num_ways=2),
                           serving=SERVING["dense"], seed=0, device="cpu",
                           recorder=rec)
    for p, n in _requests(cfg.vocab_size, False):
        sched.submit(p, max_new_tokens=n)
    sched.run()
    r = {"trec": rec, "traced": {"engine": sched.engine}}
    steps, names, L = _step_phases(r, "dense")
    cover = _check_tiling(steps, names, L)
    print(f"\nthe phases cover {min(cover):.3f}-{max(cover):.3f} of "
          f"dispatch over {len(steps)} steps of {L} layers")
    assert len(steps) >= NEW - 1 and np.median(cover) >= 0.95


def test_copy_bytes_match_stats_and_a_hand_count(runs):
    """Each step's ``execute`` / ``post_fetch`` byte args sum to its
    ``EngineStats`` deltas of the four copy counters, and those equal a
    hand count from the probe results: a live group the host lane does
    not take is staged, from the slot buffer if resident, else from the
    host tier; a fetched group that was staged from the host tier is
    written from the staging buffer, any other from the host tier; an
    expert's w1 + w3 + w2 each time."""
    mode, r = runs
    engine = r["traced"]["engine"]
    w1, w3, w2 = engine.tiers.host
    nbytes = (w1[0, 0].numel() + w3[0, 0].numel() + w2[0, 0].numel()) * 2
    steps, _, _ = _step_phases(r, mode)
    copies, probes = r["traced"]["copies"], r["traced"]["probes"]
    assert len(steps) == len(copies) == len(probes)
    total = dict.fromkeys(COPY, 0)
    for i, ((_, ph), d, layers) in enumerate(zip(steps, copies, probes)):
        args = {k: sum(ev.args[a] for ev in ph if ev.name == name)
                for k, (name, a) in COPY.items()}
        assert args == d, f"step {i}"
        hand = dict.fromkeys(COPY, 0)
        for pr, fetch in layers:
            live = pr.rep_e >= 0
            if engine.host_executor is not None:
                to_cpu, _ = hostexec.dispatch_plan(pr, engine._cpu_table)
            else:
                to_cpu = torch.zeros_like(live)
            staged = live & ~to_cpu
            from_host = staged & ~pr.resident
            hand["stage_d2d_bytes"] += int((staged & pr.resident).sum())
            hand["stage_h2d_bytes"] += int(from_host.sum())
            hand["slot_d2d_bytes"] += int((fetch & from_host).sum())
            hand["slot_h2d_bytes"] += int((fetch & ~from_host).sum())
        assert {k: v * nbytes for k, v in hand.items()} == d, f"step {i}"
        for k in COPY:
            total[k] += d[k]
    stats = r["traced"]["sched"].stats
    assert total == {k: getattr(stats, k) for k in COPY}
    print(f"\n{mode}: copies over {len(steps)} steps, in experts: "
          + ", ".join(f"{k} {v // nbytes}" for k, v in total.items()))
    assert total["stage_d2d_bytes"] > 0 and total["stage_h2d_bytes"] > 0
    assert total["slot_d2d_bytes"] + total["slot_h2d_bytes"] > 0


def test_prefill_forward_once_per_admission(runs):
    """One ``prefill_forward`` span per admitted request, inside its
    tick's ``admission``, with the prompt's tokens and, as its reads and
    bytes, the hand count of the forward it times: of every layer's E
    experts, those ``cache.lookup`` finds resident before it from the
    slots, the others from the host tier, each of those queued a layer
    ahead (``ahead_experts``); none where the prompt is segment-streamed
    (its forward is the ``segment_stream`` spans)."""
    mode, r = runs
    rec, sched = r["trec"], r["traced"]["sched"]
    spans = _engine_spans(rec, ("prefill_forward",))
    if SERVING[mode].get("prefill_segment"):
        assert spans == []
        return
    assert len(spans) == sched.stats.requests_submitted
    tiers = r["traced"]["engine"].tiers
    expert = sum(h[0, 0].numel() for h in tiers.host) * 2
    forwards = r["traced"]["forwards"]
    assert len(forwards) == len(spans)
    admissions = [ev for ev in rec.events()
                  if ev.track == "sched" and ev.name == "admission"]
    prompts = sorted(len(p) for p, _ in _requests(
        r["traced"]["engine"].cfg.vocab_size, False))
    assert sorted(ev.args["tokens"] for ev in spans) == prompts
    for ev, ((resident, total, ahead), _) in zip(spans, forwards):
        assert (ev.args["resident_experts"], ev.args["experts"],
                ev.args["ahead_experts"]) == (resident, total, ahead)
        assert ev.args["d2d_bytes"] == resident * expert
        assert ev.args["h2d_bytes"] == (total - resident) * expert
        assert any(a.ts_ns <= ev.ts_ns and
                   ev.ts_ns + ev.dur_ns <= a.ts_ns + a.dur_ns
                   for a in admissions)


def test_prefill_forward_reads_match_a_hand_count(runs):
    """Every prefill forward (each admission's, or each streamed
    segment's) adds to ``prefill_forward_resident`` /
    ``prefill_forward_experts`` / ``prefill_forward_ahead`` the experts
    ``cache.lookup`` finds resident on the state before it, every layer's
    E, and the others, each queued a layer ahead; the run's counters are
    their sums, and some reads came from the slots."""
    mode, r = runs
    forwards = r["traced"]["forwards"]
    assert forwards
    for i, (hand, counted) in enumerate(forwards):
        assert counted == hand, f"forward {i}"
    stats = r["traced"]["sched"].stats
    resident, total, ahead = (sum(c) for c in zip(*(h for h, _ in forwards)))
    assert (stats.prefill_forward_resident, stats.prefill_forward_experts,
            stats.prefill_forward_ahead) == (resident, total, ahead)
    assert 0 < resident < total and ahead == total - resident
    print(f"\n{mode}: {len(forwards)} forwards read {resident} of {total} "
          f"experts from the slots")


def test_host_execute_lies_inside_its_steps_dispatch(runs):
    """The host lane's span bounds where the pool ran in the step: inside
    that step's ``dispatch``, not ending at the drain (without the host
    lane there is none)."""
    mode, r = runs
    rec = r["trec"]
    steps = _engine_spans(rec, ("dispatch",))
    host = [ev for ev in rec.events()
            if ev.track == "lane:cpu" and ev.name == "host_execute"]
    assert bool(host) == bool(SERVING[mode].get("host_compute"))
    for ev in host:
        assert any(d.ts_ns <= ev.ts_ns and
                   ev.ts_ns + ev.dur_ns <= d.ts_ns + d.dur_ns
                   for d in steps), ev


def test_cancelled_request_gets_terminal_instant():
    cfg = reduced(get_config("mixtral-8x7b"))
    rec = TraceRecorder()
    _, sched = torch_build(cfg, cache=dict(num_ways=4),
                           serving=dict(capacity=64, max_batch=1,
                                        prefill_chunk=4),
                           seed=0, recorder=rec, device="cpu")
    rng = np.random.default_rng(3)
    keep = sched.submit(rng.integers(0, cfg.vocab_size, 6),
                        max_new_tokens=4)
    gone = sched.submit(rng.integers(0, cfg.vocab_size, 6),
                        max_new_tokens=4)
    assert sched.cancel(gone.rid)
    sched.run()
    doc = chrome_trace(rec)
    assert validate_chrome_trace(doc) == []
    names_by_tid = {ev["tid"]: ev["args"]["name"]
                    for ev in doc["traceEvents"] if ev.get("ph") == "M"}
    instants = {(names_by_tid[ev["tid"]], ev["name"])
                for ev in doc["traceEvents"] if ev.get("ph") == "i"}
    assert (f"req:{gone.rid}", "cancelled") in instants
    assert (f"req:{keep.rid}", "done") in instants
    cover = lifecycle_coverage(doc)
    assert "queued" in cover[f"req:{gone.rid}"]
    assert "decode" not in cover[f"req:{gone.rid}"]
    assert {"queued", "prefill", "decode"} <= cover[f"req:{keep.rid}"]


def test_trace_orders_step_phases_within_tick():
    cfg = reduced(get_config("mixtral-8x7b"))
    rec = TraceRecorder()
    _, sched = torch_build(cfg, cache=dict(num_ways=4),
                           serving=dict(capacity=64, max_batch=2,
                                        prefill_chunk=4),
                           seed=0, recorder=rec, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        sched.submit(rng.integers(0, cfg.vocab_size,
                                  int(rng.integers(5, 9))),
                     max_new_tokens=5)
    sched.run()
    by_track = {}
    for ev in rec.events():
        by_track.setdefault(ev.track, []).append(ev)
    ticks = [ev for ev in by_track["sched"] if ev.name == "tick"]
    assert ticks
    for ev in by_track["sched"]:
        if ev.name in ("admission", "decode+drain"):
            assert any(t.ts_ns <= ev.ts_ns
                       and ev.ts_ns + ev.dur_ns <= t.ts_ns + t.dur_ns + 1
                       for t in ticks), ev.name
    # each decode step's phases tile the step
    steps = [ev for ev in by_track["engine"] if ev.name == "decode_step"]
    phases = [ev for ev in by_track["engine"]
              if ev.name in ("dispatch", "execute+drain")]
    assert steps and len(phases) == 2 * len(steps)
    for step, (disp, rest) in zip(steps, zip(phases[::2], phases[1::2])):
        assert disp.ts_ns >= step.ts_ns
        assert rest.ts_ns + rest.dur_ns == step.ts_ns + step.dur_ns


def test_serve_trace_out_passes_the_export_validator(tmp_path, capsys):
    """``repro_torch.launch.serve --device cpu --trace-out`` then
    ``python -m repro_torch.obs.export PATH --require-lifecycle``."""
    path = tmp_path / "T.json"
    serve_cli.main(["--device", "cpu", "--tokens", "3", "--prompt", "6",
                    "--requests", "3", "--concurrency", "2",
                    "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert f"-> {path}" in out and "(0 dropped)" in out
    assert validate_main([str(path), "--require-lifecycle"]) == 0
    assert "3 request track(s): OK" in capsys.readouterr().out
