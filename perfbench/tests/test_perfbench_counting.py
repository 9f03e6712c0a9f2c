"""The frozen counts against hand counts, the trace reduction, and each
per-layer reader on a hand-made reading."""
import json
from collections import namedtuple

import pytest

from perfbench import devtrace, manifest, roofline, window
from perfbench.devtrace import Op
from perfbench.reading import Reading
from perfbench.window import Served

MIXTRAL = json.loads((manifest.ROOT / "perfbench/configs/"
                      "mixtral-8x7b-l24.json").read_text())
Ev = namedtuple("Ev", "kind track name ts_ns dur_ns args")


def test_kernel_work_by_hand():
    b, o = roofline.swiglu_work(2, 2, 4096, 14336)
    assert b == 2 * (2 * 2 * 4096 + 2 * 2 * 4096 * 14336 + 2 * 2 * 14336)
    assert o == 4 * 2 * 2 * 4096 * 14336
    b, o = roofline.gmm_work(2, 2, 14336, 4096)
    assert b == 2 * (2 * 2 * 14336 + 2 * 14336 * 4096 + 2 * 2 * 4096)
    assert o == 2 * 2 * 2 * 14336 * 4096
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound_s(1.0, 989e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_active_parameters_by_hand():
    attn = 4096 * 128 * (32 + 2 * 8) + 32 * 128 * 4096
    layer = attn + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert roofline.active_params_per_token(MIXTRAL) == \
        24 * layer + 32000 * 4096 == 9_594_208_256


def test_active_parameters_match_the_ports_count():
    """The port's analytic count (``ModelConfig.param_count``) counts the
    input embedding too, which a decode token only looks up."""
    from perfbench.systems.collaborative_engine import model_config
    for name in ("mixtral-8x7b-l24",):
        cfg = json.loads((manifest.ROOT / f"perfbench/configs/{name}.json")
                         .read_text())
        cfg["name"] = name
        mc = model_config(cfg)
        assert roofline.active_params_per_token(cfg) == \
            mc.param_count(active_only=True) - mc.vocab_size * mc.d_model


def test_decode_flops_by_hand():
    a = roofline.active_params_per_token(MIXTRAL)
    f = roofline.decode_flops(MIXTRAL, [100, 101])
    assert f == 2 * a * 2 + 4 * 32 * 128 * 24 * 201


def ops(*spec):
    return [Op(name=n, cat=c, t0=a, t1=b, stream=s, nbytes=nb)
            for n, c, a, b, s, nb in spec]


def test_busy_and_idle_union_every_stream():
    o = ops(("k", "kernel", 10, 20, 7, 0), ("m", "gpu_memcpy", 15, 30, 9, 4),
            ("k", "kernel", 40, 50, 7, 0))
    assert devtrace.busy_intervals(o, 0, 45) == [(10, 30), (40, 45)]
    assert devtrace.busy_ns(o, 0, 60) == 30
    assert devtrace.idle_intervals(o, 0, 60) == [(0, 10), (30, 40), (50, 60)]
    assert devtrace.top_ops(o) == [["k", 20e-9], ["m", 15e-9]]


def test_copy_bytes_inside_spans():
    o = ops(("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 0, 100, 7, 1000),
            ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 0, 100, 7, 50),
            ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 200, 300, 9, 10))
    assert devtrace.overlap_bytes(o, [(50, 120), (250, 260)]) == \
        pytest.approx(500 + 1)
    assert devtrace.overlap_bytes(o, []) == 0


def test_gaps_named_by_the_shortest_host_span():
    spans = {"sched:tick": [(0, 100)], "engine:dispatch": [(10, 40)]}
    got = devtrace.label_gaps([(20, 30), (50, 70), (150, 160)], spans)
    assert got == [["sched:tick", 20e-9], ["engine:dispatch", 10e-9],
                   ["no span", 10e-9]]


def test_trace_aligned_by_the_two_synchronize_calls(tmp_path):
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": devtrace.SYNC,
           "ts": 100.0, "dur": 1},          # the profiler's own, at start
          {"ph": "X", "cat": "cuda_runtime", "name": devtrace.SYNC,
           "ts": 1000.0, "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "gmm_tma_kernel<1>",
           "ts": 1500.0, "dur": 2.0, "args": {"stream": 7}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 1600.0, "dur": 4.0, "args": {"stream": 9, "bytes": 64}},
          {"ph": "X", "cat": "cuda_runtime", "name": devtrace.SYNC,
           "ts": 3000.0, "dur": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": devtrace.SYNC,
           "ts": 3900.0, "dur": 1}]         # and at its stop
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    # the calls' starts are the host's readings before each synchronize
    d = devtrace.load(p, [(5_000, 7_000), (2_005_000, 2_050_000)])
    assert d.scale == pytest.approx(1.0)
    assert [(o.t0, o.t1, o.stream, o.nbytes) for o in d.ops] == [
        (505_000, 507_000, 7, 0), (605_000, 609_000, 9, 64)]
    # a trace clock 0.5% fast: the host's times come back through both
    d = devtrace.load(p, [(5_000, 7_000), (1_995_000, 1_997_000)])
    assert d.scale == pytest.approx(0.995)
    assert [(o.t0, o.t1) for o in d.ops] == [(502_500, 504_490),
                                            (602_000, 605_980)]
    # no pair of synchronize calls as far apart as the marks: no reading
    assert devtrace.load(p, [(0, 1), (9_000_000, 9_000_001)]) is None
    p.write_text(json.dumps({"traceEvents": ev[2:4]}))
    assert devtrace.load(p, [(0, 1), (2, 3)]) is None


class Stats:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def reading(device=None, calls=(), events=(), served=()):
    s0 = Stats(hits=10, accesses=100, fetched_experts=50, tokens=10)
    s1 = Stats(hits=40, accesses=200, fetched_experts=110, tokens=30)
    return Reading(cfg=dict(MIXTRAL, name="m"), t0=0.0, t1=1.0,
                   served=list(served), events=list(events), stats0=s0,
                   stats1=s1, device=device, kernel_calls=list(calls))


def test_counter_readers():
    r = reading()
    assert manifest.reader("hit_rate")(r) == pytest.approx(30.0)
    assert manifest.reader("fetched_per_token")(r) == pytest.approx(3.0)


def test_window_readers_by_hand():
    """The rate and the gaps a user sees, read per layer from the traced
    window: a token or a gap counts only inside it."""
    a = Served(index=0, prompt_len=10, t_send=0.0,
               times=[0.1, 0.2, 0.4, 0.5, 1.2])
    b = Served(index=1, prompt_len=10, t_send=0.5, times=[0.7, 0.8])
    r = reading(served=[a, b])
    assert manifest.reader("served_tok_s")(r) == pytest.approx(6.0)
    gaps = [0.1, 0.2, 0.1, 0.1]
    assert manifest.reader("decode_gap_ms")(r) == pytest.approx(125.0)
    assert manifest.reader("decode_gap_p95_ms")(r) == pytest.approx(
        1e3 * window.p95(gaps))


def test_span_readers_keep_to_the_window():
    ev = [Ev("X", "req:3", "prefill", 100_000_000, 4_000_000, None),
          Ev("X", "req:4", "prefill", 200_000_000, 6_000_000, None),
          Ev("X", "req:5", "prefill", 2_000_000_000, 9_000_000, None),
          Ev("X", "engine", "dispatch", 300_000_000, 40_000_000, None),
          Ev("X", "engine", "warm_replay", 400_000_000, 2_000_000, None),
          Ev("X", "engine", "warm_replay", 500_000_000, 3_000_000, None)]
    r = reading(events=ev)
    assert manifest.reader("prefill_ms")(r) == pytest.approx(5.0)
    assert manifest.reader("dispatch_ms")(r) == pytest.approx(40.0)
    assert manifest.reader("warm_ms")(r) == pytest.approx(2.5)


def test_device_readers_on_a_made_trace():
    steps = [Ev("X", "sched", "decode+drain", 100_000_000, 50_000_000, None),
             Ev("X", "sched", "decode+drain", 200_000_000, 50_000_000, None)]
    o = ops(("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 110_000_000,
             140_000_000, 7, 1_600_000_000),
            ("gmm_tma_kernel<2, true, 128>", "kernel", 150_000_000,
             150_500_000, 7, 0),
            ("gmm_tma_kernel<2, false, 256>", "kernel", 151_000_000,
             151_250_000, 7, 0))
    dev = devtrace.DeviceTrace(ops=o, scale=1.0, syncs=2)
    calls = [("swiglu_gmm", 2, 2, 4096, 14336, 149_000_000),
             ("gmm", 2, 2, 14336, 4096, 150_600_000)]
    s = Served(index=0, prompt_len=100, t_send=0.0, times=[0.05, 0.15, 0.25])
    r = reading(device=dev, calls=calls, events=steps, served=[s])
    # 1.6 GB at 64 GB/s = 25 ms of 100 ms of decode steps
    assert manifest.reader("pcie_roofline")(r) == pytest.approx(25.0)
    bound = [roofline.bound_s(*roofline.WORK[c[0]](*c[1:5]))[0]
             for c in calls]
    assert manifest.reader("gmm_roofline")(r) == pytest.approx(
        100 * sum(bound) / 0.75e-3)
    flops = roofline.decode_flops(MIXTRAL, [101, 102])
    assert manifest.reader("decode_mfu")(r) == pytest.approx(
        100 * flops / (0.1 * 989e12))
    assert manifest.reader("device_idle")(r) == pytest.approx(
        100 * (1 - 30.75e-3))
    # a kernel the calls do not account for: read over the pairs alone
    r.kernel_calls = calls[:1]
    assert manifest.reader("gmm_roofline")(r) == pytest.approx(
        100 * bound[0] / 0.5e-3)


def test_gmm_calls_pair_with_kernels_in_launch_order():
    from perfbench.metrics import gmm_roofline
    k = [devtrace.Op("gmm_tma_kernel<1, true, 128>", "kernel", t, t + 10,
                     7, 0) for t in (100, 300, 500)]
    k += [devtrace.Op("gmm_scalar_kernel<1, false>", "kernel", t, t + 5,
                      7, 0) for t in (200, 400)]
    calls = [("swiglu_gmm", 1, 1, 8, 8, t) for t in (90, 290, 490)]
    calls += [("gmm", 1, 1, 8, 8, t) for t in (190, 390)]
    matched, unmatched = gmm_roofline.pairs(calls, k)
    assert unmatched == 0
    assert sorted((c[5], o.t0) for c, o in matched) == [
        (90, 100), (190, 200), (290, 300), (390, 400), (490, 500)]
    # the profiler dropped a kernel: its call is left over, the rest pair
    matched, unmatched = gmm_roofline.pairs(calls, k[1:])
    assert unmatched == 1 and len(matched) == 4
    # a kernel with no recorded call before it is skipped
    matched, unmatched = gmm_roofline.pairs(calls[1:], k)
    assert unmatched == 1
    assert [(c[5], o.t0) for c, o in matched if c[0] == "swiglu_gmm"] == [
        (290, 300), (490, 500)]


def test_readers_with_nothing_to_read_return_none():
    r = reading()
    r.stats1 = r.stats0
    for name in ("served_tok_s", "decode_gap_ms", "decode_gap_p95_ms",
                 "pcie_roofline", "gmm_roofline", "device_idle",
                 "decode_mfu", "prefill_ms", "dispatch_ms", "warm_ms",
                 "hit_rate",
                 "fetched_per_token"):
        assert manifest.reader(name)(r) is None, name
