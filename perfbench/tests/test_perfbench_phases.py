"""The engine's per-layer phase, copy-byte and prefill-forward readers: on
hand-made readings, with nothing to read, and over the spans and counters
a traced run of the tiny cell's program leaves."""
import json
from collections import namedtuple

import pytest

from perfbench import devtrace, harness, manifest, traffic, weights
from perfbench.devtrace import Op
from perfbench.reading import Reading
from perfbench.tests import tiny

MIXTRAL = json.loads((manifest.ROOT / "perfbench/configs/"
                      "mixtral-8x7b-l24.json").read_text())
Ev = namedtuple("Ev", "kind track name ts_ns dur_ns args")

PHASES = ("attn_route", "picks", "probe", "execute", "post_fetch")
NEW = ("attn_route_ms", "picks_wait_ms", "probe_ms", "execute_ms",
       "post_fetch_ms", "layer_idle_ms", "d2d_mb_per_token",
       "h2d_mb_per_token", "prefill_forward_ms")
COPIES = ("stage_d2d_bytes", "stage_h2d_bytes", "slot_d2d_bytes",
          "slot_h2d_bytes")
MS = 1_000_000


class Stats:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def no_ops():
    """A device trace in which the device did nothing."""
    return devtrace.DeviceTrace(ops=[], scale=1.0, syncs=2)


def reading(device=None, events=(), s0=None, s1=None):
    s0 = Stats(hits=10, accesses=100, fetched_experts=50, tokens=10,
               **(s0 or {}))
    s1 = Stats(hits=40, accesses=200, fetched_experts=110, tokens=30,
               **(s1 or {}))
    return Reading(cfg=dict(MIXTRAL, name="m"), t0=0.0, t1=1.0, served=[],
                   events=list(events), stats0=s0, stats1=s1,
                   device=device, kernel_calls=[])


def layer_loop(t0, widths, layers=2, step="dispatch"):
    """A decode step's events: its ``dispatch`` span from ``t0`` and, 1 ms
    in, ``layers`` layers of phase spans ``widths`` ms long each, back to
    back, then 1 ms more."""
    ev, t = [], t0 + MS
    for layer in range(layers):
        for name, w in zip(PHASES, widths):
            ev.append(Ev("X", "engine", name, t, w * MS, {"layer": layer}))
            t += w * MS
    return [Ev("X", "engine", step, t0, t + MS - t0, None)] + ev


def test_phase_readers_sum_a_step_and_keep_to_the_window():
    """Each phase reader: its spans summed over a step's layers, the mean
    over the window's steps; spans outside the window, or outside any
    step, count for nothing."""
    ev = (layer_loop(100 * MS, (1, 10, 2, 3, 4))
          + layer_loop(200 * MS, (3, 20, 4, 5, 6))
          + layer_loop(2000 * MS, (50, 50, 50, 50, 50))   # after t1
          + [Ev("X", "engine", "probe", 500 * MS, 9 * MS,
                {"layer": 0})])                          # in no step
    r = reading(device=no_ops(), events=ev)
    want = {"attn_route_ms": 4.0, "picks_wait_ms": 30.0, "probe_ms": 6.0,
            "execute_ms": 8.0, "post_fetch_ms": 10.0}
    for name, v in want.items():
        assert manifest.reader(name)(r) == pytest.approx(v), name
    # the five tile each step's layer loop: their sum is dispatch_ms less
    # the 2 ms before the first layer and after the last
    assert sum(want.values()) == pytest.approx(
        manifest.reader("dispatch_ms")(r) - 2.0)


def test_layer_idle_counts_idle_under_the_host_phases_only():
    """Device idle under attn_route / probe / execute / post_fetch counts;
    idle under picks (the host waits on the device), before the first
    layer and after the last does not."""
    ev = layer_loop(100 * MS, (2, 4, 2, 2, 2), layers=1)
    # phases: attn_route 101-103, picks 103-107, probe 107-109,
    # execute 109-111, post_fetch 111-113; dispatch 100-114
    o = [Op("k", "kernel", 102 * MS, 106 * MS, 7, 0),
         Op("m", "gpu_memcpy", 108 * MS, 110 * MS, 9, 4),
         Op("k", "kernel", 112 * MS, 120 * MS, 7, 0)]
    dev = devtrace.DeviceTrace(ops=o, scale=1.0, syncs=2)
    r = reading(device=dev, events=ev)
    # idle: 100-102 (1 ms of it in attn_route), 106-108 (1 ms in picks,
    # 1 ms in probe), 110-112 (1 ms in execute, 1 ms in post_fetch)
    assert manifest.reader("layer_idle_ms")(r) == pytest.approx(4.0)
    # a second step with its device busy throughout: the mean halves
    ev2 = layer_loop(300 * MS, (2, 4, 2, 2, 2), layers=1)
    dev = devtrace.DeviceTrace(
        ops=o + [Op("k", "kernel", 300 * MS, 320 * MS, 7, 0)], scale=1.0,
        syncs=2)
    r = reading(device=dev, events=ev + ev2)
    assert manifest.reader("layer_idle_ms")(r) == pytest.approx(2.0)


def test_copy_readers_by_hand():
    r = reading(device=no_ops(), s0=dict.fromkeys(COPIES, 0),
                s1=dict(stage_d2d_bytes=700_000_000,
                        stage_h2d_bytes=60_000_000,
                        slot_d2d_bytes=100_000_000,
                        slot_h2d_bytes=20_000_000))
    # 20 tokens in the window
    assert manifest.reader("d2d_mb_per_token")(r) == pytest.approx(40.0)
    assert manifest.reader("h2d_mb_per_token")(r) == pytest.approx(4.0)


def test_prefill_forward_reader_keeps_to_the_window():
    ev = [Ev("X", "engine", "prefill_forward", 100 * MS, 30 * MS,
             {"tokens": 72, "h2d_bytes": 1}),
          Ev("X", "engine", "prefill_forward", 600 * MS, 50 * MS,
             {"tokens": 184, "h2d_bytes": 1}),
          Ev("X", "engine", "prefill_forward", 1500 * MS, 9 * MS,
             {"tokens": 100, "h2d_bytes": 1})]
    r = reading(device=no_ops(), events=ev)
    assert manifest.reader("prefill_forward_ms")(r) == pytest.approx(40.0)


@pytest.mark.parametrize("case", ["no_spans_or_counters", "no_device"])
def test_new_readers_with_nothing_to_read_return_none(case):
    """A program without the spans and counters (the parent's): nothing
    to read, and no error. A run without a device trace (the CPU's):
    the spans and counters are there, but split no card's time."""
    if case == "no_spans_or_counters":
        r = reading(device=no_ops())
        r.stats1 = r.stats0
    else:
        r = reading(events=layer_loop(100 * MS, (1, 2, 3, 4, 5)) + [
            Ev("X", "engine", "prefill_forward", 300 * MS, 9 * MS, None)],
            s0=dict.fromkeys(COPIES, 0), s1=dict.fromkeys(COPIES, 10**6))
    for name in NEW:
        assert manifest.reader(name)(r) is None, name


def test_readers_read_the_programs_own_spans_and_counters(
        tmp_path, harness_threads):
    """The tiny cell's program, traced through its warm-up traffic, leaves
    what every new reader reads; given a device trace, each reads a
    number, and the five phases fill most of each step's dispatch."""
    from repro_torch.obs import TraceRecorder
    cell = tiny.cell(tmp_path)
    cfg = harness.load_config(cell)
    mix = traffic.load_mix(cell.traffic_file)
    system = manifest.module("systems", cfg["system"])
    params = weights.draw(cfg, 5, "cpu")
    recorder = TraceRecorder(harness.RECORDER_EVENTS)
    engine, sched = system.build(cfg, mix, params, 5, "cpu",
                                 recorder=recorder)
    stats0 = engine.stats
    harness.warm_up(sched, mix, cfg["vocab_size"], 5)
    events = recorder.events()
    r = Reading(cfg=cfg, t0=0.0, t1=events[-1].ts_ns / 1e9 + 1.0, served=[],
                events=events, stats0=stats0, stats1=engine.stats,
                device=no_ops(), kernel_calls=[])
    got = {name: manifest.reader(name)(r) for name in NEW}
    assert all(v is not None for v in got.values()), got
    assert all(v >= 0 for v in got.values()), got
    phases = sum(got[m] for m in NEW[:5])
    assert 0 < phases <= manifest.reader("dispatch_ms")(r) * 1.0001
    # the device did nothing: all of the host phases' time is idle
    assert got["layer_idle_ms"] == pytest.approx(phases - got["picks_wait_ms"])
    assert got["d2d_mb_per_token"] + got["h2d_mb_per_token"] > 0
