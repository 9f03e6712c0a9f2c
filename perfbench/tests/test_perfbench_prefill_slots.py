"""The ``prefill_resident_share`` reader: on hand-made readings (with a
device trace and the counters; without a device trace; without the
counters, as a program that predates them), and over the counters a traced
run of the tiny cell's program leaves."""
import pytest

from perfbench import devtrace, harness, manifest, traffic, weights
from perfbench.reading import Reading
from perfbench.tests import tiny

READ = manifest.reader("prefill_resident_share")


class Stats:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def reading(device, s0, s1):
    return Reading(cfg=dict(tiny.TINY, name="m"), t0=0.0, t1=1.0,
                   served=[], events=[], stats0=Stats(**s0),
                   stats1=Stats(**s1), device=device, kernel_calls=[])


def no_ops():
    """A device trace in which the device did nothing."""
    return devtrace.DeviceTrace(ops=[], scale=1.0, syncs=2)


# two admissions of 24 layers x 8 experts in the window, 144 of each
# one's 192 reads resident, after one admission before it
BEFORE = dict(tokens=10, prefill_forward_resident=100,
              prefill_forward_experts=192)
AFTER = dict(tokens=300, prefill_forward_resident=100 + 2 * 144,
             prefill_forward_experts=3 * 192)


def test_reads_the_windows_share_of_resident_reads():
    assert READ(reading(no_ops(), BEFORE, AFTER)) == pytest.approx(75.0)
    # no forward in the window: nothing to read
    assert READ(reading(no_ops(), BEFORE, BEFORE)) is None


def test_without_a_device_trace_reads_none():
    assert READ(reading(None, BEFORE, AFTER)) is None


def test_without_the_counters_reads_none():
    """A program that predates the counters: nothing to read, no error."""
    s = dict(tokens=10, hits=1, accesses=2)
    assert READ(reading(no_ops(), s, dict(s, tokens=30))) is None


def test_reads_the_programs_own_counters(tmp_path, harness_threads):
    """The tiny cell's program through its warm-up traffic twice, the
    window over the second: each admission reads every layer's experts,
    and, the cache warm from the first, some come from the slots."""
    cell = tiny.cell(tmp_path)
    cfg = harness.load_config(cell)
    mix = traffic.load_mix(cell.traffic_file)
    system = manifest.module("systems", cfg["system"])
    params = weights.draw(cfg, 5, "cpu")
    engine, sched = system.build(cfg, mix, params, 5, "cpu")
    harness.warm_up(sched, mix, cfg["vocab_size"], 5)
    stats0 = engine.stats
    harness.warm_up(sched, mix, cfg["vocab_size"], 6)
    r = Reading(cfg=cfg, t0=0.0, t1=1.0, served=[], events=[],
                stats0=stats0, stats1=engine.stats, device=no_ops(),
                kernel_calls=[])
    layers = cfg["num_hidden_layers"] * cfg["num_local_experts"]
    assert r.delta("prefill_forward_experts") % layers == 0
    assert r.delta("prefill_forward_experts") > 0
    assert 0 < READ(r) < 100
