"""The ``prefill_ahead_share`` reader: on hand-made readings (with a
device trace and the counters; without a device trace; without the
counters, as a program that predates them), and over the counters a traced
run of the tiny cell's program leaves."""
import pytest

from perfbench import harness, manifest, traffic, weights
from perfbench.reading import Reading
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_prefill_slots import (AFTER, BEFORE,
                                                          no_ops, reading)

READ = manifest.reader("prefill_ahead_share")

# of the two admissions' 2 x 48 host reads, 90 queued a layer ahead
AHEAD0 = dict(BEFORE, prefill_forward_ahead=92)
AHEAD1 = dict(AFTER, prefill_forward_ahead=92 + 90)


def test_reads_the_windows_share_of_host_reads_queued_ahead():
    assert READ(reading(no_ops(), AHEAD0, AHEAD1)) == pytest.approx(93.75)
    # no forward in the window: nothing to read
    assert READ(reading(no_ops(), AHEAD0, AHEAD0)) is None
    # every read from the slots: no host read to share out
    every = dict(AHEAD1, prefill_forward_resident=AHEAD0[
        "prefill_forward_resident"] + 2 * 192)
    assert READ(reading(no_ops(), AHEAD0, every)) is None


def test_without_a_device_trace_reads_none():
    assert READ(reading(None, AHEAD0, AHEAD1)) is None


def test_without_the_counter_reads_none():
    """A program with the forwards' read counters but not the lookahead's
    (the program before it): nothing to read, no error."""
    assert READ(reading(no_ops(), BEFORE, AFTER)) is None


def test_reads_the_programs_own_counters(tmp_path, harness_threads):
    """The tiny cell's program through its warm-up traffic twice, the
    window over the second: every host read of every admission's forward
    is queued a layer ahead (layer 0's when the forward starts)."""
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
    assert r.delta("prefill_forward_ahead") > 0
    assert READ(r) == pytest.approx(100.0)
