"""Whole runs of a tiny cell on the CPU: the result line's shape, and the
timed path broken underneath, which the check must call not correct. The
harness's look for a card is skipped (``run_cell`` is what ``main`` runs
once it has found one)."""
import json

import pytest
import torch

from perfbench import faults, harness, manifest
from perfbench.tests import tiny

BENCH = manifest.load()


def run(tmp_path, seed=3, trace=False, seconds=1.0, monkeypatch=None):
    """One run of the tiny cell; given ``monkeypatch``, on the step clock,
    so that its window holds the same work however loaded the host."""
    if monkeypatch is not None:
        monkeypatch.setattr(harness, "time", tiny.StepClock())
    return harness.run_cell(tiny.cell(tmp_path), seed, seconds, trace,
                            "cpu")


def test_untraced_run_reports_every_end_to_end_metric(tmp_path,
                                                      monkeypatch,
                                                      harness_threads):
    r = run(tmp_path, monkeypatch=monkeypatch)
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    units = manifest.metric_units(BENCH)
    assert all(v["unit"] == units[k] for k, v in r["metrics"].items())
    assert r["attempted"] > 2 and r["failed"] == 0
    assert r["device"]["count"] == 1
    assert r["correct"] is True, r["check"]
    assert set(r["check"]) == set(tiny.TINY["limits"])
    json.dumps(r)


def test_traced_run_reports_the_per_layer_metrics_it_can_read(
        tmp_path, harness_threads):
    r = run(tmp_path, trace=True)
    # on the CPU there is no device trace: those readers return nothing
    assert set(r["metrics"]) == {"served_tok_s", "decode_gap_ms",
                                 "decode_gap_p95_ms", "prefill_ms",
                                 "dispatch_ms", "warm_ms", "hit_rate",
                                 "fetched_per_token", "decode_mfu"}
    assert r["correct"] is True, r["check"]
    assert 0 < r["metrics"]["hit_rate"]["value"] < 100


def test_kernel_shapes_restore_the_entry_points(tmp_path):
    from repro_torch.kernels.moe_gmm import ops
    before = (ops.swiglu_gmm, ops.gmm)
    with harness.KernelShapes(manifest.entry_points(["gmm_roofline"])) as k:
        x = torch.zeros((2, 3, 8), dtype=torch.bfloat16)
        w = torch.zeros((2, 8, 5), dtype=torch.bfloat16)
        ops.moe_ffn(x, w, w, torch.zeros((2, 5, 8), dtype=torch.bfloat16))
    assert (ops.swiglu_gmm, ops.gmm) == before
    assert [c[:5] for c in k.calls] == [("swiglu_gmm", 2, 3, 8, 5),
                                        ("gmm", 2, 3, 5, 8)]
    assert k.calls[0][5] <= k.calls[1][5]


@pytest.mark.parametrize("fault", ["altered_token", "unchanged_state",
                                   "half_batch", "one_slot"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            harness_threads):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run(tmp_path, seed=4, monkeypatch=monkeypatch)
    assert r["correct"] is False, r["check"]
    assert r["numbers"]["judged_tokens"] > 0
