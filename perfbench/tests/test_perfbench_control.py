"""The control at a size a test run holds: the plain reference computed in
float8 weights, put in the program's place on the tokens the program
served, fails the limits that the program's own runs pass."""
import pytest

from perfbench import check, harness
from perfbench.tests import tiny


@pytest.mark.parametrize("seed", [11, 12, 2 ** 31 + 13])
def test_float8_control_fails_where_the_program_passes(tmp_path, seed,
                                                       monkeypatch,
                                                       harness_threads):
    monkeypatch.setattr(harness, "time", tiny.StepClock())
    r = harness.run_cell(tiny.cell(tmp_path), seed, 1.0, False, "cpu",
                         control=True)
    lim = tiny.TINY["limits"]
    assert list(r)[-1] == "check"
    assert r["numbers"]["judged_tokens"] >= 300
    ok, shown = check.verdict(r["numbers"], lim)
    assert ok, shown
    ok, shown = check.verdict(r["control"], lim)
    assert not ok, shown
    assert r["control"]["judged_tokens"] == r["numbers"]["judged_tokens"]
