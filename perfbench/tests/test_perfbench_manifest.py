"""BENCHMARK.json against the manifest's rules, and a cell, a mix and a
metric added by files and entries alone."""
import json
import shutil

import pytest

from perfbench import manifest, roofline
from perfbench.reading import Reading

BENCH = manifest.load()


def test_manifest_keeps_the_rules():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(w):
    cell = manifest.cell(BENCH, w)
    cfg = json.loads(cell.config_file.read_text())
    assert cell.traffic_file.is_file()
    assert manifest.module("systems", cfg["system"]).build
    assert manifest.module("reference", cfg["reference"]).forward
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for name in cell.per_layer:
        assert callable(manifest.reader(name))


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_moves_is_reported_where_its_metric_is(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
        assert m["moves"] in manifest.cell(BENCH, w).end_to_end


@pytest.mark.parametrize("bad, why", [
    ({"name": "has space"}, "bad name"),
    ({"unit": "tokens per second"}, "bad unit"),
    ({"source": "program_counter"}, "source"),
    ({"bound": 0.3}, "bound"),
])
def test_problems_names_what_breaks(bad, why):
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"][0].update(bad)
    assert any(why in p for p in manifest.problems(bench))


def test_cells_of_the_issue_in_order():
    assert [w["name"] for w in BENCH["workloads"]] == [
        "mixtral-8x7b-l24.chat1", "mixtral-8x7b-l24.docqa1"]
    assert {c["name"] for c in BENCH["configs"]} == {"mixtral-8x7b-l24"}


def test_config_files_keep_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == ["num_hidden_layers"]
        assert set(cfg["published"]) == set(c["reduced"])
        assert cfg["hidden_size"] == 4096 and cfg["head_dim"] == 128
        assert cfg["num_experts_per_tok"] == 2


def test_a_new_model_mix_and_metric_are_files_and_entries(tmp_path):
    """A throwaway configuration, mix and per-layer metric, added to a copy
    of the benchmark as files and entries only, are found by name."""
    root = tmp_path
    shutil.copytree(manifest.ROOT / "perfbench", root / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((root / "perfbench/configs/mixtral-8x7b-l24.json")
                     .read_text())
    cfg["source"] = "https://example.org/throwaway"
    (root / "perfbench/configs/throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/chat1.json").read_text())
    mix["clients"] = 2
    (root / "perfbench/traffic/pair.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/tokens_per_step.py").write_text(
        "def read(r):\n    return r.delta('tokens') / r.delta('steps')\n")
    bench["configs"].append({"name": "throwaway",
                             "source": cfg["source"],
                             "file": "perfbench/configs/throwaway.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a throwaway entry"})
    bench["workloads"].append({"name": "throwaway.pair",
                               "config": "throwaway", "traffic": "pair",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "tokens_per_step", "unit": "tokens",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Engine (serving/engine.py)",
                               "moves": "ttft_ms",
                               "workloads": ["throwaway.pair"]})
    assert manifest.problems(bench, root) == []
    cell = manifest.cell(bench, "throwaway.pair", root)
    assert cell.config_file == root / "perfbench/configs/throwaway.json"
    assert cell.traffic_file == root / "perfbench/traffic/pair.json"
    assert "tokens_per_step" in cell.per_layer
    assert "tokens_per_step" not in manifest.cell(
        bench, "mixtral-8x7b-l24.chat1", root).per_layer

    class Stats:
        def __init__(self, tokens, steps):
            self.tokens, self.steps = tokens, steps
    r = Reading(cfg=cfg, t0=0.0, t1=1.0, served=[], events=[],
                stats0=Stats(0, 0), stats1=Stats(12, 3), device=None,
                kernel_calls=[])
    assert manifest.reader("tokens_per_step", root)(r) == 4.0
    assert roofline.active_params_per_token(cfg) > 0
