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


# the cells accepted so far, in the order they were added; a later cell
# may stand anywhere, and taking one away is a benchmark PR's to do here
ACCEPTED = ("mixtral-8x7b-l24.chat1", "mixtral-8x7b-l24.docqa1")
ACCEPTED_CONFIGS = ("mixtral-8x7b-l24",)


def keeps_accepted(bench) -> bool:
    """Every accepted cell and configuration is there, the cells in their
    order; others may stand between and around them."""
    names = iter(w["name"] for w in bench["workloads"])
    return all(a in names for a in ACCEPTED) and \
        set(ACCEPTED_CONFIGS) <= {c["name"] for c in bench["configs"]}


def test_cells_of_the_issue_in_order():
    assert keeps_accepted(BENCH)
    for w in ACCEPTED:
        assert manifest.cell(BENCH, w).config == "mixtral-8x7b-l24"
        assert manifest.cell(BENCH, w).chips == 1
    # the guard holds with another cell added anywhere, and fails with
    # an accepted one gone or two out of their order
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].insert(1, dict(bench["workloads"][0], name="x.y"))
    assert keeps_accepted(bench)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["name"] != ACCEPTED[1]]
    assert not keeps_accepted(bench)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].reverse()
    assert not keeps_accepted(bench)


def test_config_files_keep_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert manifest.cut_problems(c["name"], c["reduced"], cfg) == []
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["published"]) == set(c["reduced"])
        assert not any(manifest.is_width(k) for k in c["reduced"])
    # Mixtral's own widths, and only its depth cut
    c = next(c for c in BENCH["configs"] if c["name"] == "mixtral-8x7b-l24")
    cfg = json.loads((manifest.ROOT / c["file"]).read_text())
    assert cfg["reduced"] == c["reduced"] == ["num_hidden_layers"]
    assert cfg["published"] == {"num_hidden_layers": 32}
    assert cfg["hidden_size"] == 4096 and cfg["head_dim"] == 128
    assert cfg["intermediate_size"] == 14336
    assert cfg["num_experts_per_tok"] == 2


MIXTRAL = json.loads((manifest.ROOT / "perfbench/configs/"
                      "mixtral-8x7b-l24.json").read_text())


def cut(reduced, published, **values):
    return dict(MIXTRAL, reduced=list(reduced), published=published,
                **values)


@pytest.mark.parametrize("reduced, spec, why", [
    (["num_hidden_layers"], cut([], {}), "differs from its file"),
    (["num_hidden_layers"], cut(["num_hidden_layers"], {}), "published"),
    (["num_hidden_layers"],
     cut(["num_hidden_layers"], {"num_hidden_layers": 32, "vocab_size": 1}),
     "published"),
    (["hidden_size"], cut(["hidden_size"], {"hidden_size": 8192}),
     "width hidden_size"),
    (["head_dim"], cut(["head_dim"], {"head_dim": 256}), "width head_dim"),
    (["num_experts_per_tok"],
     cut(["num_experts_per_tok"], {"num_experts_per_tok": 8}),
     "width num_experts_per_tok"),
    (["mamba_d_state"], cut(["mamba_d_state"], {"mamba_d_state": 32}),
     "width mamba_d_state"),
    (["intermediate_size"],
     cut(["intermediate_size"], {"intermediate_size": 28672}),
     "width intermediate_size"),
    (["num_local_experts"],
     cut(["num_local_experts"], {"num_local_experts": 16},
         num_local_experts=4), "experts"),
    (["vocab_size"], cut(["vocab_size"], {"vocab_size": 65536},
                         vocab_size=8191), "vocabulary"),
    (["cache"], cut(["cache"], {"cache": dict(MIXTRAL["cache"],
                                              head_dim=64)}),
     "width cache.head_dim"),
])
def test_cut_problems_names_what_breaks(reduced, spec, why):
    found = manifest.cut_problems("m", reduced, spec)
    assert any(why in p for p in found), found


@pytest.mark.parametrize("reduced, spec", [
    (["num_hidden_layers"], MIXTRAL),
    (["num_local_experts", "vocab_size"],
     cut(["num_local_experts", "vocab_size"],
         {"num_local_experts": 64, "vocab_size": 65536},
         num_local_experts=8, vocab_size=8192)),
    ([], cut([], {})),
])
def test_cut_problems_let_a_chips_share_stand(reduced, spec):
    """A depth cut, the chip's share of the experts and the vocabulary at
    their floors, and no cut at all keep the rules."""
    assert manifest.cut_problems("m", reduced, spec) == []


@pytest.mark.parametrize("cells, four, ok", [
    (3, 1, True), (4, 1, True), (7, 1, True), (7, 2, False), (8, 2, True),
    (25, 0, False)])
def test_problems_cap_cells_and_four_chip_cells(cells, four, ok):
    bench = json.loads(json.dumps(BENCH))
    base = bench["workloads"][0]
    bench["workloads"] = [
        dict(base, name=f"mixtral-8x7b-l24.t{i}", traffic=f"t{i}",
             chips=4 if i < four else 1) for i in range(cells)]
    found = [p for p in manifest.problems(bench)
             if "entries" in p or "4 chips" in p]
    assert (found == []) is ok, found


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
