"""What depends on a configuration's layer layout comes from its reference
module: the seeded weights, the host tier they are drawn into, the model
FLOPs of decode tokens. The attention + MoE layout draws what it drew
before; a second layout (``hybrid.py``: MoE layers between dense FFNs)
goes through the harness, ``limits.py`` and ``decode_mfu`` with no edit
to a shared file."""
import hashlib
import json
import shutil

import pytest
import torch

from perfbench import harness, limits, manifest, roofline, weights
from perfbench.reading import Reading
from perfbench.tests import hybrid, tiny
from perfbench.window import Served

# sha256 over the tiny configuration's tensors drawn from seed 5 on the CPU,
# in draw order, as drawn before the draw moved behind the reference module
TINY_SEED5 = "7920fb963791d7d0cbfa0dae3be6e6d4b91c179909e822c2f0577cb693984980"
DRAW_ORDER = ("embed", "lm_head", "final_norm", "scan.s0.attn.wq",
              "scan.s0.attn.wk", "scan.s0.attn.wv", "scan.s0.attn.wo",
              "scan.s0.moe.router", "scan.s0.moe.w1", "scan.s0.moe.w3",
              "scan.s0.moe.w2", "scan.s0.ln1", "scan.s0.ln2")


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def digest(params) -> str:
    by_path = dict(leaves(params))
    assert sorted(by_path) == sorted(DRAW_ORDER)
    h = hashlib.sha256()
    for path in DRAW_ORDER:
        t = by_path[path].contiguous()
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("made_host", [False, True],
                         ids=["own_host_tier", "host_tier_given"])
def test_attention_moe_draw_is_bitwise_the_parents(made_host):
    cfg = dict(tiny.TINY, name="tiny")
    ref = manifest.module("reference", cfg["reference"])
    host = ref.host_tier(cfg, pinned=False) if made_host else None
    assert digest(ref.draw(cfg, 5, "cpu", host=host)) == TINY_SEED5


def test_attention_moe_host_tier_and_flops_are_the_yardsticks():
    cfg = dict(tiny.TINY, name="tiny")
    ref = manifest.module("reference", cfg["reference"])
    host = ref.host_tier(cfg, pinned=False)
    want = weights.host_tier(weights.Shapes.of(cfg), pinned=False)
    assert {k: v.shape for k, v in host.items()} == \
        {k: v.shape for k, v in want.items()}
    assert ref.decode_flops(cfg, [40, 41]) == \
        roofline.decode_flops(cfg, [40, 41])


# -- a second layout ---------------------------------------------------------

@pytest.fixture
def hybrid_modules(monkeypatch):
    """``manifest.module`` resolves the name ``hybrid`` (reference and
    system alike) to the test layout."""
    orig = manifest.module

    def module(kind, name, root=manifest.ROOT):
        return hybrid if name == "hybrid" else orig(kind, name, root)
    monkeypatch.setattr(manifest, "module", module)


def hybrid_cell(tmp_path) -> manifest.Cell:
    """A cell of the test layout under the tiny mix (one client): its
    configuration file holds none of the attention + MoE keys."""
    c, m = tmp_path / "hybrid.json", tmp_path / "hybrid_mix.json"
    c.write_text(json.dumps(hybrid.CONFIG))
    m.write_text(json.dumps(dict(tiny.MIX, clients=1)))
    bench = manifest.load()
    return manifest.Cell(
        name="hybrid.hybrid_mix", config="hybrid", traffic="hybrid_mix",
        chips=1, config_file=c, traffic_file=m,
        end_to_end=[x["name"] for x in bench["end_to_end"]],
        per_layer=[x["name"] for x in bench["per_layer"]])


def moe_table_shapes(cfg):
    n_moe, E = len(hybrid.moe_layers(cfg)), cfg["num_experts"]
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    return {"w1": (n_moe, E, D, F), "w3": (n_moe, E, D, F),
            "w2": (n_moe, E, F, D)}


def test_the_test_layout_keeps_no_attention_moe_key():
    assert not {"num_local_experts", "num_attention_heads", "head_dim",
                "num_key_value_heads"} & set(hybrid.CONFIG)
    assert hybrid.moe_layers(hybrid.CONFIG) == [1, 3]


def test_a_second_layout_runs_through_the_harness(
        tmp_path, monkeypatch, hybrid_modules, harness_threads):
    """An untraced run draws through the layout's reference module, builds
    its system over those weights and judges the served tokens with its
    forward: the host tier holds the MoE layers' tables alone."""
    built = []
    build = hybrid.build

    def spy(cfg, mix, params, seed, device, recorder=None):
        built.append(params)
        return build(cfg, mix, params, seed, device, recorder)
    monkeypatch.setattr(hybrid, "build", spy)
    monkeypatch.setattr(harness, "time", tiny.StepClock())
    r = harness.run_cell(hybrid_cell(tmp_path), 7, 1.0, False, "cpu")
    assert r["correct"] is True, r["check"]
    assert r["attempted"] > 2 and r["numbers"]["judged_tokens"] > 0
    assert set(r["metrics"]) == {"ttft_ms", "setup_s"}
    (params,) = built
    cfg = dict(hybrid.CONFIG, name="hybrid")
    assert {k: tuple(v.shape) for k, v in params["experts"].items()} == \
        moe_table_shapes(cfg)
    assert params["dense"]["w1"].shape[0] == 2


def test_a_second_layouts_traced_run_counts_its_own_flops(
        tmp_path, monkeypatch, hybrid_modules, harness_threads):
    calls = []
    count = hybrid.decode_flops

    def spy(cfg, keys_seen):
        calls.append((cfg["name"], list(keys_seen)))
        return count(cfg, calls[-1][1])
    monkeypatch.setattr(hybrid, "decode_flops", spy)
    r = harness.run_cell(hybrid_cell(tmp_path), 8, 0.5, True, "cpu")
    assert r["correct"] is True, r["check"]
    assert r["metrics"]["decode_mfu"]["value"] > 0
    assert len(calls) == 1 and calls[0][0] == "hybrid" and calls[0][1]


def test_decode_mfu_reads_the_reference_modules_count(hybrid_modules):
    """Two decode tokens in 0.1 s of decode steps: the layout's count (no
    attention term: no layer reads keys) over the bf16 peak."""
    cfg = dict(hybrid.CONFIG, name="hybrid")
    steps = [type("Ev", (), dict(kind="X", track="sched",
                                 name="decode+drain", ts_ns=t, dur_ns=5e7,
                                 args=None))()
             for t in (100_000_000, 200_000_000)]
    s = Served(index=0, prompt_len=100, t_send=0.0, times=[0.05, 0.15, 0.25])
    r = Reading(cfg=cfg, t0=0.0, t1=1.0, served=[s], events=steps,
                stats0=None, stats1=None, device=None, kernel_calls=[])
    flops = 2.0 * hybrid.active_params_per_token(cfg) * 2
    assert manifest.reader("decode_mfu")(r) == pytest.approx(
        100 * flops / (0.1 * roofline.BF16_FLOPS))


def test_limits_pins_the_reference_modules_host_tier(
        tmp_path, monkeypatch, hybrid_modules, harness_threads):
    """``limits.py`` page-locks the tables the layout's ``host_tier`` makes
    and draws every seed into them (the card, the page-locking and the
    runs stood in for)."""
    cell = hybrid_cell(tmp_path)
    locked, hosts = [], []

    def page_locked(shape, dtype):
        locked.append(tuple(shape))
        return torch.empty(shape, dtype=dtype)

    def run_cell(cell, seed, seconds, trace, device, host=None,
                 control=False):
        hosts.append(host)
        return {"correct": True, "numbers": {}, "attempted": 0,
                "metrics": {}}
    monkeypatch.setattr(hybrid, "_page_locked", page_locked)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.setattr(manifest, "cell", lambda bench, name: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "none")
    out = tmp_path / "limits.jsonl"
    assert limits.main(["--workload", cell.name, "--seeds", "1,2",
                        "--seconds", "1", "--out", str(out)]) == 0
    want = moe_table_shapes(dict(hybrid.CONFIG, name="hybrid"))
    assert sorted(locked) == sorted(want.values())
    assert len(hosts) == 2 and hosts[0] is hosts[1]
    assert {k: tuple(v.shape) for k, v in hosts[0].items()} == want
    assert len(out.read_text().splitlines()) == 2


@pytest.mark.parametrize("lacks", [None, "draw", "host_tier",
                                   "decode_flops"])
def test_problems_flags_a_reference_module_without_the_layouts_functions(
        tmp_path, lacks):
    """The test layout added to a copy of the benchmark as files and
    entries alone (a configuration, a reference, a system) keeps the rules;
    its reference without one of the three functions does not."""
    root = tmp_path
    shutil.copytree(manifest.ROOT / "perfbench", root / "perfbench")
    src = (manifest.ROOT / "perfbench/tests/hybrid.py").read_text()
    if lacks is not None:
        src += f"\n\ndel {lacks}\n"
    for kind in ("reference", "systems"):
        (root / "perfbench" / kind / "hybrid.py").write_text(src)
    (root / "perfbench/configs/hybrid.json").write_text(
        json.dumps(hybrid.CONFIG))
    bench = manifest.load()
    bench["configs"].append({"name": "hybrid",
                             "source": hybrid.CONFIG["source"],
                             "file": "perfbench/configs/hybrid.json",
                             "reduced": [], "why": "a second layout"})
    bench["workloads"].append({"name": "hybrid.chat1", "config": "hybrid",
                               "traffic": "chat1", "chips": 1,
                               "why": "a second layout's cell"})
    found = manifest.problems(bench, root)
    if lacks is None:
        assert found == []
    else:
        assert found == [f"config hybrid: reference/hybrid.py lacks {lacks}"]


def test_release_frees_only_what_page_locking_made(monkeypatch):
    """``weights.release`` hands back (``cudaFreeHost``) the tables that
    ``_page_locked`` made, once each, and leaves any other table alone
    (the runtime and the card stood in for)."""
    freed = []

    class Runtime:
        def cudaFreeHost(self, ptr):
            freed.append(ptr.value)
            return 0
    monkeypatch.setattr(weights, "_cudart", Runtime)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    mine, other = torch.empty(4), torch.empty(4)
    monkeypatch.setattr(weights, "_LOCKED", {mine.data_ptr()})
    weights.release({"w1": mine, "w2": other})
    weights.release({"w1": mine, "w2": other})
    assert freed == [mine.data_ptr()] and not weights._LOCKED
