"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` runs the configuration file of its config
entry (``perfbench/configs/<config>.json``) under the mix
``perfbench/traffic/<traffic>.json``; a per-layer metric ``<name>`` is read
by ``perfbench/metrics/<name>.py``; a configuration's ``system`` and
``reference`` keys name ``perfbench/systems/<system>.py`` (how the program
is built and driven) and ``perfbench/reference/<reference>.py`` (its plain
reference, and all that depends on its layer layout: ``REFERENCE_API``).
A reader may declare the kernel entry points whose calls it reads
(``ENTRY_POINTS``: {module: {function: shape}}, ``entry_points``); the
harness records their calls while the cell's traced window is open.
Adding a model, a mix, a metric or a kernel's reader is adding files and
entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# what a reference module gives the harness: the plain forward, the seeded
# weights both sides share, the empty host tier they are drawn into, and
# the model FLOPs of decode tokens
REFERENCE_API = ("forward", "draw", "host_tier", "decode_flops")

# the contract's caps on cells
MAX_CELLS = 24
# a configuration's cuts (BENCHMARK.json's contract; model-configs guide
# section 4): a width is never cut; a cut expert count keeps 8, a cut
# vocabulary an eighth of the published one
WIDTH_KEYS = frozenset({"hidden_size", "intermediate_size", "head_dim",
                        "num_experts_per_tok"})
WIDTH_PREFIX = "mamba_"      # every Mamba mixer size is a width
EXPERT_COUNT_KEYS = ("num_local_experts", "num_experts", "n_routed_experts",
                     "moe_num_experts")
MIN_EXPERTS = 8
MIN_VOCAB_SHARE = 8          # a cut vocabulary keeps 1/8 of the published


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    config_file: Path
    traffic_file: Path
    end_to_end: List[str]
    per_layer: List[str]
    root: Path = ROOT            # the checkout its modules are found in


def load(root: Path = ROOT) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files and the metrics it reports."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[x['name'] for x in bench['workloads']]}")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, config=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]),
                config_file=Path(root) / c["file"],
                traffic_file=(Path(root) / "perfbench" / "traffic"
                              / f"{w['traffic']}.json"),
                end_to_end=[m["name"] for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m["name"] for m in bench["per_layer"]
                           if _applies(m, name)],
                root=Path(root))


def _load(path: Path):
    """The module in the file ``path`` (imported once a process)."""
    key = f"_perfbench_{path.parent.name}_{path.stem}"
    mod = sys.modules.get(key)
    if mod is None or getattr(mod, "__file__", None) != str(path):
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(reading)`` function of ``perfbench/metrics/<metric>.py``."""
    return _load(Path(root) / "perfbench" / "metrics" / f"{metric}.py").read


def module(kind: str, name: str, root: Path = ROOT):
    """``perfbench/<kind>/<name>.py`` (kind: systems, reference)."""
    return _load(Path(root) / "perfbench" / kind / f"{name}.py")


def entry_points(metrics, root: Path = ROOT
                 ) -> Dict[str, Dict[str, Callable]]:
    """The union of the kernel entry points that the readers of
    ``metrics`` declare: {module: {function: shape}}, where ``shape(*args,
    **kwargs)`` gives the ints a reader's work count takes from a call.
    An entry point two readers declare keeps the first one's shape."""
    out: Dict[str, Dict[str, Callable]] = {}
    for name in metrics:
        mod = _load(Path(root) / "perfbench" / "metrics" / f"{name}.py")
        for m, fns in getattr(mod, "ENTRY_POINTS", {}).items():
            for fn, shape in fns.items():
                out.setdefault(m, {}).setdefault(fn, shape)
    return out


def is_width(key: str) -> bool:
    """A width: the hidden, intermediate and head sizes, the experts per
    token, and any Mamba mixer size."""
    return key in WIDTH_KEYS or key.startswith(WIDTH_PREFIX)


def cut_problems(name: str, reduced: List[str], spec: Dict) -> List[str]:
    """What in a configuration's cut breaks the rules: the entry's
    ``reduced`` is the file's; the file's ``published`` holds the source's
    value of each reduced key and of no other; no width is reduced, nor
    changed inside a reduced group; a reduced expert count keeps
    ``MIN_EXPERTS``, a reduced vocabulary 1/``MIN_VOCAB_SHARE`` of the
    published one."""
    out: List[str] = []
    pre = f"config {name}:"
    if list(reduced) != list(spec.get("reduced", [])):
        out.append(f"{pre} reduced {reduced} differs from its file's "
                   f"{spec.get('reduced', [])}")
    published = spec.get("published", {})
    if set(published) != set(reduced):
        out.append(f"{pre} published {sorted(published)} is not the "
                   f"reduced keys {sorted(reduced)}")
    for k in reduced:
        if is_width(k):
            out.append(f"{pre} reduces the width {k}")
        if k not in published:
            continue
        have, was = spec.get(k), published[k]
        if isinstance(was, dict):
            for kk, v in was.items():
                if is_width(kk) and (have or {}).get(kk) != v:
                    out.append(f"{pre} changes the width {k}.{kk}")
        elif k in EXPERT_COUNT_KEYS and not (
                isinstance(have, int) and have >= MIN_EXPERTS):
            out.append(f"{pre} keeps {have} experts of {was} (at least "
                       f"{MIN_EXPERTS})")
        elif k == "vocab_size" and not (
                isinstance(have, int) and have * MIN_VOCAB_SHARE >= was):
            out.append(f"{pre} keeps a vocabulary of {have} of {was} (at "
                       f"least 1/{MIN_VOCAB_SHARE})")
    return out


def problems(bench: Dict, root: Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the manifest's rules (empty if none): the
    keys, names, units and sources; the caps on cells and on 4-chip
    cells; every configuration's cut (``cut_problems``); every cell's
    files and every metric's reader found by name, and what a reader
    declares of ``ENTRY_POINTS``; every reference module giving
    ``REFERENCE_API``; every ``moves`` an end-to-end metric that each cell
    listing the per-layer metric reports."""
    here = Path(root) / "perfbench"
    out: List[str] = []
    want = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != want:
        out.append(f"top-level keys {sorted(bench)} != {sorted(want)}")
        return out
    if not 1 <= int(bench["run_seconds"]) <= 51:
        out.append("run_seconds outside 1..51")
    if not 1 <= len(bench["workloads"]) <= MAX_CELLS:
        out.append(f"workloads: {len(bench['workloads'])} entries (1 to "
                   f"{MAX_CELLS})")
    # 4-chip cells: a quarter of the cells, rounded down, or one
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    cap = max(len(bench["workloads"]) // 4, 1)
    if four > cap:
        out.append(f"workloads: {four} cells on 4 chips, over the cap of "
                   f"{cap}")
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            n = e["name"]
            if not NAME.match(n):
                out.append(f"{kind}: bad name {n!r}")
            group = "metric" if kind in ("end_to_end", "per_layer") else kind
            if (group, n) in names:
                out.append(f"{kind}: duplicate name {n!r}")
            names[(group, n)] = e
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']}: keys {sorted(c)}")
        f = Path(root) / c["file"]
        if not f.is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
            continue
        spec = json.loads(f.read_text())
        for kind in ("systems", "reference"):
            key = "system" if kind == "systems" else "reference"
            if not (here / kind / f"{spec.get(key)}.py").is_file():
                out.append(f"config {c['name']}: no {kind}/{spec.get(key)}.py")
            elif kind == "reference":
                ref = module(kind, spec[key], root)
                lacks = [f for f in REFERENCE_API
                         if not callable(getattr(ref, f, None))]
                if lacks:
                    out.append(f"config {c['name']}: reference/{spec[key]}.py "
                               f"lacks {', '.join(lacks)}")
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
        out += cut_problems(c["name"], c["reduced"], spec)
        if spec.get("source") != c["source"]:
            out.append(f"config {c['name']}: source differs from its file")
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w['name']}: keys {sorted(w)}")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config {w['config']}")
        if w["name"] != f"{w['config']}.{w['traffic']}":
            out.append(f"workload {w['name']}: not <config>.<traffic>")
        if not NAME.match(w["traffic"]):
            out.append(f"workload {w['name']}: bad traffic name")
        if not (here / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic/{w['traffic']}.json")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair appears twice")
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in bench["workloads"]}
    for c in configs:
        if c not in used:
            out.append(f"config {c}: used by no cell")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound",
                                      "source"}:
            out.append(f"end_to_end {m['name']}: keys {sorted(m)}")
        if m["source"] not in SOURCES_E2E:
            out.append(f"end_to_end {m['name']}: source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"end_to_end {m['name']}: bound {m['bound']}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source",
                                      "layer", "moves"}:
            out.append(f"per_layer {m['name']}: keys {sorted(m)}")
        if m["source"] not in SOURCES:
            out.append(f"per_layer {m['name']}: source {m['source']}")
        if not (here / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"per_layer {m['name']}: no metrics/{m['name']}.py")
        else:
            eps = getattr(_load(here / "metrics" / f"{m['name']}.py"),
                          "ENTRY_POINTS", {})
            if not (isinstance(eps, dict) and all(
                    isinstance(fns, dict) and all(callable(f) for f in
                                                  fns.values())
                    for fns in eps.values())):
                out.append(f"per_layer {m['name']}: ENTRY_POINTS is not "
                           f"{{module: {{function: shape}}}}")
        mv = e2e.get(m["moves"])
        if mv is None:
            out.append(f"per_layer {m['name']}: moves unknown {m['moves']}")
            continue
        for c in m.get("workloads", cells):
            if c not in cells:
                out.append(f"per_layer {m['name']}: unknown cell {c}")
            elif not _applies(mv, c):
                out.append(f"per_layer {m['name']}: cell {c} does not "
                           f"report {m['moves']}")
    for c in cells:
        if not any(_applies(m, c) for m in bench["per_layer"]):
            out.append(f"cell {c}: no per-layer metric")
        if sum(_applies(m, c) for m in bench["end_to_end"]) < 2:
            out.append(f"cell {c}: needs setup_s and another end-to-end "
                       f"metric")
    return out


def check(bench: Dict, root: Path = ROOT) -> None:
    bad = problems(bench, root)
    if bad:
        raise ValueError("BENCHMARK.json: " + "; ".join(bad))


def metric_units(bench: Dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}
