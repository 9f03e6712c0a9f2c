"""A configuration with its own layer layout, its own kernel and its own
spans joins the benchmark as files and entries alone: a copy of the
benchmark gains a configuration, a reference, a system, a mix, a reader
of a span the harness never named and a reader that declares a kernel
entry point of the program, and nothing that was there is edited. The
readings of today's cells stay the parent's: the grouped kernels' call
records, ``gmm_roofline``, and the idle labels of today's spans."""
import hashlib
import json
import shutil
import sys
import time

import pytest
import torch

from perfbench import harness, manifest
from perfbench.devtrace import DeviceTrace, Op
from perfbench.reading import Reading
from perfbench.tests import hybrid, tiny
from perfbench.tests.test_perfbench_manifest import keeps_accepted

CELL = "hybrid-mixer.hybrid_mix"
KERNEL_MODULE = "perfbench_joins_scan"

# a kernel entry point of the program (the stand-in's): a scan over
# positions, counting its launches as the port's entry points do
KERNEL = '''
import torch


def scan(x, a):
    """x [B, L, D], a [D] -> the running sum over L of x * a."""
    scan.launches += 1
    return torch.cumsum(x * a, dim=1)


scan.launches = 0
'''

# the system: the test layout's stand-in, each step running the scan over
# every request's last 8 embeddings inside an ``engine``/``mixer_scan``
# span before its tokens
SYSTEM = f'''
import time

import torch

import {KERNEL_MODULE} as kernel
from perfbench.tests import hybrid


class Scheduler(hybrid.Scheduler):
    def step(self):
        t0 = time.perf_counter_ns()
        p = self.engine.params
        for r in self.live:
            x = p["embed"][torch.as_tensor(r.tokens[-8:])].float()[None]
            kernel.scan(x, p["ln"][0].float())
        if self.recorder is not None and self.live:
            self.recorder.complete("engine", "mixer_scan", t0,
                                   time.perf_counter_ns())
        super().step()


def build(cfg, mix, params, seed, device, recorder=None):
    engine = hybrid.Engine(params, cfg)
    return engine, Scheduler(engine, recorder)
'''

REFERENCE = ("from perfbench.tests.hybrid import (  # noqa: F401\n"
             "    decode_flops, draw, forward, host_tier)\n")

SPAN_READER = '''
from perfbench.reading import mean_ms


def read(r):
    return mean_ms(r.spans("engine", "mixer_scan"))
'''

# a kernel's roofline reader: its entry point declared, its work counted
# here, over the yardstick's peaks; what it was handed kept in SEEN
ROOFLINE_READER = f'''
from perfbench import roofline

SEEN = []


def _shape(x, a):
    return tuple(x.shape)


ENTRY_POINTS = {{"{KERNEL_MODULE}": {{"scan": _shape}}}}


def work(B, L, D, itemsize=4):
    """(bytes, operations): x and out once, a once; a product and a sum
    an element."""
    return (2 * B * L * D + D) * itemsize, 2 * B * L * D


def read(r):
    SEEN.append(r)
    calls = r.calls("scan")
    if r.device is None or not calls:
        return None
    ops = [o for o in r.device.within(r.t0_ns, r.t1_ns)
           if o.cat == "kernel" and "scan" in o.name]
    device = sum(o.t1 - o.t0 for o in ops) / 1e9
    bound = sum(roofline.bound_s(*work(*c[1:-1]))[0] for c in calls)
    return 100.0 * bound / device if device > 0 else None
'''


def tree_digest():
    """sha256 over BENCHMARK.json and every file under perfbench/."""
    h = hashlib.sha256()
    files = [manifest.ROOT / "BENCHMARK.json"] + sorted(
        p for p in (manifest.ROOT / "perfbench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts)
    for p in files:
        h.update(str(p.relative_to(manifest.ROOT)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def joined(tmp_path_factory):
    """The copy, its manifest, and one traced CPU run of the new cell
    (``run_cell``'s result and the reading the kernel's reader was
    handed)."""
    before = tree_digest()
    tmp = tmp_path_factory.mktemp("joined")
    root, prog = tmp / "checkout", tmp / "src"
    shutil.copytree(manifest.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    prog.mkdir()
    (prog / f"{KERNEL_MODULE}.py").write_text(KERNEL)
    here = root / "perfbench"
    cfg = dict(hybrid.CONFIG, system="hybrid_mixer",
               reference="hybrid_mixer", reduced=["num_hidden_layers"],
               published={"num_hidden_layers": 8})
    (here / "configs/hybrid-mixer.json").write_text(json.dumps(cfg))
    (here / "systems/hybrid_mixer.py").write_text(SYSTEM)
    (here / "reference/hybrid_mixer.py").write_text(REFERENCE)
    (here / "traffic/hybrid_mix.json").write_text(
        json.dumps(dict(tiny.MIX, clients=1)))
    (here / "metrics/mixer_scan_ms.py").write_text(SPAN_READER)
    (here / "metrics/scan_roofline.py").write_text(ROOFLINE_READER)
    bench = manifest.load()
    bench["configs"].append({
        "name": "hybrid-mixer", "source": cfg["source"],
        "file": "perfbench/configs/hybrid-mixer.json",
        "reduced": ["num_hidden_layers"], "why": "a layout of its own"})
    bench["workloads"].append({
        "name": CELL, "config": "hybrid-mixer", "traffic": "hybrid_mix",
        "chips": 1, "why": "its mixer's span and its scan kernel"})
    bench["per_layer"] += [
        {"name": "mixer_scan_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "Mixer (test layout)",
         "moves": "ttft_ms", "workloads": [CELL]},
        {"name": "scan_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "Kernels (test layout scan)",
         "moves": "ttft_ms", "workloads": [CELL]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    sys.path.insert(0, str(prog))
    threads = torch.get_num_threads()
    torch.set_num_threads(harness.THREADS)
    try:
        cell = manifest.cell(bench, CELL, root)
        result = harness.run_cell(cell, 9, 0.5, True, "cpu")
        seen = manifest.reader("scan_roofline", root).__globals__["SEEN"]
        yield dict(root=root, bench=bench, cell=cell, result=result,
                   reading=seen[-1], kernel=sys.modules[KERNEL_MODULE],
                   before=before)
    finally:
        torch.set_num_threads(threads)
        sys.path.remove(str(prog))


def test_the_copy_keeps_the_manifests_rules(joined):
    bench, root = joined["bench"], joined["root"]
    assert manifest.load(root) == bench
    assert manifest.problems(bench, root) == []
    assert keeps_accepted(bench)
    for c in bench["configs"]:
        spec = json.loads((root / c["file"]).read_text())
        assert manifest.cut_problems(c["name"], c["reduced"], spec) == []
    cell = joined["cell"]
    assert cell.root == root and {"mixer_scan_ms", "scan_roofline"} <= \
        set(cell.per_layer)
    assert "scan_roofline" not in manifest.cell(
        bench, "mixtral-8x7b-l24.chat1", root).per_layer
    eps = manifest.entry_points(cell.per_layer, root)
    assert set(eps) == {"repro_torch.kernels.moe_gmm.ops", KERNEL_MODULE}
    assert set(eps[KERNEL_MODULE]) == {"scan"}


def test_the_new_cells_traced_run_reads_its_span_and_its_kernels_calls(
        joined):
    r, reading = joined["result"], joined["reading"]
    assert r["correct"] is True, r["check"]
    assert r["metrics"]["mixer_scan_ms"]["value"] > 0
    # no device trace on the CPU: the roofline reader returns nothing
    assert "scan_roofline" not in r["metrics"]
    calls = reading.calls("scan")
    assert calls and all(c[0] == "scan" and c[1] == 1 and 1 <= c[2] <= 8
                         and c[3] == hybrid.CONFIG["hidden_size"]
                         and len(c) == 5 for c in calls)
    assert [c[-1] for c in calls] == sorted(c[-1] for c in calls)
    # each call was made inside one of the system's mixer spans
    steps = reading.spans("engine", "mixer_scan")
    assert all(any(a <= c[-1] <= b for a, b in steps) for c in calls)
    # the wrapper is gone and the launches it saw are the module's
    k = joined["kernel"]
    assert k.scan.__qualname__ == "scan" and k.scan.launches >= len(calls)


def test_the_new_kernels_reader_reads_a_device_trace(joined):
    """On a made trace, each scan kernel's time against its calls' bound."""
    reading = joined["reading"]
    read = manifest.reader("scan_roofline", joined["root"])
    calls = reading.calls("scan")
    a = reading.t0_ns
    ops = [Op("scan_kernel", "kernel", a + 10 * i, a + 10 * i + 7, 7, 0)
           for i in range(len(calls))]
    made = Reading(**dict(vars(reading), device=DeviceTrace(ops, 1.0, 2)))
    work = read.__globals__["work"]
    from perfbench import roofline
    bound = sum(roofline.bound_s(*work(*c[1:-1]))[0] for c in calls)
    assert read(made) == pytest.approx(100 * bound / (7e-9 * len(calls)))


def test_idle_under_the_new_span_is_labelled_by_it(joined):
    """A gap in the middle of a ``mixer_scan`` span of the run goes to that
    span, a name the harness never listed."""
    r = joined["reading"]
    a, b = r.spans("engine", "mixer_scan")[0]
    q = max((b - a) // 4, 1)
    ops = [Op("k", "kernel", r.t0_ns, a + q, 7, 0),
           Op("k", "kernel", a + 3 * q, r.t1_ns, 7, 0)]
    got = harness._breakdown(DeviceTrace(ops, 1.0, 2), r)
    assert got["idle_gaps"] == [["engine:mixer_scan", 2 * q / 1e9]]


def test_no_file_that_was_there_is_touched(joined):
    assert tree_digest() == joined["before"]


# -- today's readings, as the parent read them ------------------------------

class ParentKernelShapes:
    """The parent's recorder of the grouped kernels' calls, as it was."""

    NAMES = ("swiglu_gmm", "gmm")

    def __init__(self):
        self.calls = []
        self._orig = {}

    def __enter__(self):
        from repro_torch.kernels.moe_gmm import ops
        for name in self.NAMES:
            fn = getattr(ops, name)
            self._orig[name] = fn
            setattr(ops, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def wrapper(x, *ws):
            G, C, K = x.shape
            self.calls.append((name, G, C, K, ws[0].shape[2],
                               time.perf_counter_ns()))
            return fn(x, *ws)
        wrapper.launches = getattr(fn, "launches", 0)
        return wrapper

    def __exit__(self, *exc):
        from repro_torch.kernels.moe_gmm import ops
        for name, fn in self._orig.items():
            fn.launches = getattr(ops, name).launches
            setattr(ops, name, fn)


def test_the_tiny_runs_kernel_calls_are_the_parents(tmp_path, monkeypatch,
                                                    harness_threads):
    """In one traced run of the tiny cell the parent's recorder sits under
    the declared one: both see the same calls, in the same order, and the
    entry points and their launch counts come back."""
    from repro_torch.kernels.moe_gmm import ops
    before = (ops.swiglu_gmm, ops.gmm, ops.swiglu_gmm.launches,
              ops.gmm.launches)
    seen = []

    class Both(harness.KernelShapes):
        def __enter__(self):
            super().__enter__()
            self.parent = ParentKernelShapes().__enter__()
            return self

        def __exit__(self, *exc):
            self.parent.__exit__(*exc)
            super().__exit__(*exc)
            seen.append((list(self.calls), list(self.parent.calls)))
    monkeypatch.setattr(harness, "KernelShapes", Both)
    r = harness.run_cell(tiny.cell(tmp_path), 3, 0.5, True, "cpu")
    assert r["correct"] is True, r["check"]
    ((mine, parents),) = seen
    assert mine and [c[:-1] for c in mine] == [c[:-1] for c in parents]
    assert {c[0] for c in mine} == {"swiglu_gmm", "gmm"}
    assert (ops.swiglu_gmm, ops.gmm) == before[:2]
    # the CPU path launches nothing: the counters are the parent's too
    assert (ops.swiglu_gmm.launches, ops.gmm.launches) == before[2:]


# a made pairing: a kernel with no call before it, a call left without a
# kernel
GMM_OPS = [Op("void ring::gmm_tma_kernel<1, true, 128>(CUtensorMap)",
              "kernel", 1_000_000, 1_620_000, 7, 0),
           Op("void ring::gmm_tma_kernel<1, false, 256>(CUtensorMap)",
              "kernel", 1_700_000, 2_010_000, 7, 0),
           Op("void ring::gmm_scalar_kernel<2, true>(float)", "kernel",
              2_500_000, 2_560_000, 7, 0),
           Op("void ring::gmm_scalar_kernel<2, false>(float)", "kernel",
              2_600_000, 2_640_000, 7, 0),
           Op("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 2_700_000,
              2_900_000, 9, 1 << 20),
           Op("void ring::gmm_tma_kernel<1, true, 128>(CUtensorMap)",
              "kernel", 3_000_000, 3_400_000, 7, 0)]
GMM_CALLS = [("swiglu_gmm", 6, 4, 4096, 14336, 990_000),
             ("gmm", 6, 4, 14336, 4096, 1_650_000),
             ("swiglu_gmm", 2, 1, 4096, 14336, 2_400_000),
             ("gmm", 2, 1, 14336, 4096, 2_590_000),
             ("swiglu_gmm", 3, 9, 4096, 14336, 3_500_000)]
# the parent's reader on GMM_CALLS (perfbench/metrics/gmm_roofline.py at
# the commit before entry points were declared)
PARENTS_GMM_ROOFLINE = 81.74146401970727


def made_reading(calls):
    return Reading(cfg={}, t0=0.0, t1=0.01, served=[], events=[],
                   stats0=None, stats1=None,
                   device=DeviceTrace(GMM_OPS, 1.0, 2), kernel_calls=calls)


def test_gmm_roofline_reads_the_parents_number():
    """A made pairing reads what the parent's reader read."""
    r = made_reading(GMM_CALLS)
    assert manifest.reader("gmm_roofline")(r) == PARENTS_GMM_ROOFLINE
    assert r.calls("gmm", "swiglu_gmm") == GMM_CALLS


def test_gmm_roofline_reads_past_other_entry_points_calls(joined, capsys):
    """Calls of another reader's entry points, of any length, stand among
    the grouped kernels' calls: ``gmm_roofline`` and the trace's report
    pass them by and read the parent's number; on the new cell's own run
    they raise nothing."""
    mixed = [("scan", 1, 990_500)] + GMM_CALLS[:2] + [
        ("scan", 1, 8, 64, 2_000_000)] + GMM_CALLS[2:] + [
        ("scan", 3_600_000)]
    r = made_reading(mixed)
    assert manifest.reader("gmm_roofline")(r) == PARENTS_GMM_ROOFLINE
    harness._report_trace(r.device, r)
    assert "5 grouped-kernel calls" in capsys.readouterr().err
    reading = joined["reading"]
    assert reading.calls("scan")
    a = reading.t0_ns
    ops = [Op("scan_kernel", "kernel", a, a + 7, 7, 0),
           Op("void ring::gmm_tma_kernel<1, true, 128>(CUtensorMap)",
              "kernel", a + 10, a + 17, 7, 0)]
    made = Reading(**dict(vars(reading), device=DeviceTrace(ops, 1.0, 2)))
    gmm = manifest.reader("gmm_roofline", joined["root"])(made)
    assert gmm is None or gmm > 0
    harness._report_trace(made.device, made)


PARENT_SPANS = (("sched", "tick"), ("sched", "admission"),
                ("sched", "decode+drain"), ("engine", "dispatch"),
                ("engine", "execute+drain"), ("engine", "warm_replay"),
                ("engine", "prefill_forward"), ("engine", "attn_route"),
                ("engine", "picks"), ("engine", "probe"),
                ("engine", "execute"), ("engine", "post_fetch"))


def test_breakdown_of_the_parents_spans_is_the_parents():
    """Spans of the parent's twelve names alone (and a request's and a
    slot's, which neither labels): the labels the parent gave."""
    from collections import namedtuple
    from perfbench import devtrace
    Ev = namedtuple("Ev", "kind track name ts_ns dur_ns args")
    ms = 1_000_000
    ev = [Ev("X", "req:3", "prefill", 0, 900 * ms, None),
          Ev("X", "slot:0", "occupied", 0, 900 * ms, None)]
    for i in range(4):
        t = i * 200 * ms
        ev += [Ev("X", "sched", "tick", t, 190 * ms, None),
               Ev("X", "sched", "admission", t, 20 * ms, None),
               Ev("X", "engine", "prefill_forward", t + 1 * ms, 15 * ms,
                  None),
               Ev("X", "sched", "decode+drain", t + 20 * ms, 170 * ms, None),
               Ev("X", "engine", "dispatch", t + 21 * ms, 120 * ms, None),
               Ev("X", "engine", "execute+drain", t + 141 * ms, 40 * ms,
                  None),
               Ev("X", "engine", "warm_replay", t + 182 * ms, 6 * ms, None)]
        for l in range(4):
            u = t + 21 * ms + l * 30 * ms
            ev += [Ev("X", "engine", "attn_route", u, 12 * ms, None),
                   Ev("X", "engine", "picks", u + 12 * ms, 2 * ms, None),
                   Ev("X", "engine", "probe", u + 14 * ms, 5 * ms, None),
                   Ev("X", "engine", "execute", u + 19 * ms, 8 * ms, None),
                   Ev("X", "engine", "post_fetch", u + 27 * ms, 3 * ms,
                      None)]
    # device busy in 1 ms of every 7: gaps all over the spans above
    ops = [Op("k", "kernel", t, t + ms, 7, 0) for t in range(0, 900 * ms,
                                                            7 * ms)]
    r = Reading(cfg={}, t0=0.0, t1=0.9, served=[], events=ev, stats0=None,
                stats1=None, device=None, kernel_calls=[])
    dev = DeviceTrace(ops, 1.0, 2)
    got = harness._breakdown(dev, r)
    spans = {f"{track}:{name}": r.spans(track, name)
             for track, name in PARENT_SPANS}
    want = devtrace.label_gaps(devtrace.idle_intervals(
        dev.within(r.t0_ns, r.t1_ns), r.t0_ns, r.t1_ns), spans)
    assert got["idle_gaps"] == want
    assert len(want) == 10 and "engine:attn_route" in dict(want)
    assert got["device_ops"] == devtrace.top_ops(dev.within(r.t0_ns,
                                                            r.t1_ns))
