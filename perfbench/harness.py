"""One run of one cell: set-up, the measured window, the per-layer reading
(``--trace 1``), the correctness check, the result line.

    python3 perfbench/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the process's start to the window's): imports,
the weights drawn from the seed by the configuration's reference module
(``host_tier``, ``draw``: expert tables into pinned host memory), the
engine built, kernels loaded (built by nvcc in a fresh checkout), one
warm-up request a slot at the mix's shortest prompt. The window: the
mix's closed-loop clients send requests from the seed's stream for
``--seconds``; every token's arrival is taken on the host clock in the
request's ``on_token`` callback. With ``--trace 1`` the program's
recorder and ``torch.profiler`` (CUDA activity) run over the window, the
benchmark's wrappers record the shapes of the kernel entry points the
cell's readers declare, and the per-layer metrics are read. After the
window: the device's memory peak, the program freed, the plain reference
over every served request, the pinned host tier freed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from perfbench import check, devtrace, manifest, traffic, weights
from perfbench.window import Served, end_to_end

ROOT = manifest.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RECORDER_EVENTS = 1 << 20
THREADS = 1              # the host's intra-op threads: the engine's host
                         # work is small tensors, and spare cores stay idle


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is, whole, one of ``FORBIDDEN``: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its CUDA libraries under ``build/kernels`` itself)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))


def load_config(cell: manifest.Cell) -> Dict:
    cfg = json.loads(cell.config_file.read_text())
    cfg["name"] = cell.config
    return cfg


class KernelShapes:
    """Wraps kernel entry points to record each call's (function, *shape,
    host time of the call in perf_counter ns) while active, and puts the
    functions back, with their ``launches`` counters, on leaving.
    ``entry_points``: {module: {function: shape}} (``manifest.
    entry_points``: what the cell's readers declare). The program calls
    the entry points through its modules' globals, so the wrappers sit in
    its path unchanged."""

    def __init__(self, entry_points: Dict[str, Dict[str, Callable]]):
        self.entry_points = entry_points
        self.calls = []
        self._orig = []

    def __enter__(self):
        import importlib
        for modname, fns in self.entry_points.items():
            mod = importlib.import_module(modname)
            for name, shape in fns.items():
                fn = getattr(mod, name)
                self._orig.append((mod, name, fn))
                setattr(mod, name, self._wrap(name, fn, shape))
        return self

    def _wrap(self, name: str, fn: Callable, shape: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            self.calls.append((name, *shape(*args, **kwargs),
                               time.perf_counter_ns()))
            return fn(*args, **kwargs)
        # an entry point that counts its launches does so on the module's
        # global name, which is the wrapper while it is in place
        if hasattr(fn, "launches"):
            wrapper.launches = fn.launches
        return wrapper

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._orig):
            if hasattr(fn, "launches"):
                fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)
        self._orig = []


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(sched, reqs, clients: int, seconds: float,
          on_open: Optional[Callable[[], None]] = None):
    """The closed loop: each client sends its next request when its last
    one has ended; ``sched.step()`` until ``seconds`` have passed.
    Returns (served requests, prompts by index, t0, t_end)."""
    served: List[Served] = []
    prompts: Dict[int, object] = {}
    free = [clients]

    def send():
        r = next(reqs)
        s = Served(index=r.index, prompt_len=len(r.prompt),
                   t_send=time.perf_counter())

        def on_token(tok: int, done: bool, s=s) -> None:
            s.times.append(time.perf_counter())
            s.tokens.append(int(tok))
            if done:
                s.done = True
                free[0] += 1
        sched.submit(r.prompt, max_new_tokens=r.new_tokens,
                     on_token=on_token)
        served.append(s)
        prompts[r.index] = r.prompt

    if on_open is not None:
        on_open()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        while free[0] > 0:
            free[0] -= 1
            send()
        sched.step()
    return served, prompts, t0, t_end


def warm_up(sched, mix: traffic.Mix, vocab: int, seed: int) -> None:
    for r in traffic.warmup_requests(mix, vocab, seed):
        sched.submit(r.prompt, max_new_tokens=r.new_tokens)
    sched.run()


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             host: Optional[Dict] = None, control: bool = False) -> Dict:
    """One run; returns the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], [``control``],
    ``numbers``, ``check``: the last). ``host``: expert tables to draw
    into (the reference module's ``host_tier``); if None, made here and
    freed once the check has read them. ``control``: also the control's
    numbers, the reference in float8 over the same prompts and served
    tokens (``perfbench/limits.py``; never in a benchmark run)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg = load_config(cell)
    mix = traffic.load_mix(cell.traffic_file)
    system = manifest.module("systems", cfg["system"], cell.root)
    reference = manifest.module("reference", cfg["reference"], cell.root)

    own_host = host is None
    if own_host:
        host = reference.host_tier(cfg, pinned=dev.type == "cuda")
    params = reference.draw(cfg, seed, dev, host=host)
    recorder = None
    if trace:
        from repro_torch.obs import TraceRecorder
        recorder = TraceRecorder(RECORDER_EVENTS)
    engine, sched = system.build(cfg, mix, params, seed, dev,
                                 recorder=recorder)
    warm_up(sched, mix, cfg["vocab_size"], seed)
    _sync(dev)
    reqs = traffic.requests(mix, cfg["vocab_size"], seed)

    prof, shapes, marks = None, None, []

    def mark() -> None:
        a = time.perf_counter_ns()
        _sync(dev)
        marks.append((a, time.perf_counter_ns()))

    stats0 = engine.stats
    events0 = len(recorder.events()) if recorder is not None else 0
    if trace:
        shapes = KernelShapes(manifest.entry_points(
            cell.per_layer, cell.root)).__enter__()
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    setup_s = time.perf_counter() - t_start
    try:
        if prof is not None:
            prof.__enter__()
        served, prompts, t0, t_end = serve(
            sched, reqs, mix.clients, seconds,
            on_open=mark if prof is not None else None)
        if prof is not None:
            mark()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if shapes is not None:
            shapes.__exit__(None, None, None)
    stats1 = engine.stats
    t_close = time.perf_counter()

    result: Dict = {"correct": False, "attempted": len(served), "failed": 0}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                      if dev.type == "cuda" else 0)}
    units = manifest.metric_units(manifest.load(cell.root))
    if trace:
        from perfbench.reading import Reading
        devtr = _device_trace(prof, marks) if prof is not None else None
        r = Reading(cfg=cfg, t0=t0,
                    t1=marks[-1][1] / 1e9 if marks else t_close,
                    served=served, events=recorder.events()[events0:],
                    stats0=stats0, stats1=stats1, device=devtr,
                    kernel_calls=list(shapes.calls), root=cell.root)
        values = {name: manifest.reader(name, cell.root)(r)
                  for name in cell.per_layer}
        if devtr is not None:
            _report_trace(devtr, r)
            dev_info["busy_s"] = devtrace.busy_ns(devtr.ops, r.t0_ns,
                                                  r.t1_ns) / 1e9
            dev_info["window_s"] = (r.t1_ns - r.t0_ns) / 1e9
            result["breakdown"] = _breakdown(devtr, r)
    else:
        values = end_to_end(served, t0, t_end)
        values["setup_s"] = setup_s
        values = {k: values.get(k) for k in cell.end_to_end}
    result["metrics"] = {k: {"value": float(v), "unit": units[k]}
                         for k, v in values.items() if v is not None}
    result["device"] = dev_info

    # the program's state goes before the reference runs
    del engine, sched, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    seqs, toks = check.sequences(served, prompts)
    logits = reference.forward(params, cfg, seqs, mix.capacity, dev)
    nums = check.numbers(check.gaps(logits, toks))
    if control:
        low = reference.forward(params, cfg, seqs, mix.capacity, dev,
                                weights="fp8")
        result["control"] = check.numbers(check.control_gaps(logits, low))
        del low
    del logits, params
    if own_host:
        weights.release(host)
    result["correct"], shown = check.verdict(nums, cfg.get("limits", {}))
    result["numbers"] = nums
    result["check"] = shown
    return result


def _device_trace(prof, marks):
    """The profiler's trace, exported inside the checkout, reduced, and
    the file removed."""
    path = ROOT / "build" / "perfbench" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return devtrace.load(path, marks)
    finally:
        path.unlink()


def _report_trace(devtr, r) -> None:
    from perfbench.metrics import gmm_roofline
    ops = devtr.within(r.t0_ns, r.t1_ns)
    gmm = [o for o in ops if o.cat == "kernel" and
           any(k in o.name for k in gmm_roofline.KERNELS)]
    calls = r.calls(*gmm_roofline.KIND.values())
    matched, unmatched = gmm_roofline.pairs(calls, gmm)
    print(f"trace: {len(calls)} grouped-kernel calls and {len(gmm)} "
          f"grouped kernels in the window, {len(matched)} paired, "
          f"{unmatched} unmatched; {len(ops)} device ops; "
          f"{devtr.syncs} synchronize calls, trace clock x "
          f"{devtr.scale:.6f}", file=sys.stderr)


BREAKDOWN_TRACKS = ("sched", "engine")


def _breakdown(devtr, r) -> Dict:
    """The device's longest operations, and its idle time by the shortest
    host span open over each gap (a decode step's idle by its phase):
    every span the program opened on the scheduler's and the engine's
    tracks in the window, by ``<track>:<name>``."""
    ops = devtr.within(r.t0_ns, r.t1_ns)
    spans: Dict[str, List] = {}
    for ev in r.events:
        if (ev.kind == "X" and ev.track in BREAKDOWN_TRACKS
                and r.t0_ns <= ev.ts_ns <= r.t1_ns):
            spans.setdefault(f"{ev.track}:{ev.name}", []).append(
                (ev.ts_ns, ev.ts_ns + ev.dur_ns))
    return {"device_ops": devtrace.top_ops(ops),
            "idle_gaps": devtrace.label_gaps(
                devtrace.idle_intervals(ops, r.t0_ns, r.t1_ns),
                {k: sorted(v) for k, v in spans.items()})}


def check_lines(result: Dict) -> str:
    """Every number of the check, then each compared one beside its
    limit (the last lines)."""
    lines = [f"numbers {json.dumps(result.get('numbers', {}))}"]
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}"
              for k, v in result.get("check", {}).items()]
    return "\n".join(lines)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    bench = manifest.load()
    manifest.check(bench)
    cell = manifest.cell(bench, args.workload)
    cache_dirs(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"perfbench: the program (src/repro_torch) is not in this "
              f"checkout", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    torch.set_num_threads(THREADS)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}: the run must not load JAX or the "
              f"JAX package", file=sys.stderr)
        return 4
    sys.stderr.write(check_lines(result) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
