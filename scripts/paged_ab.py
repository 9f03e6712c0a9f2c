#!/usr/bin/env python3
"""A/B of the paged-KV decode step, or of the whole smoke, between two
checkouts, on one GPU.

    python3 scripts/paged_ab.py PARENT_DIR CHANGE_DIR [--order pccppc]
    python3 scripts/paged_ab.py PARENT_DIR CHANGE_DIR --whole [--order pccp]

Each run is a fresh process that imports ``chip_smoke`` from one checkout
and runs that checkout's own phases: it builds the kernels (cached under
the checkout's ``build/kernels`` after its first run), measures the
pinned host->device copy rate, serves phase 4 (the dense Mixtral serve,
for the model and weights), serves phase 9 (paged KV + segment-streamed
prefill) and profiles 4 paged decode steps (phase 11). Runs alternate in
the order given (``p`` the parent, ``c`` the change), so a drift of the
host's PCIe rate over the call shows in both trees.

Prints each run's lines as they come, then one line per run with the
copy rate, paged tok/s, ms a decode step, host->device copy ms a step on
the compute stream and the device's idle share, and a JSON summary as the
last line. Exits non-zero if any run fails.

With ``--whole`` each run is instead the checkout's own ``chip_smoke.py``,
run from its root in a fresh process (default order parent, change,
change, parent). Each run's output goes to ``chiprun_out/ab_<run>.log``
of the directory this script is run from; the script prints each run's
exit code, seconds and last two lines (the ``kernels`` line and the
result line).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUN = r"""
import json, sys
tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]
import chip_smoke as cs
from repro_torch import kernels
from repro_torch.kernels import build as kbuild
kbuild.build(sorted({k["source"] for k in kernels.ALL}))
gbps = cs.h2d_rate_gbps()
print(f"[h2d] {gbps:.2f} GB/s", flush=True)
engine, _, _ = cs.serve()
paged, _ = cs.serve_paged(engine.params)
p = cs.profile_decode(paged, "paged")
print("AB " + json.dumps(dict(
    gbps=gbps, step_ms=p["step_ms"], idle=p["idle"],
    htod_compute_ms=p["streams"].get("HtoD compute stream", 0.0))))
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(tree)],
                          capture_output=True, text=True, timeout=900,
                          cwd=str(tree))
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"run on {tree} failed (rc {proc.returncode})")
    out = next(json.loads(line[3:]) for line in proc.stdout.splitlines()
               if line.startswith("AB "))
    # phase 9 prints its wall rate: "[paged] served ... (X tok/s wall, ..."
    served = next(line for line in proc.stdout.splitlines()
                  if line.startswith("[paged] served"))
    out["paged_tok_s"] = float(served.split("(")[1].split(" tok/s")[0])
    return out


def run_whole(tree: Path, label: str) -> int:
    """The checkout's whole ``chip_smoke.py``; returns its exit code."""
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    log = out / f"ab_{label}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                            stdout=f, stderr=subprocess.STDOUT).returncode
    dt = time.perf_counter() - t0
    tail = log.read_text().strip().splitlines()[-2:]
    print(f"[ab] {label}: rc={rc} {dt:.0f}s", flush=True)
    print("\n".join(line[:400] for line in tail), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--whole", action="store_true",
                    help="run each checkout's whole chip_smoke.py")
    ap.add_argument("--order", default=None,
                    help="runs in order: p for the parent, c for the change "
                         "(default pccppc, or pccp with --whole)")
    args = ap.parse_args()
    order = args.order or ("pccp" if args.whole else "pccppc")
    trees = {"p": args.parent.resolve(), "c": args.change.resolve()}
    if not order or set(order) - set(trees):
        ap.error("--order takes only the letters p and c")
    results, seen, failed = [], {"p": 0, "c": 0}, False
    for which in order:
        seen[which] += 1
        label = f"{which}{seen[which]}"
        if args.whole:
            failed |= run_whole(trees[which], label) != 0
            continue
        print(f"== {label}: {trees[which]}", flush=True)
        r = dict(run=label, **run(trees[which]))
        results.append(r)
    if args.whole:
        return 1 if failed else 0
    for r in results:
        print(f"[ab] {r['run']}: {r['gbps']:.2f} GB/s, paged "
              f"{r['paged_tok_s']:.3f} tok/s, {r['step_ms']:.3f} ms/step, "
              f"HtoD compute stream {r['htod_compute_ms']:.3f} ms/step, "
              f"idle {r['idle']:.4f}")
    print(json.dumps({"runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
