"""Readings that the correctness limits are set from, for one cell: the
program's numbers over many seeds, the control's over some of them, and a
planted fault's, in one process (the pinned host tier is made once and
drawn into again for each seed).

    python3 perfbench/limits.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2 [--fault unchanged_state] --seconds 51 \\
        --out chiprun_out/limits.jsonl

Each seed is one benchmark run (``harness.run_cell``: weights drawn from
the seed, a fresh engine, the warm-up, a window of ``--seconds`` at the
cell's own load, the program freed, the float32 reference over every
served request); a control seed adds the reference in float8 weights over
the same prompts and tokens (the control's numbers: the gaps of the
tokens float8 puts first). ``--fault`` plants one of
``perfbench/faults.py``'s faults under the timed path for every seed. One
JSON line a seed. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    import torch
    from perfbench import faults, harness, manifest, weights
    if not torch.cuda.is_available():
        print("limits: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.THREADS)
    cell = manifest.cell(manifest.load(), args.workload)
    cfg = harness.load_config(cell)
    reference = manifest.module("reference", cfg["reference"])
    host = reference.host_tier(cfg, pinned=True)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for s in [int(x) for x in args.seeds.split(",")]:
            t = time.perf_counter()
            with (faults.planted(args.fault) if args.fault
                  else nullcontext()):
                r = harness.run_cell(cell, s, args.seconds, False, "cuda",
                                     host=host, control=s in ctrl)
            line = json.dumps({
                "workload": cell.name, "seed": s, "fault": args.fault or None,
                "correct": r["correct"], "program": r["numbers"],
                "control": r.get("control"), "requests": r["attempted"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "seconds": time.perf_counter() - t,
                "card": torch.cuda.get_device_name()})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
    weights.release(host)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
