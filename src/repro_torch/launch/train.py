"""End-to-end training driver, on the GPU (counterpart of the reference's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 50 --batch 8 --seq 256 [--reduced | --full] \
        [--ckpt-dir DIR] [--ckpt-every 20] [--inject-failure N] \
        [--seed 0] [--device cpu]

Runs the whole substrate stack at world size 1: the synthetic sharded
data pipeline, AdamW with fp32 master weights, remat, async
checkpointing and the fault-tolerance supervisor (restart from the last
checkpoint on a failure; ``--inject-failure N`` fails step N once to
watch it recover). Same flags, defaults and printed lines as the
reference; parameters are ``repro_torch.models.init_params`` from a
``torch.Generator`` seeded with ``--seed`` (torch cannot reproduce
``jax.random``), every leaf on the device. ``--ckpt-dir`` defaults to
``repro_ckpt`` in the temporary directory (``/tmp/repro_ckpt`` unless
``TMPDIR`` says otherwise). Runs on ``cuda`` unless ``--device cpu``; a
missing GPU raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (OptimizerConfig, ShapeConfig, get_config,
                                reduced)
from repro_torch.data import SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state, make_train_step
from repro_torch.runtime import TrainSupervisor


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run(args: argparse.Namespace, log_every: int = 10) -> dict:
    """Trains as the CLI does and returns what it measured: ``history``
    {step: (loss, grad_norm, xent, aux, step seconds)} of the last time
    each step ran, ``restarts``, ``seconds`` (from the step-0 save to the
    last checkpoint written), ``tok_per_s`` and, on a GPU, ``peak_hbm_gb``.
    A step's seconds end when the device is done with it."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train --device cuda: no CUDA device available; "
                           "pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    ocfg = OptimizerConfig(warmup_steps=10, total_steps=args.steps)

    print(f"[train] {cfg.name} reduced={args.reduced} "
          f"params={cfg.param_count()/1e6:.1f}M "
          f"batch={args.batch}x{args.seq}", flush=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev, host_experts=False)
    opt = init_opt_state(params)
    data = SyntheticLM(cfg, shape, seed=args.seed)
    step_fn = make_train_step(cfg, ocfg)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    history: Dict[int, tuple] = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def do_step(state, i):
        params, opt = state
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, to_device(data.batch(i), dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history[i] = (m["loss"], m["grad_norm"], m["xent"], m["aux"],
                      time.perf_counter() - t0)
        if i % log_every == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f}", flush=True)
        return (params, opt)

    def save(i, state):
        mgr.save(i, {"params": state[0], "opt": state[1]})

    def restore():
        tpl = {"params": params, "opt": opt}
        restored, step = mgr.restore(tpl)
        print(f"  [recovered from checkpoint @ step {step}]", flush=True)
        return (restored["params"], restored["opt"]), step

    sup = TrainSupervisor(do_step, save, restore, ckpt_every=args.ckpt_every)
    t0 = time.time()
    save(0, (params, opt))     # step-0 baseline so recovery always has one
    state, _ = sup.run((params, opt), 0, args.steps,
                       failure_at=args.inject_failure)
    mgr.wait()
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"[train] done: {args.steps} steps, {toks/dt:.0f} tok/s, "
          f"{sup.restarts} restarts, {dt:.1f}s", flush=True)
    out = dict(history={i: tuple(float(v) for v in h)
                        for i, h in sorted(history.items())},
               restarts=sup.restarts, seconds=dt, tok_per_s=toks / dt,
               state=state, cfg=cfg)
    if dev.type == "cuda":
        out["peak_hbm_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def main(argv: Optional[list] = None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
