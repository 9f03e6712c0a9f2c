"""Checkpointing: async snapshots, shard manifests, atomic publishing (the
port's ``checkpoint/ckpt.py``, with the reference's on-disk layout).

Layout, the reference's: ``<dir>/step_%08d/shard_0.npz`` holding
``leaf_i`` for the tree's leaves in the reference's flatten order (dict
keys sorted, an :class:`~repro_torch.optim.AdamWState` in field order),
bf16 stored upcast to fp32 (lossless), and ``manifest.json`` with each
leaf's shape and dtype. A save writes ``step_%08d.tmp`` and publishes it
with ``os.replace``, so a crash mid-save never corrupts the latest
complete checkpoint. A checkpoint either package writes restores in the
other. :class:`CheckpointManager` snapshots device tensors to host memory
on the caller's thread and writes them on a daemon thread; ``wait()``
joins it before the next save (one outstanding snapshot). The
reference's ``reshard_tree`` (elastic restore onto a new mesh) belongs to
``sharding/``, slice 8 of the port.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten

_NP_NAME = {torch.bfloat16: "bfloat16", torch.float32: "float32",
            torch.float16: "float16", torch.int32: "int32",
            torch.int64: "int64", torch.int8: "int8", torch.bool: "bool"}


def _structure(tree: Any) -> str:
    """A readable description of the tree (the manifest's ``treedef``;
    no loader reads it)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        return f"{name}(" + ", ".join(_structure(v) for v in tree) + ")"
    return "*"


def _to_numpy(x: Any) -> Tuple[np.ndarray, str]:
    """(the array stored, the leaf's dtype name): bf16 upcast to fp32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = _NP_NAME.get(t.dtype, str(t.dtype).split(".")[-1])
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy(), name
    a = np.asarray(x)
    return a, a.dtype.name


def save_checkpoint(dirpath: str | Path, step: int, tree: Any,
                    process_index: int = 0, num_processes: int = 1) -> Path:
    """Synchronous local-shard save (the async manager wraps this)."""
    dirpath = Path(dirpath)
    final = dirpath / f"step_{step:08d}"
    tmp = dirpath / f"step_{step:08d}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    pairs = [_to_numpy(x) for x in leaves(tree)]
    np.savez(tmp / f"shard_{process_index}.npz",
             **{f"leaf_{i}": a for i, (a, _) in enumerate(pairs)})
    if process_index == 0:
        manifest = {
            "step": step,
            "num_processes": num_processes,
            "treedef": _structure(tree),
            "leaves": [{"shape": list(a.shape), "dtype": name}
                       for a, name in pairs],
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(dirpath: str | Path) -> Optional[int]:
    dirpath = Path(dirpath)
    if not dirpath.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in dirpath.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(dirpath: str | Path, template: Any,
                    step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template``: each leaf a new tensor
    with the template leaf's dtype and device (a template leaf that is no
    tensor takes the stored array as is)."""
    dirpath = Path(dirpath)
    if step is None:
        step = latest_step(dirpath)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {dirpath}")
    d = dirpath / f"step_{step:08d}"
    leaves_t = leaves(template)
    with np.load(d / "shard_0.npz") as data:  # one process: whole arrays
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves_t))]
    out = []
    for t, a in zip(leaves_t, arrays):
        if isinstance(t, torch.Tensor):
            # np.array keeps a 0-d leaf 0-d (ascontiguousarray would not)
            out.append(torch.from_numpy(np.array(a, order="C")).to(
                device=t.device, dtype=t.dtype))
        else:
            out.append(a)
    return unflatten(template, iter(out)), step


class CheckpointManager:
    """Async checkpointing with retention and crash-safe publishing."""

    def __init__(self, dirpath: str | Path, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(dirpath)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any):
        self.wait()
        # snapshot device -> host now; IO later
        host_tree = unflatten(tree, iter(
            [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
             else x for x in leaves(tree)]))

        def work():
            try:
                save_checkpoint(self.dir, step, host_tree)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                # read only after wait() joins this thread: the join orders
                # the write before the read
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def restore(self, template: Any, step: Optional[int] = None):
        """The latest (or ``step``'s) checkpoint, after the outstanding
        save is published: unlike the reference's, a restore never races
        the write of the last save (which would restore an older step)."""
        self.wait()
        return load_checkpoint(self.dir, template, step)

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*") if p.is_dir()
                       and not p.name.endswith(".tmp"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
