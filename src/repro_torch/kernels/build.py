"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` (Hopper) into ``<repo>/build/kernels/``, then
loaded with ``ctypes``. Headers shared between sources live in
``kernels/csrc/`` (on the include path). A library is rebuilt when its
source or a shared header is newer; several sources build in parallel, one
``nvcc`` process each. Nothing here runs at import time: the first kernel
launch builds what it needs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(INCLUDE_DIR)]

_LOADED: Dict[Path, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}     # source name -> nvcc/ptxas output


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}.so"


def build(sources: Sequence[Path]) -> List[Path]:
    """Compile every stale source, all ``nvcc`` processes started together.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = max((h.stat().st_mtime for h in INCLUDE_DIR.glob("*.cuh")),
                  default=0.0)
    procs = []
    for src in sources:
        out = _target(src)
        if out.exists() and out.stat().st_mtime >= max(src.stat().st_mtime,
                                                        headers):
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [_target(s) for s in sources]


def load(src: Path) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _LOADED.get(src)
    if lib is None:
        (path,) = build([src])
        lib = _LOADED[src] = ctypes.CDLL(str(path))
    return lib
