"""Grouped expert matmuls: wrappers over the Hopper kernels and their plain
PyTorch versions.

``swiglu_gmm`` and ``gmm`` replace the JAX package's Pallas TPU kernels
(``src/repro/kernels/moe_gmm/moe_gmm.py``: ``swiglu_gmm`` /
``_swiglu_kernel`` and ``gmm`` / ``_gmm_kernel``) with the hand-written
CUDA kernels in ``csrc/moe_gmm.cu``; that file's header gives their bound
(bytes: the weights are read once) and what the design does about it.

A wrapper runs the plain version only for tensors that lie on the CPU. For
a CUDA tensor it launches the kernel or raises: it never falls back. On
every device it refuses an input that requires grad
(:func:`repro_torch.kernels.guard.refuse_autograd`). Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.guard import refuse_autograd

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_swiglu_gmm_bf16.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.moe_swiglu_gmm_bf16.restype = i
    lib.moe_gmm_bf16.argtypes = [p, p, p, i, i, i, i, p]
    lib.moe_gmm_bf16.restype = i
    return lib


# -- plain versions (same rounding points as the kernels) --------------------

def swiglu_gmm_plain(x: torch.Tensor, w1: torch.Tensor,
                     w3: torch.Tensor) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3) in fp32, rounded once to x's dtype."""
    a = torch.matmul(x.float(), w1.float())
    b = torch.matmul(x.float(), w3.float())
    return (a * (1.0 / (1.0 + torch.exp(-a))) * b).to(x.dtype)


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in fp32, rounded once to x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


# -- wrappers ----------------------------------------------------------------

def _check(x: torch.Tensor, ws, name: str):
    """Shapes of x [G, C, K] against ws [G, K, N]; returns (G, C, K, N)."""
    if x.dim() != 3 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"{name}: want x [G, C, K] and w [G, K, N], got "
                         f"{tuple(x.shape)} and "
                         f"{[tuple(w.shape) for w in ws]}")
    G, C, K = x.shape
    N = ws[0].shape[2]
    for w in ws:
        if tuple(w.shape) != (G, K, N):
            raise ValueError(f"{name}: weight {tuple(w.shape)} does not "
                             f"match x {tuple(x.shape)} and N={N}")
    if any(t.device != x.device for t in ws):
        raise ValueError(f"{name}: all tensors must be on one device")
    if any(t.dtype != x.dtype for t in ws):
        raise ValueError(f"{name}: all tensors must share one dtype")
    return G, C, K, N


def _check_cuda(tensors, name: str) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             f"tensors")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def swiglu_gmm(x: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor) -> torch.Tensor:
    """Fused silu(x@w1) * (x@w3): [G, C, D] x [G, D, F] -> [G, C, F]."""
    refuse_autograd("swiglu_gmm", x, w1, w3)
    G, C, D, F = _check(x, (w1, w3), "swiglu_gmm")
    if x.device.type == "cpu":
        return swiglu_gmm_plain(x, w1, w3)
    if x.device.type != "cuda":
        raise ValueError(f"swiglu_gmm: unsupported device {x.device}")
    _check_cuda((x, w1, w3), "swiglu_gmm")
    out = torch.empty((G, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    err = _lib().moe_swiglu_gmm_bf16(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), out.data_ptr(),
        G, C, D, F, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "swiglu_gmm")
    swiglu_gmm.launches += 1
    return out


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul x [G, C, K] @ w [G, K, N] -> [G, C, N]."""
    refuse_autograd("gmm", x, w)
    G, C, K, N = _check(x, (w,), "gmm")
    if x.device.type == "cpu":
        return gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {x.device}")
    _check_cuda((x, w), "gmm")
    out = torch.empty((G, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    err = _lib().moe_gmm_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), G, C, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gmm")
    gmm.launches += 1
    return out


swiglu_gmm.launches = 0
gmm.launches = 0


def moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU FFN: x [G, C, D] -> [G, C, D]. The [G, C, F]
    intermediate is rounded to x's dtype between the two kernels, as in
    the reference (``src/repro/kernels/moe_gmm/ops.py``)."""
    return gmm(swiglu_gmm(x, w1, w3), w2)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul [G, C, D] @ [G, D, F] (the reference's padded
    wrapper; the kernel masks ragged shapes itself)."""
    return gmm(x, w)
