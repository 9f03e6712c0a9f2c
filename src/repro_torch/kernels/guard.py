"""The one rule every kernel wrapper keeps about autograd.

The CUDA kernels have no backward, and a tensor a ``ctypes`` launch
writes carries no ``grad_fn``: a train-mode forward that reached a
wrapper on the card would cut the gradient of every parameter upstream,
with no error. So each wrapper calls :func:`refuse_autograd` first, on
every device (its CPU branch runs a differentiable plain version, which
would hide the mistake from the CPU tests). Train mode picks its
differentiable functions by mode, in the model code.
"""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raises if autograd would record this call: grad is enabled and an
    input (None entries skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            f"grad; a train-mode forward runs the differentiable plain "
            f"function, chosen by mode in the model code")
