"""Weight bridge: a reference parameter tree, as numpy arrays, to the
port's parameters and back, dtype preserved bit for bit.

The reference's bf16 leaves reach numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses: they cross as a ``uint16`` view and are
reinterpreted with ``.view(torch.bfloat16)`` (and the reverse on the way
back). The scan-stacked layout (``params["scan"]["s0"]``, leading ``[L]``
axis) is kept as is. Expert tables (``moe.w1/w3/w2``) land in host memory,
pinned when ``device`` is a GPU: they are the engine's host tier.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

EXPERT_TABLES = ("w1", "w3", "w2")


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a: np.ndarray, device="cpu",
                      pin: bool = False) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, owned by torch
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if pin:
        return t.pin_memory()
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """Back to numpy; bf16 returns as ``bf16_dtype`` (e.g.
    ``ml_dtypes.bfloat16``) when given, else as the raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Reference param tree (nested dicts of numpy arrays) -> port params."""
    dev = torch.device(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        host = len(path) >= 2 and path[-2] == "moe" \
            and path[-1] in EXPERT_TABLES
        if host:
            return tensor_from_numpy(np.asarray(node), "cpu",
                                     pin=dev.type == "cuda")
        return tensor_from_numpy(np.asarray(node), dev)
    return walk(tree, ())


def params_to_numpy(params: Dict[str, Any], bf16_dtype=None
                    ) -> Dict[str, Any]:
    """Port params -> nested dicts of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in params.items()}
    return tensor_to_numpy(params, bf16_dtype)
