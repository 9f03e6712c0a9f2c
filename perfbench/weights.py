"""The benchmark's own seeded weights, laid out in the parameter tree that
``repro_torch`` serves (``params["scan"]["s0"]`` with a leading [L] axis on
every layer leaf).

Drawn on the device with one ``torch.Generator`` seeded by ``--seed``, one
call a leaf (a layer a call for the expert tables), in the type they are
served in: bf16 matrices scaled by 1 / sqrt(fan_in), fp32 router, fp32
norm weights 1 + 0.05 * N(0, 1). The expert tables go to pinned host
memory (the engine's host tier); every other leaf stays on the device.
The same tensors go to the program and to the plain reference.

On a card the host tier is page-locked at its exact size by the CUDA
runtime's ``cudaHostAlloc`` (the library the process already loaded):
``pin_memory=True`` would round each table up to a power of two of bytes,
and the three 22.5 GB tables of 24 Mixtral layers would take 103 GB.
A run gives them back (``release``) once its check has read them: left
to the process's end, the 67.6 GB of 24 Mixtral layers took 13-20 s to
tear down on the card's host, against 2.3 s for ``cudaFreeHost``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]
EXPERT_LEAVES = ("w1", "w3", "w2")


@dataclass(frozen=True)
class Shapes:
    L: int
    D: int
    H: int
    Hk: int
    hd: int
    E: int
    K: int
    F: int
    V: int

    @staticmethod
    def of(cfg: Dict) -> "Shapes":
        D, H = cfg["hidden_size"], cfg["num_attention_heads"]
        return Shapes(L=cfg["num_hidden_layers"], D=D, H=H,
                      Hk=cfg["num_key_value_heads"],
                      hd=cfg.get("head_dim") or D // H,
                      E=cfg["num_local_experts"],
                      K=cfg["num_experts_per_tok"],
                      F=cfg["intermediate_size"], V=cfg["vocab_size"])

    def expert_shape(self, leaf: str):
        return ((self.E, self.F, self.D) if leaf == "w2"
                else (self.E, self.D, self.F))


def _normal(shape, fan_in: int, g: torch.Generator, dev,
            dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    return w.mul_(1.0 / math.sqrt(fan_in))


def _norm(shape, g: torch.Generator, dev) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=dev).mul_(0.05).add_(1.0)


CUDART = ("libcudart.so.12", "/usr/local/cuda/lib64/libcudart.so.12")
HOST_ALLOC_PORTABLE = 1
_LOCKED = set()          # addresses ``_page_locked`` allocated, not yet freed


def _cudart():
    """The CUDA runtime: the one the process loaded, by its soname, else
    the toolkit's."""
    for name in CUDART:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError(f"no CUDA runtime library found ({CUDART})")


def _page_locked(shape, dtype) -> torch.Tensor:
    """An empty host tensor of exactly its size, page-locked for the card."""
    torch.cuda.init()
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    rt = _cudart()
    ptr = ctypes.c_void_p()
    err = rt.cudaHostAlloc(ctypes.byref(ptr), ctypes.c_size_t(n),
                           ctypes.c_uint(HOST_ALLOC_PORTABLE))
    if err != 0 or not ptr.value:
        raise RuntimeError(f"cudaHostAlloc of {n} bytes failed ({err})")
    buf = (ctypes.c_char * n).from_address(ptr.value)
    t = torch.frombuffer(buf, dtype=dtype).view(shape)
    if not t.is_pinned():
        raise RuntimeError("the host tier is not page-locked")
    _LOCKED.add(ptr.value)
    return t


def release(tables: Dict[str, torch.Tensor]) -> None:
    """Free the tables that ``_page_locked`` made (``cudaFreeHost``), once
    nothing reads them again; any other table is left alone."""
    mine = [t.data_ptr() for t in tables.values() if t.data_ptr() in _LOCKED]
    if not mine:
        return
    torch.cuda.synchronize()
    rt = _cudart()
    for p in mine:
        err = rt.cudaFreeHost(ctypes.c_void_p(p))
        if err != 0:
            raise RuntimeError(f"cudaFreeHost failed ({err})")
        _LOCKED.discard(p)


def host_tier(s: Shapes, pinned: bool) -> Dict[str, torch.Tensor]:
    """Empty expert tables [L, E, D, F] / [L, E, F, D] in host memory,
    page-locked at their exact size where ``pinned``."""
    shape = {leaf: (s.L,) + s.expert_shape(leaf) for leaf in EXPERT_LEAVES}
    if pinned:
        return {k: _page_locked(v, torch.bfloat16) for k, v in shape.items()}
    return {k: torch.empty(v, dtype=torch.bfloat16)
            for k, v in shape.items()}


def draw(cfg: Dict, seed: int, device,
         host: Optional[Dict[str, torch.Tensor]] = None) -> Params:
    """Every weight of ``cfg`` from ``seed``. ``host``: expert tables to
    fill in place (reused across seeds); made (pinned on a GPU) if None."""
    s = Shapes.of(cfg)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    if host is None:
        host = host_tier(s, pinned=dev.type == "cuda")
    D, L = s.D, s.L
    params: Params = {"embed": _normal((s.V, D), D, g, dev),
                      "lm_head": _normal((s.V, D), D, g, dev),
                      "final_norm": _norm((D,), g, dev)}
    attn = {"wq": _normal((L, D, s.H * s.hd), D, g, dev),
            "wk": _normal((L, D, s.Hk * s.hd), D, g, dev),
            "wv": _normal((L, D, s.Hk * s.hd), D, g, dev),
            "wo": _normal((L, s.H * s.hd, D), s.H * s.hd, g, dev)}
    moe: Params = {"router": _normal((L, D, s.E), D, g, dev, torch.float32)}
    for leaf in EXPERT_LEAVES:
        fan_in = s.F if leaf == "w2" else D
        for l in range(L):
            host[leaf][l].copy_(_normal(s.expert_shape(leaf), fan_in, g,
                                        dev))
        moe[leaf] = host[leaf]
    params["scan"] = {"s0": {"ln1": _norm((L, D), g, dev), "attn": attn,
                             "ln2": _norm((L, D), g, dev), "moe": moe}}
    return params
