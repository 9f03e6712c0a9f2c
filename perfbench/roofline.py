"""Frozen yardstick: the card's published peaks and the work counts the
per-layer metrics divide by. Kept here, apart from the program, so that a
change to the program cannot move what it is measured against.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data
sheet; dense rates, no sparsity, at the full 700 W):
- bf16 tensor cores: 989 TFLOP/s;
- HBM3: 3.35 TB/s;
- host link: PCIe 5.0 x16, 128 GB/s both ways together, 64 GB/s each way
  (the data sheet's "PCIe Gen5: 128 GB/s"; PCI-SIG's 32 GT/s a lane).

The kernel counts are the same arithmetic as the on-card smoke's
``bound()`` and its ``swiglu_work`` / ``gmm_work``: each input byte read
once, each output byte written once, the operations of the product; the
bound is the larger of bytes over HBM and operations over the bf16 peak.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
PCIE_H2D_BYTES_PER_S = 64e9


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """Least time for the work (s) and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def swiglu_work(G: int, C: int, K: int, N: int, itemsize: int = 2
                ) -> Tuple[int, int]:
    """silu(x @ w1) * (x @ w3): x [G, C, K], w1/w3 [G, K, N], out
    [G, C, N]. (bytes, operations)."""
    nbytes = (G * C * K + 2 * G * K * N + G * C * N) * itemsize
    return nbytes, 4 * G * C * K * N


def gmm_work(G: int, C: int, K: int, N: int, itemsize: int = 2
             ) -> Tuple[int, int]:
    """x [G, C, K] @ w [G, K, N] -> [G, C, N]. (bytes, operations)."""
    nbytes = (G * C * K + G * K * N + G * C * N) * itemsize
    return nbytes, 2 * G * C * K * N


WORK = {"swiglu_gmm": swiglu_work, "gmm": gmm_work}


def active_params_per_token(cfg: Dict) -> int:
    """Parameters one decode token multiplies by, from a configuration
    file's published keys: every layer's q/k/v/o projections, its router
    and its top-k experts' three matrices, then the LM head (the embedding
    is a lookup, no product)."""
    D = cfg["hidden_size"]
    H, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    F = cfg["intermediate_size"]
    per_layer = D * hd * (H + 2 * Hk) + H * hd * D + D * E + K * 3 * D * F
    return cfg["num_hidden_layers"] * per_layer + cfg["vocab_size"] * D


def decode_flops(cfg: Dict, keys_seen: Iterable[int]) -> float:
    """Model FLOPs of decode tokens: 2 per active parameter, plus each
    layer's attention over the keys the token saw (q.k and p.v: 4 * H *
    hd a key)."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or D // H
    per_key = 4 * H * hd * cfg["num_hidden_layers"]
    keys = list(keys_seen)
    return 2.0 * active_params_per_token(cfg) * len(keys) + \
        float(per_key) * sum(keys)
