"""GQA attention: chunked-flash prefill forward and dense cached decode
(counterpart of the reference's ``models/attention.py``).

Both are plain tensor code here, as they are XLA (not Pallas) in the
reference: matmul/einsum and softmax in fp32, never a fused attention
operator. Layouts follow the reference: q [B, S, H, hd], k/v
[B, S, Hk, hd], GQA group = H // Hk.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .layers import apply_rope, mm

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def _project_qkv(p: Params, x: torch.Tensor, cfg):
    B, S, _ = x.shape
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _rope_qk(q, k, positions, cfg):
    if cfg.mrope:
        raise NotImplementedError("multimodal RoPE is not ported")
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _mask_for(Sq: int, chunk: int, c_start: int, window: int,
              device) -> torch.Tensor:
    q_pos = torch.arange(Sq, device=device)
    k_pos = c_start + torch.arange(chunk, device=device)
    dist = q_pos[:, None] - k_pos[None, :]                   # [Sq, chunk]
    mask = dist >= 0
    if window > 0:
        mask &= dist < window
    return mask


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int = -1, chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks (the reference's
    ``_flash_fwd_scan``, forward only). Returns [B, Sq, H, hd] in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    group = H // Hk
    chunk = min(chunk, Sk)
    if Sk % chunk:
        raise ValueError(f"key length {Sk} not a multiple of chunk {chunk}")
    qf = q.float() * hd ** -0.5
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, chunk):
        krep = k[:, c0:c0 + chunk].repeat_interleave(group, dim=2).float()
        vrep = v[:, c0:c0 + chunk].repeat_interleave(group, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bqhk", qf, krep)
        mask = _mask_for(Sq, chunk, c0, window, q.device)
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p,
                                                    vrep)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype)


def self_attention(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg,
                   window: int = -1) -> torch.Tensor:
    """Full-sequence causal self attention (prefill)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    o = flash_forward(q, k, v, window=window)
    return mm(o.reshape(B, S, cfg.num_heads * cfg.head_dim), p["wo"])


def init_kv_cache(batch: int, capacity: int, num_kv_heads: int,
                  head_dim: int, device=None,
                  dtype=torch.bfloat16) -> Params:
    shape = (batch, capacity, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, cfg, window: int = -1
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token attention against a cache of static capacity.

    x: [B, 1, D]; cache k/v: [B, S, Hk, hd]; pos: [B] (or scalar) count of
    valid cached tokens per row; the new token has position ``pos`` and is
    written into slot ``min(pos, S-1)``. Unlike the reference, the write
    goes IN PLACE into ``cache`` (which is also returned).
    Returns (output [B, 1, D], cache)."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    Hk, hd = cfg.num_kv_heads, cfg.head_dim
    group = cfg.num_heads // Hk
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).expand(B)
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q, k_new = _rope_qk(q, k_new, pos_b[:, None], cfg)

    slot = torch.clamp(pos_b, max=S - 1)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k_new[:, 0]
    cache["v"][rows, slot] = v_new[:, 0]

    qg = q.reshape(B, 1, Hk, group, hd).float() * hd ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgk", qg, cache["k"].float())
    j = torch.arange(S, device=x.device)
    valid = j[None, :] <= slot[:, None]                      # [B, S]
    if window > 0:
        valid &= (pos_b[:, None] - j[None, :]) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, cache["v"].float())
    o = o.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    return mm(o, p["wo"]), cache
