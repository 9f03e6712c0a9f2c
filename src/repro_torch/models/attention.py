"""GQA attention: chunked-flash prefill, segment-streamed prefill and
cached decode, over a dense cache or the paged KV pool, and the
encoder-decoder's cross-attention (counterpart of the reference's
``models/attention.py``).

Prefill, train and dense segments are plain tensor code, as they are XLA
in the reference: matmul/einsum and softmax in fp32, never a fused
attention operator. Full-sequence attention (prefill, train, the
encoder's and a prompt's cross-attention) is :func:`flash_attention`, the
reference's custom-VJP flash scan as a ``torch.autograd.Function``: its
backward recomputes each chunk's scores from the saved log-sum-exp, so no
[Sq, Sk] matrix is ever kept for the gradient. Decode is scored by the
flash-decode kernels (dense and paged; a decode step's cross-attention
too) and a paged segment by the paged-prefill kernel
(:mod:`repro_torch.kernels`); on the CPU each wrapper runs its plain
version. Under ``cfg.mrope`` q and k turn by multimodal RoPE, positions
``[3, B, S]``. Layouts follow the reference: q [B, S, H, hd], k/v
[B, S, Hk, hd], pool [num_pages, page_size, Hk, hd], GQA group = H // Hk.
Unlike the reference, caches and pools are written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention import (flash_decode,
                                                  paged_flash_decode)
from repro_torch.kernels.prefill_attention import (flash_scan,
                                                   paged_flash_prefill)
from repro_torch.kernels.prefill_attention.ops import NEG_INF, chunk_mask
from .layers import apply_mrope, apply_rope, mm

Params = Dict[str, torch.Tensor]


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
    """q and k roped: positions [3, B, S] under ``cfg.mrope``, else
    broadcastable to [B, S]."""
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta),
                apply_mrope(k, positions, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg):
    """The one projection + rope of a layer's input: (q, k, v), k roped."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    return q, k, v


def _out(p: Params, o: torch.Tensor, cfg) -> torch.Tensor:
    B, S = o.shape[:2]
    return mm(o.reshape(B, S, cfg.num_heads * cfg.head_dim), p["wo"])


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int = -1, chunk: int = 1024,
                  q_offset=0, causal: bool = True) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's
    ``_flash_fwd_scan``, forward only): query row i sits at absolute
    position ``q_offset + i`` (an int or a [B] tensor); ``causal=False``
    unmasks every key. Returns [B, Sq, H, hd] in q's dtype."""
    return flash_scan(q, k, v, window, q_offset, None, chunk, causal)


class FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP
    (``models/attention.py:95-206``). Forward: the flash scan
    (:func:`flash_scan`), saving (q, k, v, out, lse). Backward
    (``_flash_bwd``): per key chunk, the fp32 scores again, ``p = exp(s -
    lse)``, ``delta = rowsum(dO * O)``, ``ds = p * (dp - delta)``; dq
    accumulates over chunks in fp32, and each chunk's dk / dv sum the GQA
    group's query heads back onto their kv head. Gradients round once to
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool, chunk: int):
        out, lse = flash_scan(q, k, v, window, 0, None, chunk, causal,
                              with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal, ctx.chunk = window, causal, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, Sq, H, hd = q.shape
        Sk, Hk = k.shape[1], k.shape[2]
        group = H // Hk
        chunk = min(ctx.chunk, Sk)
        scale = hd ** -0.5
        qf = q.float() * scale
        do = dout.float()
        delta = (do * out.float()).sum(dim=-1)               # [B, Sq, H]
        dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32,
                         device=q.device)
        dks, dvs = [], []
        for c0 in range(0, Sk, chunk):
            krep = k[:, c0:c0 + chunk].repeat_interleave(group, dim=2).float()
            vrep = v[:, c0:c0 + chunk].repeat_interleave(group, dim=2).float()
            s = torch.einsum("bqhd,bkhd->bqhk", qf, krep)
            mask = chunk_mask(Sq, chunk, c0, ctx.window, 0, None, q.device,
                         ctx.causal)
            s = torch.where(mask[:, :, None, :], s, NEG_INF)
            p = torch.exp(s - lse[..., None])                  # [B,Sq,H,ck]
            dv_rep = torch.einsum("bqhk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bqhk", do, vrep)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bqhk,bkhd->bqhd", ds, krep) * scale
            dk_rep = torch.einsum("bqhk,bqhd->bkhd", ds, qf)
            dks.append(dk_rep.reshape(B, chunk, Hk, group, hd).sum(dim=3))
            dvs.append(dv_rep.reshape(B, chunk, Hk, group, hd).sum(dim=3))
        return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
                torch.cat(dvs, dim=1).to(v.dtype), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = -1, causal: bool = True,
                    chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention of q [B, Sq, H, hd] over k/v
    [B, Sk, Hk, hd], query row i at position i, differentiable through
    :class:`FlashAttention`. Returns [B, Sq, H, hd] in q's dtype."""
    return FlashAttention.apply(q, k, v, int(window), bool(causal),
                                int(chunk))


def prefill_attention(p: Params, x: torch.Tensor, positions: torch.Tensor,
                      cfg, window: int = -1, causal: bool = True):
    """Full-sequence self attention (prefill and train; an encoder's with
    ``causal=False``), projecting once: returns (output [B, S, D], roped k,
    v [B, S, Hk, hd]) so a prefill keeps the same K/V for the cache."""
    q, k, v = _qkv(p, x, positions, cfg)
    o = flash_attention(q, k, v, window=window, causal=causal)
    return _out(p, o, cfg), k, v


# -- segment-streamed prefill (q_len == C prompt tokens at offset pos) --------

def segment_attention(p: Params, x: torch.Tensor, cache: Params, pos,
                      positions: torch.Tensor, cfg, window: int = -1
                      ) -> Tuple[torch.Tensor, Params]:
    """Prompt-segment attention against a request's dense KV cache.

    x: [B, C, D], one C-token segment whose first token sits at absolute
    position ``pos`` (an int); cache k/v: [B, S, Hk, hd]. The segment's
    K/V lands in slots ``pos..pos+C-1`` (rows past capacity drop), IN
    PLACE, then the queries run the same flash scan as the one-shot
    prefill over the whole capacity axis with the causal mask offset by
    ``pos``: flash rows are independent, so a row's output equals the
    one-shot forward's row. Returns (output [B, C, D], cache)."""
    C = x.shape[1]
    S = cache["k"].shape[1]
    pos = int(pos)
    q, k_new, v_new = _qkv(p, x, positions, cfg)
    n = max(0, min(C, S - pos))
    cache["k"][:, pos:pos + n] = k_new[:, :n]
    cache["v"][:, pos:pos + n] = v_new[:, :n]
    o = flash_forward(q, cache["k"], cache["v"], window=window, q_offset=pos)
    return _out(p, o, cfg), cache


def segment_attention_paged(p: Params, x: torch.Tensor, cache: Params, pos,
                            positions: torch.Tensor, pages: torch.Tensor, cfg,
                            window: int = -1, write_min=None, write_max=None
                            ) -> Tuple[torch.Tensor, Params]:
    """Prompt-segment attention against the global paged KV pool.

    x: [B, C, D]; cache k/v: [num_pages, page_size, Hk, hd]; pages
    [B, max_pages] page table on the device (entries past a row's pages
    padded with num_pages); pos: the segment's first absolute position
    (an int). K/V rows land, IN PLACE, through the page table only where
    ``write_min <= idx < write_max`` (and idx < max_pages*page_size):
    shared prefix pages and pad rows past the prompt are never written.

    With ``write_max`` given, scoring goes through the paged-prefill
    kernel on full-width CSR rows (every row max_pages pages, pad ids
    mapped to page 0, ``last_page_len = write_max - (max_pages-1) *
    page_size``, which may be <= 0), as the reference does: the kernel
    reads the pool through the page table and gathers nothing. Without
    it, the rows' pages are gathered into a dense view and the flash scan
    runs over it. Returns (output [B, C, D], pool)."""
    B, C = x.shape[:2]
    N, ps = cache["k"].shape[0], cache["k"].shape[1]
    max_pages = pages.shape[1]
    S = max_pages * ps
    Hk, hd = cfg.num_kv_heads, cfg.head_dim
    pos = int(pos)
    q, k_new, v_new = _qkv(p, x, positions, cfg)

    idx = pos + np.arange(C)
    ok = idx < S
    if write_min is not None:
        ok &= idx >= int(write_min)
    if write_max is not None:
        ok &= idx < int(write_max)
    rows = np.nonzero(ok)[0]
    if rows.size:
        slot = torch.from_numpy(idx[rows]).to(pages.device)
        page = pages[:, slot // ps]                              # [B, n]
        off = (slot % ps).to(cache["k"].device)
        rsel = torch.from_numpy(rows).to(x.device)
        cache["k"][page, off] = k_new[:, rsel]
        cache["v"][page, off] = v_new[:, rsel]

    real = torch.where(pages < N, pages, torch.zeros_like(pages))
    if write_max is not None:
        dev = q.device
        indptr = torch.arange(B + 1, dtype=torch.int32,
                              device=dev) * max_pages
        lastlen = torch.full((B,), int(write_max) - (max_pages - 1) * ps,
                             dtype=torch.int32, device=dev)
        pos0 = torch.full((B,), pos, dtype=torch.int32, device=dev)
        o = paged_flash_prefill(q.contiguous(), cache["k"], cache["v"],
                                indptr, real.reshape(-1).to(torch.int32),
                                lastlen, pos0, max_pages, window)
    else:
        k_cache = cache["k"][real].reshape(B, S, Hk, hd)
        v_cache = cache["v"][real].reshape(B, S, Hk, hd)
        o = flash_forward(q, k_cache, v_cache, window=window, q_offset=pos)
    return _out(p, o, cfg), cache


# -- cached decode (q_len == 1) ------------------------------------------------

def init_kv_cache(batch: int, capacity: int, num_kv_heads: int,
                  head_dim: int, device=None,
                  dtype=torch.bfloat16) -> Params:
    shape = (batch, capacity, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(num_pages: int, page_size: int, num_kv_heads: int,
                        head_dim: int, device=None,
                        dtype=torch.bfloat16) -> Params:
    """Global paged KV pool: pages replace the per-row capacity axis."""
    return init_kv_cache(num_pages, page_size, num_kv_heads, head_dim,
                         device, dtype)


def _decode_qkv(p: Params, x: torch.Tensor, pos, S: int, cfg, window: int):
    """The new token's q (as [B, H, hd]), k, v and its position [B] and
    cache slot ``min(pos, S-1)`` [B]. The kernels mask causality and the
    window with one position, the slot: beyond capacity the two differ,
    so a windowed layer refuses it (the engine never gets there). Under
    M-RoPE all three streams take ``pos``, as the reference's decode does,
    whatever grid positions the prefill used."""
    B = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).expand(B)
    posq = pos_b[None, :, None].expand(3, B, 1) if cfg.mrope \
        else pos_b[:, None]
    q, k_new, v_new = _qkv(p, x, posq, cfg)
    slot = torch.clamp(pos_b, max=S - 1)
    if window > 0 and bool((pos_b > S - 1).any()):
        raise ValueError(f"decode past the KV capacity {S} with a sliding "
                         f"window of {window}")
    return q[:, 0].contiguous(), k_new[:, 0], v_new[:, 0], slot


def decode_attention(p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, cfg, window: int = -1
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token attention against a cache of static capacity, scored by
    the flash-decode kernel (its plain version on the CPU).

    x: [B, 1, D]; cache k/v: [B, S, Hk, hd]; pos: [B] (or scalar) count of
    valid cached tokens per row; the new token has position ``pos`` and is
    written into slot ``min(pos, S-1)``. Unlike the reference, the write
    goes IN PLACE into ``cache`` (which is also returned).
    Returns (output [B, 1, D], cache)."""
    B = x.shape[0]
    q, k_new, v_new, slot = _decode_qkv(p, x, pos, cache["k"].shape[1],
                                        cfg, window)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k_new
    cache["v"][rows, slot] = v_new
    o = flash_decode(q, cache["k"], cache["v"], slot, window)
    return _out(p, o[:, None], cfg), cache


def decode_attention_paged(p: Params, x: torch.Tensor, cache: Params,
                           pos: torch.Tensor, pages: torch.Tensor, cfg,
                           window: int = -1,
                           active: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Params]:
    """One-token attention against the global paged KV pool, scored by
    the paged flash-decode kernel (its plain version on the CPU).

    x: [B, 1, D]; cache k/v: [num_pages, page_size, Hk, hd], the pool
    every request shares; pages: [B, max_pages] on the device, each row's
    page table padded with num_pages; pos: scalar or [B] valid-token
    counts; active: [B] bool on the host. An inactive row's write is
    DROPPED (its page-table row may alias pages live requests own); its
    output is computed and meaningless. The write goes IN PLACE.

    The kernel takes full-width CSR rows (every row max_pages pages, pad
    ids mapped to page 0, ``last_page_len = slot - (max_pages-1) *
    page_size + 1``, which may be <= 0) and reads only the pages up to
    each row's slot. On the CPU the plain version gathers the same dense
    ``[B, max_pages*page_size, Hk, hd]`` view the dense path scores, so
    for ``capacity = max_pages * page_size`` an active row's output is
    bitwise the dense path's. Returns (output [B, 1, D], pool)."""
    B = x.shape[0]
    N, ps = cache["k"].shape[0], cache["k"].shape[1]
    max_pages = pages.shape[1]
    q, k_new, v_new, slot = _decode_qkv(p, x, pos, max_pages * ps, cfg,
                                        window)
    if active is None:
        rows = torch.arange(B, device=x.device)
    else:
        rows = torch.from_numpy(np.nonzero(
            np.asarray(torch.as_tensor(active, device="cpu"), bool))[0]
        ).to(x.device)
    if rows.numel():
        s = slot[rows]
        page = pages[rows, s // ps]
        cache["k"][page, s % ps] = k_new[rows]
        cache["v"][page, s % ps] = v_new[rows]

    dev = q.device
    indptr = torch.arange(B + 1, dtype=torch.int32, device=dev) * max_pages
    real = torch.where(pages < N, pages, torch.zeros_like(pages))
    lastlen = (slot - (max_pages - 1) * ps + 1).to(torch.int32)
    o = paged_flash_decode(q, cache["k"], cache["v"], indptr,
                           real.reshape(-1).to(torch.int32), lastlen,
                           max_pages, window)
    return _out(p, o[:, None], cfg), cache


# -- cross-attention (encoder-decoder) -----------------------------------------

def encode_memory_kv(p: Params, memory: torch.Tensor, num_kv_heads: int,
                     head_dim: int) -> Params:
    """Cross-attention K/V from the encoder's output [B, Sm, D], computed
    once a prefill (no RoPE): {"k", "v"} [B, Sm, Hk, hd]."""
    B, Sm, _ = memory.shape
    return {"k": mm(memory, p["wk"]).reshape(B, Sm, num_kv_heads, head_dim),
            "v": mm(memory, p["wv"]).reshape(B, Sm, num_kv_heads, head_dim)}


def cross_attention(p: Params, x: torch.Tensor,
                    memory_kv: Params) -> torch.Tensor:
    """x [B, Sq, D] attends to every key of the encoder memory's K/V
    ``memory_kv`` [B, Sm, Hk, hd] (no RoPE on either side). A prompt's rows
    run the flash scan with ``causal=False``; one query row (a decode step)
    is scored by the flash-decode kernel with its query at the last memory
    key, Sm - 1, so every key is visible: the reference's unmasked scan
    for that row. Returns [B, Sq, D]. A prompt's (and train's) rows go
    through :func:`flash_attention`, so the memory K/V take gradients."""
    B, Sq, _ = x.shape
    k, v = memory_kv["k"], memory_kv["v"]
    hd = k.shape[3]
    H = p["wq"].shape[1] // hd
    q = mm(x, p["wq"]).reshape(B, Sq, H, hd)
    if Sq == 1:
        last = torch.full((B,), k.shape[1] - 1, dtype=torch.int32,
                          device=x.device)
        o = flash_decode(q[:, 0].contiguous(), k, v, last)[:, None]
    else:
        o = flash_attention(q, k, v, causal=False)
    return mm(o.reshape(B, Sq, H * hd), p["wo"])
