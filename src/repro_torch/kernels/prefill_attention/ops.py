"""Chunked-prefill attention over the paged KV pool: the wrapper over the
Hopper kernel and its plain PyTorch version.

``paged_flash_prefill`` replaces the JAX package's Pallas TPU kernel
(``src/repro/kernels/prefill_attention/paged.py::paged_flash_prefill`` /
``_prefill_kernel``) with the hand-written CUDA kernel in
``csrc/prefill_attention.cu``; that file's header gives its bound and what
the design does about it: both products on the tensor cores, the key axis
split across blocks (:func:`prefill_splits`) and the fp32 partials
combined in split order. :func:`paged_flash_prefill_split_plain` is that
algorithm, with its rounding points, in plain PyTorch for the tests. The
wrapper contract is the reference's (``prefill_attention/ops.py``):
``pos0`` is a scalar or a ``[B]`` vector, and CSR tables sized for another
batch raise ``ValueError``.

The plain version is the online-softmax scan over key chunks that the
port's prefill attention runs (:func:`flash_scan`, which
:func:`repro_torch.models.attention.flash_forward` calls), so on the CPU
a paged segment and the dense one-shot prefill agree bit for bit.

The wrapper runs the plain version only for tensors that lie on the CPU.
For a CUDA tensor it launches the kernel or raises: it never falls back. On
every device it refuses an input that requires grad
(:func:`repro_torch.kernels.guard.refuse_autograd`).
It counts its launches in ``paged_flash_prefill.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import (
    KEY_TILE, NEG_INF, SMS, check_cuda, check_tables, combine_splits,
    paged_gather, pos_vector, ptr_of, raise_on, sm_count, split_workspace,
    stream_of)
from repro_torch.kernels.guard import refuse_autograd

SOURCE = Path(__file__).resolve().parent / "csrc" / "prefill_attention.cu"

ROW_TILE = 128                       # query rows a block (8 warps of 16)
BLOCKS_PER_SM = 1                    # prefill blocks an SM runs


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_flash_prefill_bf16.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                             i, i, i, i, i, i, i, i, i, f, i,
                                             i, p]
    lib.paged_flash_prefill_bf16.restype = i
    return lib


# -- plain versions ------------------------------------------------------------

def chunk_mask(Sq: int, chunk: int, c_start: int, window: int, q_offset,
          kv_last, device, causal: bool = True) -> torch.Tensor:
    """Visible keys of one chunk, [b, Sq, chunk] (b = 1 when q_offset and
    kv_last are scalars or absent). Without ``causal`` a row sees every key
    up to kv_last (and inside the window, as the reference's
    ``_mask_for`` has it)."""
    q_pos = torch.as_tensor(q_offset, device=device).reshape(-1, 1) \
        + torch.arange(Sq, device=device)                    # [b, Sq]
    k_pos = c_start + torch.arange(chunk, device=device)
    dist = q_pos[:, :, None] - k_pos                          # [b, Sq, chunk]
    mask = dist >= 0 if causal else torch.ones_like(dist, dtype=torch.bool)
    if window > 0:
        mask &= dist < window
    if kv_last is not None:
        mask &= k_pos <= kv_last.reshape(-1, 1, 1)
    return mask


def flash_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int = -1, q_offset=0,
               kv_last: Optional[torch.Tensor] = None,
               chunk: int = 1024, causal: bool = True,
               with_lse: bool = False):
    """Online-softmax attention over key chunks (the reference's
    ``models/attention.py::_flash_fwd_scan``): fp32 scores of
    the hd^-0.5-scaled q, a running (m, l, acc) per query row, one rounding
    at the end. q [B, Sq, H, hd], query row i at position q_offset + i
    (q_offset scalar or [B]); k/v [B, Sk, Hk, hd]; kv_last [B] (optional):
    keys past a row's last valid key are masked too. ``causal=False`` (an
    encoder's self-attention, cross-attention) lets every row see every
    key the window and kv_last leave. Past ``chunk`` keys, the keys come in
    whole chunks, as the reference asserts. Returns [B, Sq, H, hd] in q's
    dtype; ``with_lse`` also the rows' fp32 log-sum-exp [B, Sq, H], which
    the flash backward (:class:`repro_torch.models.attention.FlashAttention`)
    recomputes the probabilities from."""
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
        mask = chunk_mask(Sq, chunk, c0, window, q_offset, kv_last, q.device,
                     causal)
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p,
                                                    vrep)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if with_lse else out


def paged_flash_prefill_plain(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              page_indptr: torch.Tensor,
                              page_indices: torch.Tensor,
                              last_page_len: torch.Tensor, pos0,
                              max_pages: int,
                              window: int = -1) -> torch.Tensor:
    """The rows' pages gathered into a dense view, then :func:`flash_scan`
    with the segment at ``pos0`` and each row's keys cut at its last
    valid key ``(n_pages-1)*page_size + last_page_len - 1``."""
    k, v, last = paged_gather(k_pages, v_pages, page_indptr, page_indices,
                              last_page_len, max_pages)
    pos0 = pos_vector(pos0, q.shape[0], q.device, "pos0")
    return flash_scan(q, k, v, window, pos0, last)


def prefill_splits(B: int, C: int, H: int, Hk: int, S: int,
                   sms: int = SMS):
    """(splits, split_len) of ``paged_flash_prefill``'s key axis over S =
    max_pages * page_size keys, from the shapes alone: as many splits as
    put ``BLOCKS_PER_SM`` blocks of 128 query rows on every SM in one wave,
    each at least 4 64-key tiles, none empty; a short row gets one split."""
    blocks = B * Hk * -(-C * (H // Hk) // ROW_TILE)
    tiles = max(1, -(-S // KEY_TILE))
    n = max(1, min(tiles // 4, BLOCKS_PER_SM * sms // blocks))
    per = -(-tiles // n)
    return -(-tiles // per), per * KEY_TILE


def paged_flash_prefill_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor,
                                    page_indptr: torch.Tensor,
                                    page_indices: torch.Tensor,
                                    last_page_len: torch.Tensor, pos0,
                                    max_pages: int, window: int = -1,
                                    splits=None) -> torch.Tensor:
    """``paged_flash_prefill``'s kernel algorithm in plain PyTorch, with its
    rounding points, for the tests (the serving path never calls it). The
    key axis in splits (``prefill_splits`` unless given as ``(splits,
    split_len)``), each walked in 64-key tiles with an online softmax:
    scores are the fp32 sums of the bf16 products, then scaled by hd^-0.5
    (the reference scales q first); P is rounded to bf16 before PV, l sums
    the fp32 P. Each split yields (m, l, acc) (m = -1e30, l = 0, acc = 0
    where it sees no key); the combine weighs them by exp(m_s - max m) in
    split order and rounds once."""
    B, C, H, hd = q.shape
    k, v, last = paged_gather(k_pages, v_pages, page_indptr, page_indices,
                              last_page_len, max_pages)
    S, Hk = k.shape[1], k.shape[2]
    group = H // Hk
    n, ln = splits or prefill_splits(B, C, H, Hk, S)
    pos0 = pos_vector(pos0, B, q.device, "pos0").long()
    qg = q.reshape(B, C, Hk, group, hd).float()
    j = torch.arange(S, device=q.device)
    qpos = pos0[:, None] + torch.arange(C, device=q.device)    # [B, C]
    valid = (j <= qpos[..., None]) & (j <= last[:, None, None])
    if window > 0:
        valid &= (qpos[..., None] - j) < window                # [B, C, S]
    valid = valid[:, :, None, None, :]                      # [B, C, 1, 1, S]
    ms, ls, accs = [], [], []
    for sp in range(n):
        m = torch.full((B, C, Hk, group), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, C, Hk, group, hd), device=q.device)
        for t0 in range(sp * ln, min(S, (sp + 1) * ln), KEY_TILE):
            kt = slice(t0, min(S, t0 + KEY_TILE))
            s = torch.einsum("bchgd,bkhd->bchgk", qg, k[:, kt].float()) \
                * hd ** -0.5
            seen = valid[..., kt]
            s = torch.where(seen, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(seen, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bchgk,bkhd->bchgd", p.to(torch.bfloat16).float(),
                v[:, kt].float())
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    o = combine_splits(ms, ls, accs)
    return o.reshape(B, C, H, hd).to(q.dtype)


# -- wrapper -------------------------------------------------------------------

def paged_flash_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_indptr: torch.Tensor,
                        page_indices: torch.Tensor,
                        last_page_len: torch.Tensor, pos0, max_pages: int,
                        window: int = -1) -> torch.Tensor:
    """q [B, C, H, hd]: one C-token segment per row, row b's first query at
    absolute position ``pos0[b]`` (a scalar broadcasts); k_pages/v_pages
    [num_pages, page_size, Hk, hd] with the segment's own KV written;
    page_indptr [B+1] / page_indices / last_page_len [B]: CSR page tables
    (every row >= 1 page, at most ``max_pages``; ``last_page_len`` may be
    <= 0 as long as each query row sees a key). -> [B, C, H, hd]."""
    refuse_autograd("paged_flash_prefill", q, k_pages, v_pages)
    B, C, H, hd = q.shape
    pos0 = pos_vector(pos0, B, q.device, "pos0")
    check_tables(B, page_indptr, last_page_len)
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k_pages, v_pages, page_indptr,
                                         page_indices, last_page_len, pos0,
                                         max_pages, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_prefill: unsupported device "
                         f"{q.device}")
    N, ps, Hk = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != hd or H % Hk:
        raise ValueError(f"paged_flash_prefill: q {tuple(q.shape)} does not "
                         f"match the pool {tuple(k_pages.shape)}")
    tables = [t.to(torch.int32).contiguous()
              for t in (page_indptr, page_indices, last_page_len)]
    check_cuda("paged_flash_prefill", (q, k_pages, v_pages), tables + [pos0])
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, split_len = prefill_splits(B, C, H, Hk, max_pages * ps,
                                       sm_count(q))
    ws_acc, ws_ml = split_workspace((B, C, H), hd, splits, q.device)
    err = _lib().paged_flash_prefill_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() for t in tables), pos0.data_ptr(), out.data_ptr(),
        ptr_of(ws_acc), ptr_of(ws_ml), B, C, N, ps, int(max_pages), H, Hk,
        hd, int(window), hd ** -0.5, splits, split_len, stream_of(q))
    raise_on(err, "paged_flash_prefill")
    paged_flash_prefill.launches += 1
    return out


paged_flash_prefill.launches = 0
