"""Flash-decode attention, dense and paged: wrappers over the Hopper kernels
and their plain PyTorch versions.

``flash_decode`` and ``paged_flash_decode`` replace the JAX package's
Pallas TPU kernels (``src/repro/kernels/decode_attention/``:
``decode_attention.py::flash_decode`` / ``_decode_kernel`` and
``paged.py::paged_flash_decode`` / ``_paged_kernel``) with one hand-written
CUDA kernel in ``csrc/decode_attention.cu``, fed from the dense cache or,
through the page table, from the paged pool; that file's header gives its
bound (bytes: K and V read once up to each row's position) and what the
design does about it. Both wrappers split the key axis across blocks
(:func:`decode_splits` picks the splits from the shapes and the card's SM
count); with more than one split a second kernel combines the fp32
partials in split order (:func:`flash_decode_split_plain` and
:func:`paged_flash_decode_split_plain` are that algorithm in plain
PyTorch, for the tests). The wrapper contracts are the
reference's (``decode_attention/ops.py``): ``pos`` is a scalar or a
``[B]`` vector, and CSR tables sized for another batch raise
``ValueError``.

A wrapper runs the plain version only for tensors that lie on the CPU. For
a CUDA tensor it launches the kernel or raises: it never falls back. On
every device it refuses an input that requires grad
(:func:`repro_torch.kernels.guard.refuse_autograd`). Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.guard import refuse_autograd

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)            # head dimensions all kernels are built for
# flash_decode (dense cache) also at gemma3's 256, up to 4 query heads a kv
# head; the paged kernels raise for it
DENSE_HEAD_DIMS = HEAD_DIMS + (256,)
MAX_GROUP_256 = 4
KEY_TILE = 64                        # keys per tile of the split kernel (kKT)
SMS = 132                            # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 2                    # split blocks an SM runs (decode_splits)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      f, i, i, p]
    lib.flash_decode_bf16.restype = i
    lib.paged_flash_decode_bf16.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                            i, i, i, i, i, i, f, i, i, p]
    lib.paged_flash_decode_bf16.restype = i
    return lib


# -- argument contracts (shared with the prefill kernel) ----------------------

def pos_vector(pos, B: int, device, name: str = "pos") -> torch.Tensor:
    """A scalar or [B] position as an int32 [B] vector on ``device``."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() > 1:
        raise ValueError(f"{name} must be a scalar or a [B] vector, got "
                         f"shape {tuple(pos.shape)}")
    if pos.dim() == 1 and pos.shape[0] != B:
        raise ValueError(f"per-row {name} length {pos.shape[0]} != batch {B}")
    return pos.to(torch.int32).expand(B).contiguous()


def check_tables(B: int, page_indptr: torch.Tensor,
                 last_page_len: torch.Tensor) -> None:
    """The CSR tables must be sized for the batch."""
    if page_indptr.shape[0] != B + 1:
        raise ValueError(f"page_indptr carries {page_indptr.shape[0] - 1} "
                         f"rows for a batch of {B}")
    if last_page_len.shape[0] != B:
        raise ValueError(f"last_page_len carries {last_page_len.shape[0]} "
                         f"rows for a batch of {B}")


def check_cuda(name: str, floats, ints=(), head_dims=HEAD_DIMS) -> None:
    """What the CUDA kernels take: bf16 contiguous tensors on 16-byte
    boundaries, int32 contiguous tables, all on one CUDA device, a head
    dimension among ``head_dims``."""
    dev = floats[0].device
    for t in floats:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             f"tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not on a 16-byte boundary")
    for t in tuple(floats) + tuple(ints):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device")
    for t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tables must be contiguous int32")
    hd = floats[0].shape[-1]
    if hd not in head_dims:
        raise ValueError(f"{name}: head_dim {hd} not built (one of "
                         f"{head_dims})")


def raise_on(err: int, name: str) -> None:
    if err == -1:
        raise ValueError(f"{name}: unsupported head dimension")
    if err == -2:
        raise ValueError(f"{name}: the key splits do not cover S")
    if err == -3:                      # every page size >= 1 is built
        raise ValueError(f"{name}: unsupported page size")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t: torch.Tensor) -> int:
    return _sm_count(t.device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_gather(k_pages: torch.Tensor, v_pages: torch.Tensor,
                 page_indptr: torch.Tensor, page_indices: torch.Tensor,
                 last_page_len: torch.Tensor, max_pages: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's pages gathered into a dense ``[B, max_pages*page_size,
    Hk, hd]`` view (rows padded with page 0, past every row's last key),
    plus each row's last valid key ``(n_pages-1)*page_size +
    last_page_len - 1`` [B] (int64; may be anything a caller's
    ``last_page_len`` makes it)."""
    ps = k_pages.shape[1]
    indptr = page_indptr.long()
    n = indptr[1:] - indptr[:-1]
    if int(n.max()) > max_pages:
        raise ValueError(f"a row holds {int(n.max())} pages > max_pages "
                         f"{max_pages}")
    slot = indptr[:-1, None] + torch.arange(max_pages, device=indptr.device)
    ids = torch.where(slot < indptr[1:, None],
                      page_indices.long()[slot.clamp(max=indptr[-1] - 1)],
                      torch.zeros((), dtype=torch.long, device=indptr.device))
    B = ids.shape[0]
    shape = (B, max_pages * ps) + tuple(k_pages.shape[2:])
    last = (n - 1) * ps + last_page_len.long() - 1
    return k_pages[ids].reshape(shape), v_pages[ids].reshape(shape), last


# -- plain versions (same rounding points as the kernels) --------------------

def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, window: int = -1) -> torch.Tensor:
    """One query token per row against a dense cache, as one masked
    softmax: fp32 scores of the hd^-0.5-scaled q, fp32 PV, one rounding to
    q's dtype. q [B, H, hd]; k/v [B, S, Hk, hd]; pos scalar or [B]: row b
    sees keys j <= pos_b (and pos_b - j < window when window > 0)."""
    B, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    group = H // Hk
    pos_b = pos_vector(pos, B, q.device)
    qg = q.reshape(B, 1, Hk, group, hd).float() * hd ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgk", qg, k.float())
    j = torch.arange(S, device=q.device)
    valid = j[None, :] <= pos_b[:, None]                     # [B, S]
    if window > 0:
        valid &= (pos_b[:, None] - j[None, :]) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_splits(B: int, S: int, H: int, Hk: int, sms: int = SMS):
    """(splits, split_len) of ``flash_decode``'s key axis, from the shapes
    alone (the positions stay on the card) and the card's SM count: as many
    splits as put ``BLOCKS_PER_SM`` blocks on every SM in one wave, each at
    least 4 64-key tiles, none empty; a short cache gets one split. Two
    blocks an SM is what measured fastest on an H100 at the long shape (8
    splits of 4096 keys; 12, 16 and 32 splits ran slower)."""
    group = H // Hk
    rows = B * Hk * (1 if group <= 16 else -(-group // 16))
    tiles = max(1, -(-S // KEY_TILE))
    n = max(1, min(tiles // 4, BLOCKS_PER_SM * sms // rows))
    per = -(-tiles // n)
    return -(-tiles // per), per * KEY_TILE


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, pos, window: int = -1,
                             splits=None) -> torch.Tensor:
    """``flash_decode``'s two passes in plain PyTorch. Each split of the
    key axis (``decode_splits`` unless given as ``(splits, split_len)``)
    yields its max m, sum l and unnormalised fp32 acc over the keys it
    sees (m = -1e30, l = 0, acc = 0 where it sees none); the combine
    weighs each by exp(m_s - max m) in split order and rounds once. For
    the tests: the serving path never calls it."""
    B, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    group = H // Hk
    n, ln = splits or decode_splits(B, S, H, Hk)
    pos_b = pos_vector(pos, B, q.device)
    qg = q.reshape(B, 1, Hk, group, hd).float() * hd ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgk", qg, k.float())     # [B, Hk, g, S]
    j = torch.arange(S, device=q.device)
    valid = j[None, :] <= pos_b[:, None]
    if window > 0:
        valid &= (pos_b[:, None] - j[None, :]) < window
    ms, ls, accs = [], [], []
    for sp in range(n):
        seen = valid & (j[None, :] >= sp * ln) & (j[None, :] < (sp + 1) * ln)
        ss = torch.where(seen[:, None, None, :], s, NEG_INF)
        m = ss.max(dim=-1).values                            # [B, Hk, g]
        p = torch.where(seen[:, None, None, :], torch.exp(ss - m[..., None]),
                        0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, v.float()))
    return combine_splits(ms, ls, accs).reshape(B, H, hd).to(q.dtype)


def combine_splits(ms, ls, accs) -> torch.Tensor:
    """The splits' partials (m, l, unnormalised acc) merged in split order:
    sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s, m = max_s m_s, in
    fp32 (the combine kernel's arithmetic)."""
    m_all = torch.stack(ms).max(dim=0).values
    l = torch.zeros_like(m_all)
    o = torch.zeros_like(accs[0])
    for m, ls_, acc in zip(ms, ls, accs):
        w = torch.exp(m - m_all)
        l = l + w * ls_
        o = o + w[..., None] * acc
    return o / l.clamp(min=1e-30)[..., None]


def paged_flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_indptr: torch.Tensor,
                             page_indices: torch.Tensor,
                             last_page_len: torch.Tensor, max_pages: int,
                             window: int = -1) -> torch.Tensor:
    """The rows' pages gathered into a dense view, then
    :func:`flash_decode_plain` with each row's query at its last key: so a
    paged pool and a dense cache holding the same KV agree bit for bit."""
    k, v, last = paged_gather(k_pages, v_pages, page_indptr, page_indices,
                              last_page_len, max_pages)
    return flash_decode_plain(q, k, v, last, window)


def paged_flash_decode_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   page_indptr: torch.Tensor,
                                   page_indices: torch.Tensor,
                                   last_page_len: torch.Tensor,
                                   max_pages: int, window: int = -1,
                                   splits=None) -> torch.Tensor:
    """``paged_flash_decode``'s two passes in plain PyTorch: the rows'
    pages gathered, then :func:`flash_decode_split_plain` with each row's
    query at its last key and the splits (``decode_splits`` of
    ``max_pages * page_size`` keys unless given) the kernel takes. For the
    tests: the serving path never calls it."""
    B, H, _ = q.shape
    k, v, last = paged_gather(k_pages, v_pages, page_indptr, page_indices,
                              last_page_len, max_pages)
    splits = splits or decode_splits(B, k.shape[1], H, k.shape[2])
    return flash_decode_split_plain(q, k, v, last, window, splits)


# -- wrappers ----------------------------------------------------------------

def split_workspace(rows: Tuple[int, ...], hd: int, splits: int, device):
    """The fp32 partials of ``splits`` > 1 key splits: (acc [*rows, splits,
    hd], (m, l) [*rows, splits, 2]); (None, None) for one split."""
    if splits == 1:
        return None, None
    return (torch.empty(rows + (splits, hd), dtype=torch.float32,
                        device=device),
            torch.empty(rows + (splits, 2), dtype=torch.float32,
                        device=device))


def ptr_of(t):
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 window: int = -1) -> torch.Tensor:
    """q [B, H, hd]; k/v [B, S, Hk, hd]; pos scalar or [B] -> [B, H, hd]."""
    refuse_autograd("flash_decode", q, k, v)
    B, H, hd = q.shape
    pos_b = pos_vector(pos, B, q.device)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos_b, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    S, Hk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or H % Hk:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    check_cuda("flash_decode", (q, k, v), (pos_b,), DENSE_HEAD_DIMS)
    if hd == 256 and H // Hk > MAX_GROUP_256:
        raise ValueError(f"flash_decode: head_dim 256 is built for up to "
                         f"{MAX_GROUP_256} query heads a kv head, got "
                         f"{H // Hk}")
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    splits, split_len = decode_splits(B, S, H, Hk, sm_count(q))
    ws_acc, ws_ml = split_workspace((B, H), hd, splits, q.device)
    err = _lib().flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_b.data_ptr(),
        out.data_ptr(), ptr_of(ws_acc), ptr_of(ws_ml),
        B, S, H, Hk, hd, int(window), hd ** -0.5, splits, split_len,
        stream_of(q))
    raise_on(err, "flash_decode")
    flash_decode.launches += 1
    return out


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_indptr: torch.Tensor,
                       page_indices: torch.Tensor,
                       last_page_len: torch.Tensor, max_pages: int,
                       window: int = -1) -> torch.Tensor:
    """q [B, H, hd]; k_pages/v_pages [num_pages, page_size, Hk, hd];
    page_indptr [B+1] / page_indices / last_page_len [B]: CSR page tables
    (every row >= 1 page, at most ``max_pages``; page ids in
    [0, num_pages)). Row b's query sits at its last key. The key axis
    splits as ``decode_splits`` picks for ``max_pages * page_size`` keys.
    -> [B, H, hd]."""
    refuse_autograd("paged_flash_decode", q, k_pages, v_pages)
    B, H, hd = q.shape
    check_tables(B, page_indptr, last_page_len)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, page_indptr,
                                        page_indices, last_page_len,
                                        max_pages, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device "
                         f"{q.device}")
    N, ps, Hk = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != hd or H % Hk:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)} does not "
                         f"match the pool {tuple(k_pages.shape)}")
    tables = [t.to(torch.int32).contiguous()
              for t in (page_indptr, page_indices, last_page_len)]
    check_cuda("paged_flash_decode", (q, k_pages, v_pages), tables)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, split_len = decode_splits(B, max_pages * ps, H, Hk, sm_count(q))
    ws_acc, ws_ml = split_workspace((B, H), hd, splits, q.device)
    err = _lib().paged_flash_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() for t in tables), out.data_ptr(), ptr_of(ws_acc),
        ptr_of(ws_ml), B, N, ps, int(max_pages), H, Hk, hd, int(window),
        hd ** -0.5, splits, split_len, stream_of(q))
    raise_on(err, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


flash_decode.launches = 0
paged_flash_decode.launches = 0
