"""Flash-decode attention, dense and paged: wrappers over the Hopper kernels
and their plain PyTorch versions.

``flash_decode`` and ``paged_flash_decode`` replace the JAX package's
Pallas TPU kernels (``src/repro/kernels/decode_attention/``:
``decode_attention.py::flash_decode`` / ``_decode_kernel`` and
``paged.py::paged_flash_decode`` / ``_paged_kernel``) with the hand-written
CUDA kernels in ``csrc/decode_attention.cu``; that file's header gives
their bound (bytes: K and V read once up to each row's position) and what
the design does about it. The wrapper contracts are the reference's
(``decode_attention/ops.py``): ``pos`` is a scalar or a ``[B]`` vector,
and CSR tables sized for another batch raise ``ValueError``.

A wrapper runs the plain version only for tensors that lie on the CPU. For
a CUDA tensor it launches the kernel or raises: it never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)            # head dimensions the kernels are built for


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_decode_bf16.restype = i
    lib.paged_flash_decode_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            i, i, i, f, p]
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


def check_cuda(name: str, floats, ints=()) -> None:
    """What the CUDA kernels take: bf16 contiguous tensors on 16-byte
    boundaries, int32 contiguous tables, all on one CUDA device."""
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not built (one of "
                         f"{HEAD_DIMS})")


def raise_on(err: int, name: str) -> None:
    if err == -1:
        raise ValueError(f"{name}: unsupported head dimension")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


# -- wrappers ----------------------------------------------------------------

def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 window: int = -1) -> torch.Tensor:
    """q [B, H, hd]; k/v [B, S, Hk, hd]; pos scalar or [B] -> [B, H, hd]."""
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
    check_cuda("flash_decode", (q, k, v), (pos_b,))
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    err = _lib().flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_b.data_ptr(),
        out.data_ptr(), B, S, H, Hk, hd, int(window), hd ** -0.5,
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
    [0, num_pages)). Row b's query sits at its last key. -> [B, H, hd]."""
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
    err = _lib().paged_flash_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *(t.data_ptr() for t in tables), out.data_ptr(), B, N, ps, H, Hk,
        hd, int(window), hd ** -0.5, stream_of(q))
    raise_on(err, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


flash_decode.launches = 0
paged_flash_decode.launches = 0
