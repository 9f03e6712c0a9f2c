"""The shapes each kernel is checked and timed at on the card, how to make
its inputs, the work its inputs need, and the one PyTorch call (if any)
that computes the same function: what ``chip_smoke.py`` reads from
:data:`repro_torch.kernels.ALL`, the same way for every kernel.

Cases are ``(label, spec)``: ``served`` is the shape the serving path
gives the kernel in ``chip_smoke.py``'s Mixtral serve phases (timed, and
the numbers of the ``kernels`` line), ``long`` a long context (timed:
32768 tokens, Mixtral's ``max_seq_len``, for attention; 65536 for the SSD
scan), ``model:<arch>`` the shape another served model gives it (timed:
phi35-moe's and qwen3-moe's decode steps, mistral-nemo's, smollm's,
qwen2-72b's, qwen2-vl-7b's and seamless-m4t-large-v2's generic decode at
4 x 1024 prompt tokens plus 32 decoded (seamless's cross-attention over
1024 frames too), gemma3-4b's at 4 x 2048 plus 32, jamba's Mamba
prefill),
``ragged`` shapes that exercise the masked edges (checked only). Inputs
are drawn on the card from the caller's generator; page tables from
numpy, seeded. A wrapper returns one tensor or a tuple of them.

``work`` returns ``(bytes, operations)`` that these inputs need: each
input byte read once and each output byte written once, and the products'
operations, counting only the keys each query can see (the kernels stop
where a row's keys end). The library calls are yardsticks for
``chip_smoke.py`` only; nothing in the serving path calls them.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

MIXTRAL_ATTN = dict(H=32, Hk=8, hd=128)      # Mixtral-8x7B's attention widths
LONG = 32768                                 # Mixtral-8x7B's max_seq_len
GENERIC_CAP = 1024 + 32       # the generic dense decode: prompt + generated
GEMMA_CAP = 2048 + 32         # gemma3-4b's: longer than its 1024-key window


def _nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (other values count nothing)."""
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _rnd(gen, *shape, scale=1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


# -- grouped expert matmuls --------------------------------------------------

MOE_CASES = [("served", (8, 8, 4096, 14336)),     # G, C, D, F on decode
             ("ragged", (3, 5, 200, 100)), ("ragged", (2, 13, 1000, 1000)),
             ("ragged", (1, 3, 36, 52))]


# the decode step's dispatch buffer of the other served MoE models, every
# pick its own group (G = C = slots x top-k, at most the experts): 4 slots
# of phi35-moe (16 experts top-2, d_ff 6400) and of qwen3-moe (128 experts
# top-8, d_model 2048, d_ff 768)
MODEL_MOE_CASES = [("model:phi35-moe", (8, 8, 4096, 6400)),
                   ("model:qwen3-moe-30b-a3b", (32, 32, 2048, 768))]


# gmm: the same, plus the ring kernel's edges: C = 13 and C = 64 at the
# down-projection's K and N (two and eight n-tiles a block), a K of 160
# (the last 64-row tile short), K and N not multiples of 8 (the scalar-load
# kernel)
GMM_CASES = MOE_CASES + [("ragged", (2, 13, 4096, 14336)),
                         ("ragged", (2, 64, 4096, 14336)),
                         ("ragged", (1, 8, 4096, 160)),
                         ("ragged", (2, 5, 300, 1001))] + MODEL_MOE_CASES


# swiglu_gmm: the same, plus the ring kernel's edges at the served K and N:
# C = 13 and C = 64 (two and eight n-tiles a block), a K of 160 (the last
# 64-row tile short), K and N not multiples of 8 (the scalar-load kernel)
SWIGLU_CASES = MOE_CASES + [("ragged", (2, 13, 4096, 14336)),
                            ("ragged", (2, 64, 4096, 14336)),
                            ("ragged", (1, 8, 160, 14336)),
                            ("ragged", (2, 5, 300, 1001))] + MODEL_MOE_CASES


def swiglu_inputs(shape, gen):
    G, C, D, F = shape
    return (_rnd(gen, G, C, D), _rnd(gen, G, D, F, scale=0.02),
            _rnd(gen, G, D, F, scale=0.02))


def gmm_inputs(shape, gen):
    G, C, D, F = shape                            # the down-projection
    return (_rnd(gen, G, C, F), _rnd(gen, G, F, D, scale=0.02))


def swiglu_work(args, out) -> Tuple[int, int]:
    x, w1, _ = args
    G, C, K = x.shape
    return _nbytes(*args, out), 4 * G * C * K * w1.shape[2]


def gmm_work(args, out) -> Tuple[int, int]:
    x, w = args
    G, C, K = x.shape
    return _nbytes(*args, out), 2 * G * C * K * w.shape[2]


def gmm_library(args) -> Optional[Callable]:
    return lambda: torch.bmm(*args)


# -- decode attention ----------------------------------------------------------

def _visible(qpos: int, last: int, window: int) -> Tuple[int, int]:
    """[lo, hi] of the keys a query at qpos sees below `last`."""
    hi = min(qpos, last)
    lo = max(0, qpos - window + 1) if window > 0 else 0
    return lo, hi


# served: the dense phase's 4 slots at its capacity of 49 (prompts of
# 16-32 tokens + 16 new + 1); ragged: S not a multiple of anything, per-row
# pos, windows, other head counts and head dims
FLASH_DECODE_CASES = [
    ("served", dict(B=4, S=49, pos=[20, 35, 48, 31], window=-1,
                    **MIXTRAL_ATTN)),
    ("long", dict(B=4, S=LONG, pos=[LONG - 1] * 4, window=-1,
                  **MIXTRAL_ATTN)),
    ("ragged", dict(B=3, S=77, pos=[0, 40, 76], window=-1, H=6, Hk=2,
                    hd=64)),
    ("ragged", dict(B=2, S=1000, pos=[999, 517], window=100, H=8, Hk=8,
                    hd=128)),
    ("ragged", dict(B=5, S=130, pos=[5, 129, 64, 0, 100], window=7, H=12,
                    Hk=4, hd=32)),
    # split S: 8 splits of 640 keys on 132 SMs; windows starting inside
    # splits 7 and 3, a row whose keys end in split 0, pos = 0
    ("ragged", dict(B=4, S=5000, pos=[4999, 17, 2500, 0], window=300,
                    **MIXTRAL_ATTN)),
    # the other served models' decode attention: qwen3-moe's engine phase
    # (4 slots at the dense phase's capacity, group 8), and the generic
    # path's last decode step of 4 x 1024-token prompts with 32 generated
    # (capacity 1056): mistral-nemo (32/8 heads of 128), smollm (15/5 of
    # 64, group 3), qwen2-72b (64/8 of 128)
    ("model:qwen3-moe-30b-a3b", dict(B=4, S=49, pos=[20, 35, 48, 31],
                                     window=-1, H=32, Hk=4, hd=128)),
    ("model:mistral-nemo-12b", dict(B=4, S=GENERIC_CAP,
                                    pos=[GENERIC_CAP - 1] * 4, window=-1,
                                    H=32, Hk=8, hd=128)),
    ("model:smollm-360m", dict(B=4, S=GENERIC_CAP, pos=[GENERIC_CAP - 1] * 4,
                               window=-1, H=15, Hk=5, hd=64)),
    ("model:qwen2-72b", dict(B=4, S=GENERIC_CAP, pos=[GENERIC_CAP - 1] * 4,
                             window=-1, H=64, Hk=8, hd=128)),
    # gemma3-4b's generic decode (8/4 heads of 256, the dense-only hd 256
    # build): chip_smoke's last step of 4 x 2048-token prompts with 32
    # generated (capacity 2080, the query at 2078): a local layer (window
    # 1024, 5 of every 6) and a global one
    ("model:gemma3-4b", dict(B=4, S=GEMMA_CAP, pos=[GEMMA_CAP - 2] * 4,
                             window=1024, H=8, Hk=4, hd=256)),
    ("model:gemma3-4b:global", dict(B=4, S=GEMMA_CAP,
                                    pos=[GEMMA_CAP - 2] * 4, window=-1,
                                    H=8, Hk=4, hd=256)),
    # qwen2-vl-7b's generic decode at 4 x 1024 + 32 (28/4 heads of 128:
    # group 7 on the 8-row build, one row idle), and seamless-m4t-large-v2's
    # decoder at the same (16/16 heads of 64, MHA: group 1 on the 4-row
    # build, three rows idle): its causal self-attention, and its
    # cross-attention over the 1024 encoder frames, every key visible
    ("model:qwen2-vl-7b", dict(B=4, S=GENERIC_CAP, pos=[GENERIC_CAP - 1] * 4,
                               window=-1, H=28, Hk=4, hd=128)),
    ("model:seamless-m4t-large-v2", dict(B=4, S=GENERIC_CAP,
                                         pos=[GENERIC_CAP - 1] * 4,
                                         window=-1, H=16, Hk=16, hd=64)),
    ("model:seamless-m4t-large-v2:cross", dict(B=4, S=1024, pos=[1023] * 4,
                                               window=-1, H=16, Hk=16,
                                               hd=64)),
]


def flash_decode_inputs(spec, gen):
    B, S, H, Hk, hd = (spec[k] for k in ("B", "S", "H", "Hk", "hd"))
    pos = torch.tensor(spec["pos"], dtype=torch.int32, device="cuda")
    return (_rnd(gen, B, H, hd), _rnd(gen, B, S, Hk, hd),
            _rnd(gen, B, S, Hk, hd), pos, spec["window"])


def flash_decode_work(args, out) -> Tuple[int, int]:
    q, k, _, pos, window = args
    B, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    keys = 0
    for p in pos.tolist():
        lo, hi = _visible(p, S - 1, window)
        keys += hi - lo + 1
    kv = 2 * keys * Hk * hd * k.element_size()
    return kv + _nbytes(q, pos, out), 4 * H * hd * keys


def flash_decode_library(args) -> Optional[Callable]:
    """``scaled_dot_product_attention`` with the same mask, GQA by the
    call itself (a yardstick: the port never calls it)."""
    q, k, v, pos, window = args
    S = k.shape[1]
    j = torch.arange(S, device=q.device)
    mask = j[None, :] <= pos[:, None].long()
    if window > 0:
        mask &= (pos[:, None].long() - j[None, :]) < window
    mask = mask[:, None, None, :]                          # [B, 1, 1, S]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True)


def _csr(lengths, ps, num_pages, rng, full_width=0):
    """Page tables for rows of the given valid lengths over permuted,
    non-contiguous pages. ``full_width`` > 0 builds the engine's rows
    instead: every row ``full_width`` pages long (the ones past its
    length padded with page 0) and last_page_len = length -
    (full_width-1)*ps, which may be <= 0."""
    perm = list(rng.permutation(num_pages))
    indptr, indices, lastlen = [0], [], []
    for ln in lengths:
        need = -(-ln // ps)
        n = full_width or need
        indices += [int(perm.pop()) for _ in range(need)] + [0] * (n - need)
        indptr.append(len(indices))
        lastlen.append(ln - (n - 1) * ps)
    return [torch.tensor(a, dtype=torch.int32, device="cuda")
            for a in (indptr, indices, lastlen)]


def _pool(gen, num_pages, ps, Hk, hd):
    return _rnd(gen, num_pages, ps, Hk, hd), _rnd(gen, num_pages, ps, Hk, hd)


def _lasts(indptr, lastlen, ps):
    n = (indptr[1:] - indptr[:-1]).tolist()
    return [(ni - 1) * ps + ll - 1 for ni, ll in zip(n, lastlen.tolist())]


# served: the paged phase's 4 slots, page_size 16, capacity 128 (prompts of
# up to 96 tokens + 16 new + 1, rounded up to whole pages)
PAGED_DECODE_CASES = [
    ("served", dict(lengths=[41, 60, 97, 112], ps=16, max_pages=8,
                    window=-1, **MIXTRAL_ATTN)),
    ("long", dict(lengths=[LONG] * 4, ps=16, max_pages=LONG // 16,
                  window=-1, **MIXTRAL_ATTN)),
    ("ragged", dict(lengths=[1, 23, 64, 41], ps=8, max_pages=8, window=-1,
                    H=6, Hk=2, hd=64)),
    ("ragged", dict(lengths=[300, 17], ps=16, max_pages=19, window=40, H=8,
                    Hk=8, hd=128)),
    ("ragged", dict(lengths=[5, 130, 77], ps=4, max_pages=40, window=9,
                    H=12, Hk=4, hd=32)),
    # split S over the pool: the engine's full-width rows (every row 320
    # pages, last_page_len <= 0 on all but row 0) in 8 splits of 640 keys;
    # windows of 300 from inside splits 7 and 3, a row whose keys end in
    # split 0, a row of one key
    ("ragged", dict(lengths=[5000, 17, 2600, 1], ps=16, max_pages=320,
                    full_width=True, window=300, **MIXTRAL_ATTN)),
    # ps 12 (boxes of 4 keys, 3 a page) in 12 splits of 256
    ("ragged", dict(lengths=[3001, 700, 12], ps=12, max_pages=251,
                    window=-1, H=8, Hk=2, hd=128)),
    # ps 128 (one box, two tiles a page), engine rows, 16 splits of 256; a
    # window of 1000 from inside split 11
    ("ragged", dict(lengths=[4000, 129, 2049], ps=128, max_pages=32,
                    full_width=True, window=1000, H=16, Hk=4, hd=64)),
]


def paged_flash_decode_inputs(spec, gen):
    rng = np.random.default_rng(len(spec["lengths"]) + spec["ps"])
    H, Hk, hd, ps = (spec[k] for k in ("H", "Hk", "hd", "ps"))
    B = len(spec["lengths"])
    num_pages = sum(-(-n // ps) for n in spec["lengths"]) + 3
    kp, vp = _pool(gen, num_pages, ps, Hk, hd)
    width = spec["max_pages"] if spec.get("full_width") else 0
    indptr, indices, lastlen = _csr(spec["lengths"], ps, num_pages, rng,
                                    width)
    return (_rnd(gen, B, H, hd), kp, vp, indptr, indices, lastlen,
            spec["max_pages"], spec["window"])


def paged_flash_decode_work(args, out) -> Tuple[int, int]:
    q, kp, _, indptr, indices, lastlen, _, window = args
    B, H, hd = q.shape
    ps, Hk = kp.shape[1], kp.shape[2]
    keys = 0
    for last in _lasts(indptr, lastlen, ps):
        lo, hi = _visible(last, last, window)
        keys += hi - lo + 1
    kv = 2 * keys * Hk * hd * kp.element_size()
    return kv + _nbytes(q, indptr, indices, lastlen, out), \
        4 * H * hd * keys


# -- prefill attention -----------------------------------------------------------

# served: one C = 32 segment of a prompt of 90 tokens at position 64, on
# the engine's full-width row of 8 pages (last_page_len 90 - 7*16 <= 0);
# ragged: rows of unequal length at per-row pos0, windows, engine-style
# rows with last_page_len <= 0
PAGED_PREFILL_CASES = [
    ("served", dict(C=32, pos0=[64], lengths=[90], ps=16, max_pages=8,
                    full_width=True, window=-1, **MIXTRAL_ATTN)),
    ("long", dict(C=32, pos0=[LONG - 32], lengths=[LONG], ps=16,
                  max_pages=LONG // 16, full_width=False, window=-1,
                  **MIXTRAL_ATTN)),
    ("ragged", dict(C=8, pos0=[0, 5, 24, 40], lengths=[8, 13, 32, 48],
                    ps=8, max_pages=6, full_width=False, window=-1, H=6,
                    Hk=2, hd=64)),
    ("ragged", dict(C=6, pos0=[0, 3, 17, 33], lengths=[6, 9, 23, 39],
                    ps=16, max_pages=4, full_width=True, window=5, H=8,
                    Hk=8, hd=128)),
    ("ragged", dict(C=13, pos0=[50, 2], lengths=[61, 12], ps=4,
                    max_pages=20, full_width=True, window=-1, H=12, Hk=4,
                    hd=32)),
    # split over keys: C * group = 160 (two 128-row tiles) at a 3000-token
    # context, ps 12, engine rows of 256 pages (3072 keys: the plain flash
    # scan takes whole 1024-key chunks), 4 splits of 768; row 1's keys end
    # in split 0 and its prompt ends inside the segment
    ("ragged", dict(C=40, pos0=[3000, 60], lengths=[3040, 95], ps=12,
                    max_pages=256, full_width=True, window=-1,
                    **MIXTRAL_ATTN)),
    # ps 128, C * group = 12 (one padded warp), 16 splits of 256; a window
    # of 700 from inside split 5 (row 0) and split 13 (row 1)
    ("ragged", dict(C=3, pos0=[2000, 4093], lengths=[2003, 4096], ps=128,
                    max_pages=32, full_width=False, window=700, H=16, Hk=4,
                    hd=64)),
]


def paged_flash_prefill_inputs(spec, gen):
    rng = np.random.default_rng(spec["C"] + spec["ps"])
    H, Hk, hd, ps, C = (spec[k] for k in ("H", "Hk", "hd", "ps", "C"))
    B = len(spec["lengths"])
    num_pages = sum(-(-n // ps) for n in spec["lengths"]) + 3
    kp, vp = _pool(gen, num_pages, ps, Hk, hd)
    width = spec["max_pages"] if spec["full_width"] else 0
    indptr, indices, lastlen = _csr(spec["lengths"], ps, num_pages, rng,
                                    width)
    pos0 = torch.tensor(spec["pos0"], dtype=torch.int32, device="cuda")
    return (_rnd(gen, B, C, H, hd), kp, vp, indptr, indices, lastlen, pos0,
            spec["max_pages"], spec["window"])


def paged_flash_prefill_work(args, out) -> Tuple[int, int]:
    q, kp, _, indptr, indices, lastlen, pos0, _, window = args
    B, C, H, hd = q.shape
    ps, Hk = kp.shape[1], kp.shape[2]
    keys = flops_keys = 0
    for last, p0 in zip(_lasts(indptr, lastlen, ps), pos0.tolist()):
        spans = [_visible(p0 + c, last, window) for c in range(C)]
        flops_keys += sum(hi - lo + 1 for lo, hi in spans if hi >= lo)
        keys += max(hi for _, hi in spans) - min(lo for lo, _ in spans) + 1
    kv = 2 * keys * Hk * hd * kp.element_size()
    return kv + _nbytes(q, indptr, indices, lastlen, pos0, out), \
        4 * H * hd * flops_keys


# -- the Mamba2 SSD scan ----------------------------------------------------

MAMBA2_SSD = dict(nh=32, hp=64, ds=128, chunk=256)   # mamba2-370m's widths

# served: chip_smoke's Mamba prefill, 4 prompts of 2048 tokens; long: one
# 65536-token prompt; ragged: a 232-step tail (S = 1000), S < chunk, a
# non-zero incoming state, the reduced config's widths (hp 32, ds 32,
# chunk 64) with a tail, exactly one chunk (with an incoming state), a last
# chunk of a single step (S = 513)
SSD_CASES = [
    ("served", dict(B=4, S=2048, h0=False, **MAMBA2_SSD)),
    ("long", dict(B=1, S=65536, h0=False, **MAMBA2_SSD)),
    ("ragged", dict(B=1, S=1000, h0=False, **MAMBA2_SSD)),
    ("ragged", dict(B=3, S=37, h0=False, **MAMBA2_SSD)),
    ("ragged", dict(B=2, S=600, h0=True, **MAMBA2_SSD)),
    ("ragged", dict(B=2, S=200, nh=8, hp=32, ds=32, chunk=64, h0=True)),
    ("ragged", dict(B=2, S=256, h0=True, **MAMBA2_SSD)),
    ("ragged", dict(B=1, S=513, h0=False, **MAMBA2_SSD)),
    # jamba-v0.1-52b's Mamba layers (d_inner 8192: 128 heads of 64, d_state
    # 16): chip_smoke's prefill of 2 prompts of 1024 tokens
    ("model:jamba-v0.1-52b", dict(B=2, S=1024, nh=128, hp=64, ds=16,
                                  chunk=256, h0=False)),
]


def ssd_inputs(spec, gen):
    """(x, dt, A_log, Bm, Cm, h0, chunk) at the model's scales: dt a
    softplus of a unit normal shifted by -1, A_log around 0."""
    B, S, nh, hp, ds = (spec[k] for k in ("B", "S", "nh", "hp", "ds"))

    def f32(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(f32(B, S, nh) - 1.0)
    h0 = f32(B, nh, ds, hp) * 0.5 if spec["h0"] else None
    return (_rnd(gen, B, S, nh, hp), dt, f32(nh) * 0.5,
            _rnd(gen, B, S, ds, scale=0.3), _rnd(gen, B, S, ds, scale=0.3),
            h0, spec["chunk"])


def ssd_work(args, out) -> Tuple[int, int]:
    """Bytes: x, dt, A_log, B, C (once per row, not per head), h0, y, h.
    Operations, chunk by chunk over its valid steps v: C B^T once per row
    over the lower triangle (v(v+1)/2 pairs of ds products), then per head
    the intra-chunk product over the same triangle (hp per pair), C h (where
    a state comes in: not the first chunk without h0) and the state update
    (v ds hp each)."""
    x, _, _, Bm, _, h0, chunk = args
    B, S, nh, hp = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    ops = 0
    for c0 in range(0, S, Q):
        v = min(Q, S - c0)
        tri = v * (v + 1) // 2
        state_in = c0 > 0 or h0 is not None
        ops += 2 * tri * ds + nh * (2 * tri * hp + 2 * v * ds * hp
                                   * (2 if state_in else 1))
    return _nbytes(*args, *out), B * ops
