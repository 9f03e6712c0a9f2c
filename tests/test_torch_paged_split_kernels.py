"""The split algorithms of the paged attention kernels, in plain PyTorch,
against the one-pass plain versions and the JAX reference.

``paged_flash_decode`` runs the split flash-decode kernel with a paged
producer: the key axis split across blocks, each split's (m, l, acc)
partials combined in split order. ``paged_flash_prefill`` runs its
segment's query rows as tensor-core products, split over keys the same
way, with two rounding points of its own: the scores are the fp32 sums of
the bf16 products, scaled after (the reference scales q first), and P is
rounded to bf16 before PV. A CUDA kernel cannot run here, so each
algorithm has a plain mirror (``paged_flash_decode_split_plain``,
``paged_flash_prefill_split_plain``) that its kernel follows; these tests
hold the mirrors to the reference's ``paged_decode_ref`` /
``paged_prefill_ref`` and to the one-pass plain versions on seeded numpy
inputs, and check the host's split choice. ``tests/test_torch_gpu.py``
holds the kernels to the one-pass plain versions on the card.

Tolerance: one bf16 rounding of the largest output (2^-7 of it), as for
the dense split kernel (``tests/test_torch_split_kernels.py``): both sides
round once to bf16 and sum in another order; the prefill's bf16 P moves
each output by at most 2^-9 of the mean |v| its weights average.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention.ref import paged_decode_ref  # noqa: E402
from repro.kernels.prefill_attention.ref import \
    paged_prefill_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre  # noqa: E402

torch.set_num_threads(2)


def _pair(rng, shape, scale=1.0):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, tensor_from_numpy(np.asarray(jx))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close_one_rounding(got, want):
    want = _f32(want)
    tol = 2 ** -7 * np.abs(want).max() + 1e-6
    err = np.abs(_f32(got) - want).max()
    assert err <= tol, (err, tol)


def _csr(rng, lengths, ps, num_pages, full_width=0):
    """Rows of the given valid lengths over permuted pages; with
    ``full_width`` every row is that many pages, padded with page 0, and
    last_page_len may be <= 0 (the engine's rows)."""
    perm = list(rng.permutation(num_pages))
    indptr, indices, lastlen = [0], [], []
    for ln in lengths:
        need = -(-ln // ps)
        n = full_width or need
        indices += [int(perm.pop()) for _ in range(need)] + [0] * (n - need)
        indptr.append(len(indices))
        lastlen.append(ln - (n - 1) * ps)
    return [np.asarray(a, np.int32) for a in (indptr, indices, lastlen)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- paged_flash_decode: split S over the pool, then combine ---------------------

PAGED_SPLIT_DECODE_CASES = [
    # lengths, ps, Hk, group, hd, window, full width, splits (None:
    # decode_splits of max_pages * ps keys)
    # the engine's rows (every row 40 pages, last_page_len <= 0 on rows 1
    # and 2); row 1's keys end in split 0, row 2 holds one key
    ([150, 17, 1], 4, 2, 3, 32, -1, 40, (3, 64)),
    # ps 12 (boxes of 4 keys); a window of 50 from inside split 2
    ([200, 61], 12, 2, 2, 64, 50, 0, (4, 64)),
    # ps 16 at the host's choice (4 splits of 256); windows of 100 from
    # inside splits 3 and 1
    ([1000, 517], 16, 2, 4, 64, 100, 0, None),
    # ps 128 (one box, two tiles a page), engine rows; a window of 300 from
    # inside split 3
    ([700, 129, 5], 128, 1, 4, 32, 300, 6, (6, 128)),
]


@pytest.mark.parametrize("case", PAGED_SPLIT_DECODE_CASES)
def test_paged_decode_split_matches_one_pass_and_ref(case):
    lengths, ps, Hk, group, hd, window, width, splits = case
    rng = np.random.default_rng(21)
    B, H = len(lengths), Hk * group
    num_pages = sum(-(-n // ps) for n in lengths) + 3
    jq, q = _pair(rng, (B, H, hd))
    jkp, kp = _pair(rng, (num_pages, ps, Hk, hd))
    jvp, vp = _pair(rng, (num_pages, ps, Hk, hd))
    csr = _csr(rng, lengths, ps, num_pages, width)
    if width:
        assert (csr[2] <= 0).any()
    max_pages = width or int((csr[0][1:] - csr[0][:-1]).max())
    n, ln = splits or dec.decode_splits(B, max_pages * ps, H, Hk)
    assert n > 1 and (n - 1) * ln < max_pages * ps <= n * ln
    got = dec.paged_flash_decode_split_plain(q, kp, vp, *map(_t, csr),
                                             max_pages, window, splits)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_one_rounding(got, dec.paged_flash_decode_plain(
        q, kp, vp, *map(_t, csr), max_pages, window))
    _close_one_rounding(got, paged_decode_ref(
        jq, jkp, jvp, *csr, max_pages=max_pages, window=window))


# -- paged_flash_prefill: tensor-core tiles split over keys ----------------------

PAGED_SPLIT_PREFILL_CASES = [
    # C, pos0s, extra keys past the segment, ps, Hk, group, hd, window,
    # full width, splits (None: prefill_splits)
    # C * group = 12 < 16 (one padded warp), engine rows; row 1's keys end
    # in split 0
    (3, [200, 7], [0, 0], 4, 1, 4, 32, -1, 55, (4, 64)),
    # C * group = 160 > 128 (two row tiles), ps 12, engine rows, a window
    # of 60 from inside split 1; row 1's prompt ends 5 tokens into the
    # segment (its last rows see only its keys)
    (40, [150, 0], [0, -5], 12, 1, 4, 32, 60, 20, (4, 64)),
    # ps 128, engine rows, a window of 200 from inside split 3
    (5, [600, 60], [0, 0], 128, 2, 2, 64, 200, 6, (6, 128)),
    # ps 16 at the host's choice (3 splits of 320)
    (8, [900, 3], [0, 0], 16, 2, 2, 64, -1, 0, None),
]


@pytest.mark.parametrize("case", PAGED_SPLIT_PREFILL_CASES)
def test_paged_prefill_split_matches_one_pass_and_ref(case):
    C, pos0s, extra, ps, Hk, group, hd, window, width, splits = case
    rng = np.random.default_rng(22)
    B, H = len(pos0s), Hk * group
    lengths = [p + C + e for p, e in zip(pos0s, extra)]
    num_pages = sum(-(-n // ps) for n in lengths) + 3
    jq, q = _pair(rng, (B, C, H, hd))
    jkp, kp = _pair(rng, (num_pages, ps, Hk, hd))
    jvp, vp = _pair(rng, (num_pages, ps, Hk, hd))
    csr = _csr(rng, lengths, ps, num_pages, width)
    if width:
        assert (csr[2] <= 0).any()
    max_pages = width or int((csr[0][1:] - csr[0][:-1]).max())
    n, ln = splits or pre.prefill_splits(B, C, H, Hk, max_pages * ps)
    assert n > 1 and (n - 1) * ln < max_pages * ps <= n * ln
    pos0 = np.asarray(pos0s, np.int32)
    got = pre.paged_flash_prefill_split_plain(q, kp, vp, *map(_t, csr),
                                              _t(pos0), max_pages, window,
                                              splits)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_one_rounding(got, pre.paged_flash_prefill_plain(
        q, kp, vp, *map(_t, csr), _t(pos0), max_pages, window))
    _close_one_rounding(got, paged_prefill_ref(
        jq, jkp, jvp, *csr, pos0, max_pages=max_pages, window=window))


def test_paged_prefill_split_one_split_is_the_one_pass_scan():
    """One split over the served segment's geometry (C = 32 at position
    64 of a 90-token prompt on an engine row of 8 pages of 16), narrowed to
    one kv head: the tiles' online softmax with bf16 P against the flash
    scan, within one rounding."""
    rng = np.random.default_rng(23)
    _, q = _pair(rng, (1, 32, 4, 64))
    _, kp = _pair(rng, (11, 16, 1, 64))
    _, vp = _pair(rng, (11, 16, 1, 64))
    csr = list(map(_t, _csr(rng, [90], 16, 11, full_width=8)))
    pos0 = _t(np.asarray([64], np.int32))
    assert pre.prefill_splits(1, 32, 4, 1, 128)[0] == 1
    got = pre.paged_flash_prefill_split_plain(q, kp, vp, *csr, pos0, 8)
    _close_one_rounding(got, pre.paged_flash_prefill_plain(q, kp, vp, *csr,
                                                           pos0, 8))


# -- the host's split choice -------------------------------------------------------

def test_paged_splits_at_the_served_and_long_shapes():
    # served decode: 4 slots of 8 pages of 16 (128 keys): one split, no
    # workspace, no combine
    assert dec.decode_splits(4, 8 * 16, 32, 8)[0] == 1
    # long decode: 4 rows of 32768 keys in pages of 16 -> the dense
    # kernel's 8 splits of 4096 (256 blocks, 2 an SM)
    assert dec.decode_splits(4, 2048 * 16, 32, 8) == (8, 4096)
    # served segment: C = 32 on an engine row of 8 pages: one split
    assert pre.prefill_splits(1, 32, 32, 8, 8 * 16)[0] == 1
    # long segment: one 128-row tile per kv head, 8 blocks -> 16 splits of
    # 2048 keys, one block on 128 of the 132 SMs
    n, ln = pre.prefill_splits(1, 32, 32, 8, 2048 * 16)
    assert (n, ln) == (16, 2048)
    assert 8 * n <= 132 < 8 * (n + 1)


@pytest.mark.parametrize("sms", [66, 132])
@pytest.mark.parametrize("S", [1, 90, 128, 1000, 5000, 32768])
@pytest.mark.parametrize("B, C, H, Hk", [(1, 32, 32, 8), (2, 40, 32, 8),
                                         (4, 3, 16, 4), (1, 8, 8, 8)])
def test_prefill_splits_cover_the_pool_in_one_wave(S, B, C, H, Hk, sms):
    """Whole tiles, no empty split, at most one block on every SM."""
    n, ln = pre.prefill_splits(B, C, H, Hk, S, sms)
    assert n >= 1 and ln % pre.KEY_TILE == 0
    assert (n - 1) * ln < S <= n * ln
    tiles = -(-C * (H // Hk) // pre.ROW_TILE)
    assert n == 1 or B * Hk * tiles * n <= pre.BLOCKS_PER_SM * sms


# -- the wrappers' contracts -------------------------------------------------------

def test_cpu_wrappers_run_the_one_pass_plain_versions():
    """A CPU tensor takes the plain one-pass version, never a kernel (the
    split mirrors serve the tests only)."""
    rng = np.random.default_rng(24)
    _, q = _pair(rng, (2, 4, 32))
    _, qs = _pair(rng, (2, 5, 4, 32))
    _, kp = _pair(rng, (40, 12, 2, 32))
    _, vp = _pair(rng, (40, 12, 2, 32))
    csr = list(map(_t, _csr(rng, [300, 40], 12, 40, full_width=30)))
    pos0 = _t(np.asarray([290, 35], np.int32))
    reset_launches()
    torch.testing.assert_close(
        dec.paged_flash_decode(q, kp, vp, *csr, 30),
        dec.paged_flash_decode_plain(q, kp, vp, *csr, 30), rtol=0, atol=0)
    torch.testing.assert_close(
        pre.paged_flash_prefill(qs, kp, vp, *csr, pos0, 30),
        pre.paged_flash_prefill_plain(qs, kp, vp, *csr, pos0, 30), rtol=0,
        atol=0)
    assert not any(launches().values()), "a CPU tensor launched a kernel"


def test_unbuilt_page_size_and_head_dim_raise_value_error():
    """What the kernels are not built for raises ``ValueError``: a head dim
    outside 32, 64, 128 (the check the wrappers run on CUDA tensors, before
    any launch) and a page size below 1 (the entries' -3; every page size
    >= 1 is built, a box of gcd(page_size, 64) keys never crossing a
    page)."""
    q = torch.zeros((2, 4, 96), dtype=torch.bfloat16)
    kp = torch.zeros((4, 16, 2, 96), dtype=torch.bfloat16)
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        with pytest.raises(ValueError, match="head_dim 96 not built"):
            dec.check_cuda(name, (q, kp, kp))
        with pytest.raises(ValueError, match="unsupported page size"):
            dec.raise_on(-3, name)
    q64, kp64 = q[..., :64].contiguous(), kp[..., :64].contiguous()
    dec.check_cuda("paged_flash_decode", (q64, kp64, kp64))
