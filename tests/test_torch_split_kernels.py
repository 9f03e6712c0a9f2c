"""The two-pass algorithm of the split flash-decode kernel, in plain
PyTorch, against the one-pass plain version and the JAX reference.

``flash_decode`` splits the key axis across blocks and combines the
splits' (m, l, acc) partials in split order. A CUDA kernel cannot run
here, so the algorithm has a plain mirror (``flash_decode_split_plain``)
that the kernel follows; these tests hold the mirror to
``flash_decode_plain`` and to the reference's ``decode_attention_ref`` on
seeded numpy inputs, and check the host's split choice.
``tests/test_torch_gpu.py`` holds the kernel to the one-pass plain version
on the card.

Tolerance: one bf16 rounding of the largest output (2^-7 of it). Both
sides form the same fp32 products and round once to bf16; the split
version sums in another order (per split, then across splits), so an
output may land one bf16 step away.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_attention import decode_attention  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402

torch.set_num_threads(2)


def _pair(rng, shape, scale=1.0):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, tensor_from_numpy(np.asarray(jx), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close_one_rounding(got, want):
    want = _f32(want)
    tol = 2 ** -7 * np.abs(want).max() + 1e-6
    err = np.abs(_f32(got) - want).max()
    assert err <= tol, (err, tol)


# -- flash_decode: split S, then combine -----------------------------------------

SPLIT_DECODE_CASES = [
    # B, H, Hk, hd, S, pos, window, splits (None: decode_splits)
    # row 0 sees only split 0: splits 1-4 see no key; pos = 0; S = 300 is
    # not a multiple of the 64-key split
    (3, 8, 2, 32, 300, [40, 299, 0], -1, (5, 64)),
    # windows of 50 starting inside split 3 (row 0) and split 1 (row 1)
    (2, 4, 4, 64, 300, [299, 130], 50, (5, 64)),
    # one split
    (2, 8, 2, 32, 300, [299, 17], -1, (1, 320)),
    # the host's choice: 4 splits of 256 over 1000 keys, a window of 100
    (2, 8, 2, 64, 1000, [999, 517], 100, None),
    # the ragged card case's geometry, narrowed to 2 kv heads: S = 5000 in
    # 8 splits of 640, windows of 300 from inside splits 7 and 3, row 1's
    # keys in split 0, pos = 0
    (4, 8, 2, 32, 5000, [4999, 17, 2500, 0], 300, (8, 640)),
    # the same narrowed case at the host's choice for it: 16 splits of 320
    (4, 8, 2, 32, 5000, [4999, 17, 2500, 0], 300, None),
    # gemma3-4b's widths (8/4 heads of 256, the dense-only hd 256 build) at
    # its served capacity of 1132 keys, a local layer's window of 1024 and
    # a global layer, at the host's choice of splits
    (2, 8, 4, 256, 1132, [1130, 600], 1024, None),
    (2, 8, 4, 256, 1132, [1130, 0], -1, None),
]


@pytest.mark.parametrize("case", SPLIT_DECODE_CASES)
def test_flash_decode_split_matches_one_pass_and_ref(case):
    B, H, Hk, hd, S, pos, window, splits = case
    rng = np.random.default_rng(11)
    jq, q = _pair(rng, (B, H, hd))
    jk, k = _pair(rng, (B, S, Hk, hd))
    jv, v = _pair(rng, (B, S, Hk, hd))
    pos = np.asarray(pos, np.int32)
    got = dec.flash_decode_split_plain(q, k, v, torch.from_numpy(pos),
                                       window, splits)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_one_rounding(got, dec.flash_decode_plain(
        q, k, v, torch.from_numpy(pos), window))
    _close_one_rounding(got, decode_attention_ref(jq, jk, jv,
                                                  jnp.asarray(pos), window))


@pytest.mark.parametrize("window", [-1, 1024, 300])
def test_flash_decode_plain_matches_pallas_at_head_dim_256(window):
    """gemma3's head dim: the plain version the CPU runs against the JAX
    package's ``flash_decode`` Pallas kernel (interpret mode off-TPU, as
    ``tests/test_kernels_attention.py`` runs it), per-row positions past
    the window, within one bf16 rounding."""
    rng = np.random.default_rng(13)
    jq, q = _pair(rng, (2, 8, 256))
    jk, k = _pair(rng, (2, 1536, 4, 256))
    jv, v = _pair(rng, (2, 1536, 4, 256))
    pos = np.asarray([1535, 1100], np.int32)
    got = dec.flash_decode_plain(q, k, v, torch.from_numpy(pos), window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_one_rounding(got, decode_attention(jq, jk, jv, jnp.asarray(pos),
                                              window=window))


def test_flash_decode_one_split_is_the_one_pass_softmax():
    """With one split the combine weighs the only partial by exp(0) = 1:
    acc / l, the one-pass softmax up to fp32 summation order."""
    rng = np.random.default_rng(12)
    _, q = _pair(rng, (2, 4, 32))
    _, k = _pair(rng, (2, 70, 2, 32))
    _, v = _pair(rng, (2, 70, 2, 32))
    pos = torch.tensor([69, 3], dtype=torch.int32)
    got = dec.flash_decode_split_plain(q, k, v, pos, -1, (1, 128))
    want = dec.flash_decode_plain(q, k, v, pos, -1)
    _close_one_rounding(got, want)


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("S", [1, 49, 63, 64, 65, 1000, 5000, 32768, 100000])
@pytest.mark.parametrize("B, H, Hk", [(1, 8, 8), (4, 32, 8), (16, 32, 8),
                                      (2, 64, 2)])
def test_decode_splits_cover_s_in_one_wave(S, B, H, Hk, sms):
    """Whole tiles, no empty split, and at most 2 blocks on every SM."""
    n, ln = dec.decode_splits(B, S, H, Hk, sms)
    assert n >= 1 and ln % dec.KEY_TILE == 0
    assert (n - 1) * ln < S <= n * ln
    assert n == 1 or B * Hk * n <= dec.BLOCKS_PER_SM * sms


def test_decode_splits_at_the_served_and_long_shapes():
    # served: the dense phase's 4 slots at capacity 49 -> one block per
    # (row, kv head) writes the output: no workspace, no combine
    assert dec.decode_splits(4, 49, 32, 8)[0] == 1
    # long: 32768 keys over 32 (row, kv head) pairs -> 8 splits of 4096,
    # 256 blocks: 2 on 128 of the 132 SMs, and a ninth split would not fit
    # 2 an SM in one wave. (At least 264 blocks, 2 on every SM, would take
    # 9 splits: 288 blocks, 3 on some SMs. 8 splits measured faster than
    # 12, 16 and 32.)
    n, ln = dec.decode_splits(4, 32768, 32, 8)
    assert (n, ln) == (8, 4096)
    assert 4 * 8 * n <= 2 * 132 < 4 * 8 * (n + 1)
    # the ragged card case: 8 splits of 640 over S = 5000
    assert dec.decode_splits(4, 5000, 32, 8) == (8, 640)
