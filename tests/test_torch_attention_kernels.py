"""The port's attention kernels' plain versions and the model functions
that call them, against the reference.

Three layers of checks, all on the CPU from seeded numpy inputs:

* each plain version (``flash_decode_plain``, ``paged_flash_decode_plain``,
  ``paged_flash_prefill_plain``) against the reference's Pallas function
  in interpret mode, as ``tests/test_kernels_attention.py`` runs it, and
  against its ``ref.py`` twin; the wrapper contracts (pos rank and length,
  CSR table lengths) and ``last_page_len <= 0`` (the engine's full-width
  rows);
* the port's model functions (``decode_attention_paged``,
  ``segment_attention``, ``segment_attention_paged``) against the
  reference's, on the reduced Mixtral's attention weights;
* inside the port: the paged decode and segment paths bitwise equal to
  their dense twins over the same KV in permuted pages.

Tolerance, kernel level: one bf16 rounding of the largest output
(2^-7 of it): the port sums the softmax in one pass, the Pallas kernel
tile by tile, and both round once. Model level: as
``tests/test_torch_models.py`` (the projections round in bf16 at other
points in the two frameworks).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels.decode_attention import ref as jdec_ref  # noqa: E402
from repro.kernels.decode_attention.ops import \
    paged_decode_attention  # noqa: E402
from repro.kernels.prefill_attention import \
    paged_prefill_attention  # noqa: E402
from repro.kernels.prefill_attention import ref as jpre_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import prefill_attention as tpre  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(2)

BF16 = dict(rtol=2e-2, atol=2e-2)


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


# -- flash_decode ---------------------------------------------------------------

DECODE_CASES = [
    # B, H, Hk, hd, S, pos, window
    (3, 6, 2, 32, 77, [0, 40, 76], -1),
    (2, 8, 8, 64, 200, [199, 117], 50),
    (4, 8, 2, 32, 64, [5, 63, 20, 0], 7),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_and_ref(case):
    B, H, Hk, hd, S, pos, window = case
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, H, hd))
    jk, tk = _pair(rng, (B, S, Hk, hd))
    jv, tv = _pair(rng, (B, S, Hk, hd))
    pos = np.asarray(pos, np.int32)
    got = tdec.flash_decode_plain(tq, tk, tv, _t(pos), window)
    pallas = jdec.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                   window=window)
    twin = jdec_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                         window=window)
    _close_one_rounding(got, pallas)
    _close_one_rounding(got, twin)


def test_flash_decode_scalar_pos_and_contract():
    rng = np.random.default_rng(1)
    B, H, Hk, hd, S = 2, 4, 2, 32, 16
    _, q = _pair(rng, (B, H, hd))
    _, k = _pair(rng, (B, S, Hk, hd))
    _, v = _pair(rng, (B, S, Hk, hd))
    reset_launches()
    torch.testing.assert_close(tdec.flash_decode(q, k, v, 9),
                               tdec.flash_decode(q, k, v, _t([9, 9])),
                               rtol=0, atol=0)
    assert not any(launches().values()), "a CPU tensor launched a kernel"
    with pytest.raises(ValueError, match="scalar or a"):
        tdec.flash_decode(q, k, v, torch.zeros((B, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="per-row pos length"):
        tdec.flash_decode(q, k, v, torch.zeros(B + 1, dtype=torch.int32))


# -- paged_flash_decode -----------------------------------------------------------

PAGED_DECODE_CASES = [
    # lengths, ps, Hk, group, hd, window
    ([8, 23, 64, 41], 8, 2, 3, 32, -1),
    ([1, 17, 40], 4, 2, 2, 32, 9),
    ([30, 5], 16, 1, 4, 64, -1),
]


@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_paged_flash_decode_plain_matches_pallas_and_ref(case):
    lengths, ps, Hk, group, hd, window = case
    rng = np.random.default_rng(2)
    B, H = len(lengths), Hk * group
    num_pages = sum(-(-n // ps) for n in lengths) + 3
    jq, tq = _pair(rng, (B, H, hd))
    jkp, tkp = _pair(rng, (num_pages, ps, Hk, hd))
    jvp, tvp = _pair(rng, (num_pages, ps, Hk, hd))
    indptr, indices, lastlen = _csr(rng, lengths, ps, num_pages)
    max_pages = int((indptr[1:] - indptr[:-1]).max())
    got = tdec.paged_flash_decode_plain(tq, tkp, tvp, _t(indptr),
                                        _t(indices), _t(lastlen), max_pages,
                                        window)
    pallas = paged_decode_attention(jq, jkp, jvp, indptr, indices, lastlen,
                                    max_pages=max_pages, window=window)
    twin = jdec_ref.paged_decode_ref(jq, jkp, jvp, indptr, indices, lastlen,
                                     max_pages=max_pages, window=window)
    _close_one_rounding(got, pallas)
    _close_one_rounding(got, twin)


def test_paged_flash_decode_full_width_rows_with_lastlen_le_0():
    """The engine's rows: every row max_pages pages (pads are page 0) and
    last_page_len <= 0 on short rows. The plain version reads only each
    row's keys up to its last: equal to the exact CSR rows."""
    rng = np.random.default_rng(3)
    lengths, ps, Hk, hd, max_pages = [3, 20, 9], 4, 2, 32, 6
    num_pages = 16
    _, q = _pair(rng, (3, 4, hd))
    _, kp = _pair(rng, (num_pages, ps, Hk, hd))
    _, vp = _pair(rng, (num_pages, ps, Hk, hd))
    exact = _csr(np.random.default_rng(9), lengths, ps, num_pages)
    wide = _csr(np.random.default_rng(9), lengths, ps, num_pages,
                full_width=max_pages)
    assert (wide[2] <= 0).any()
    a = tdec.paged_flash_decode(q, kp, vp, *map(_t, exact), max_pages)
    b = tdec.paged_flash_decode(q, kp, vp, *map(_t, wide), max_pages)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_paged_flash_decode_table_contract():
    rng = np.random.default_rng(4)
    _, q = _pair(rng, (2, 4, 32))
    _, kp = _pair(rng, (6, 8, 2, 32))
    indptr, indices, lastlen = map(_t, _csr(rng, [8, 16], 8, 6))
    with pytest.raises(ValueError, match="page_indptr carries"):
        tdec.paged_flash_decode(q, kp, kp, indptr[:-1], indices, lastlen, 2)
    with pytest.raises(ValueError, match="last_page_len carries"):
        tdec.paged_flash_decode(q, kp, kp, indptr, indices, lastlen[:1], 2)


# -- paged_flash_prefill --------------------------------------------------------------

PREFILL_CASES = [
    # C, pos0s, extra keys past the segment, ps, Hk, group, hd, window,
    # full width (engine rows: lastlen may be <= 0)
    (8, [0, 5, 24, 40], [0, 0, 0, 0], 8, 2, 3, 32, -1, 0),
    (6, [0, 3, 17, 33], [0, 0, 0, 0], 4, 2, 2, 32, 5, 12),
    (5, [11, 2], [-2, 0], 4, 1, 4, 64, -1, 6),
]


def _prefill_case(case, seed):
    C, pos0s, extra, ps, Hk, group, hd, window, width = case
    rng = np.random.default_rng(seed)
    B, H = len(pos0s), Hk * group
    lengths = [p + C + e for p, e in zip(pos0s, extra)]
    num_pages = sum(-(-n // ps) for n in lengths) + 3
    jq, tq = _pair(rng, (B, C, H, hd))
    jkp, tkp = _pair(rng, (num_pages, ps, Hk, hd))
    jvp, tvp = _pair(rng, (num_pages, ps, Hk, hd))
    csr = _csr(rng, lengths, ps, num_pages, full_width=width)
    max_pages = width or int((csr[0][1:] - csr[0][:-1]).max())
    return (jq, jkp, jvp), (tq, tkp, tvp), csr, np.asarray(pos0s, np.int32), \
        max_pages, window


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_paged_flash_prefill_plain_matches_pallas_and_ref(case):
    (jq, jkp, jvp), (tq, tkp, tvp), csr, pos0, max_pages, window = \
        _prefill_case(case, 5)
    indptr, indices, lastlen = csr
    got = tpre.paged_flash_prefill_plain(tq, tkp, tvp, *map(_t, csr),
                                         _t(pos0), max_pages, window)
    pallas = paged_prefill_attention(jq, jkp, jvp, indptr, indices, lastlen,
                                     pos0, max_pages=max_pages,
                                     window=window)
    twin = jpre_ref.paged_prefill_ref(jq, jkp, jvp, indptr, indices,
                                      lastlen, pos0, max_pages=max_pages,
                                      window=window)
    _close_one_rounding(got, pallas)
    _close_one_rounding(got, twin)
    if case[-1]:
        assert (lastlen <= 0).any() or (np.asarray(case[2]) < 0).any()


def test_paged_flash_prefill_contract_and_scalar_pos0():
    (_, _, _), (q, kp, vp), csr, pos0, max_pages, window = \
        _prefill_case(PREFILL_CASES[2], 6)
    indptr, indices, lastlen = map(_t, csr)
    one = tpre.paged_flash_prefill(q[:1], kp, vp, indptr[:2], indices,
                                   lastlen[:1], int(pos0[0]), max_pages)
    vec = tpre.paged_flash_prefill(q[:1], kp, vp, indptr[:2], indices,
                                   lastlen[:1], _t(pos0[:1]), max_pages)
    torch.testing.assert_close(one, vec, rtol=0, atol=0)
    with pytest.raises(ValueError, match="scalar or a"):
        tpre.paged_flash_prefill(q, kp, vp, indptr, indices, lastlen,
                                 torch.zeros((2, 1), dtype=torch.int32),
                                 max_pages)
    with pytest.raises(ValueError, match="per-row pos0 length"):
        tpre.paged_flash_prefill(q, kp, vp, indptr, indices, lastlen,
                                 torch.zeros(3, dtype=torch.int32), max_pages)
    with pytest.raises(ValueError, match="page_indptr carries"):
        tpre.paged_flash_prefill(q, kp, vp, indptr[:-1], indices, lastlen,
                                 _t(pos0), max_pages)
    with pytest.raises(ValueError, match="last_page_len carries"):
        tpre.paged_flash_prefill(q, kp, vp, indptr, indices, lastlen[:1],
                                 _t(pos0), max_pages)


# -- model functions against the reference's -----------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["scan"]["s0"]["attn"])
    tp = ttf.layer_params(tparams["scan"]["s0"]["attn"], 0)
    return jcfg, jp, reduced(get_config("mixtral-8x7b")), tp


def _pool_pair(rng, cfg, num_pages, ps):
    shape = (num_pages, ps, cfg.num_kv_heads, cfg.head_dim)
    jk, tk = _pair(rng, shape)
    jv, tv = _pair(rng, shape)
    return {"k": jk, "v": jv}, {"k": tk, "v": tv}


def _table(rng, B, max_pages, num_pages):
    perm = rng.permutation(num_pages)[:B * max_pages]
    return perm.reshape(B, max_pages).astype(np.int32)


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_decode_attention_paged_matches_reference(model, active):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(7)
    B, ps, max_pages, N = 3, 4, 5, 18
    jc, tc = _pool_pair(rng, jcfg, N, ps)
    jx, tx = _pair(rng, (B, 1, jcfg.d_model))
    pages = _table(rng, B, max_pages, N)
    pages[1, 3:] = N                           # a short row padded with N
    pos = np.array([13, 9, 19], np.int32)
    jact = None if active is None else jnp.asarray(active)
    tact = None if active is None else torch.tensor(active)
    jo, jn = jattn.decode_attention_paged(jp, jx, jc, jnp.asarray(pos),
                                          jnp.asarray(pages), jcfg,
                                          active=jact)
    to, tn = tattn.decode_attention_paged(tp, tx, tc, _t(pos), _t(pages),
                                          tcfg, active=tact)
    rows = range(B) if active is None else np.nonzero(active)[0]
    for b in rows:
        np.testing.assert_allclose(_f32(to[b]), _f32(jo[b]), **BF16)
    np.testing.assert_allclose(_f32(tn["k"]), _f32(jn["k"]), **BF16)
    np.testing.assert_array_equal(_f32(tn["v"]), _f32(jn["v"]))


def test_segment_attention_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(8)
    B, C, S, pos = 2, 6, 24, 9
    shape = (B, S, jcfg.num_kv_heads, jcfg.head_dim)
    jk, tk = _pair(rng, shape)
    jv, tv = _pair(rng, shape)
    jx, tx = _pair(rng, (B, C, jcfg.d_model))
    positions = pos + np.arange(C)[None]
    jo, jn = jattn.segment_attention(jp, jx, {"k": jk, "v": jv},
                                     jnp.int32(pos), jnp.asarray(positions),
                                     jcfg)
    to, tn = tattn.segment_attention(tp, tx, {"k": tk, "v": tv}, pos,
                                     _t(positions), tcfg)
    np.testing.assert_allclose(_f32(to), _f32(jo), **BF16)
    np.testing.assert_allclose(_f32(tn["k"]), _f32(jn["k"]), **BF16)
    np.testing.assert_array_equal(_f32(tn["v"]), _f32(jn["v"]))


@pytest.mark.parametrize("bounded", [True, False])
def test_segment_attention_paged_matches_reference(model, bounded):
    """With ``write_max`` both sides score through the paged-prefill
    kernel (Pallas in interpret mode; the port's plain version here),
    on rows whose last_page_len is <= 0; without it both gather."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(9)
    B, C, ps, max_pages, N, pos = 1, 8, 4, 6, 10, 8
    wmin, wmax = (10, 13) if bounded else (None, None)
    jc, tc = _pool_pair(rng, jcfg, N, ps)
    jx, tx = _pair(rng, (B, C, jcfg.d_model))
    pages = _table(rng, B, max_pages, N)
    pages[0, 4:] = N
    positions = pos + np.arange(C)[None]
    jo, jn = jattn.segment_attention_paged(
        jp, jx, jc, jnp.int32(pos), jnp.asarray(positions),
        jnp.asarray(pages), jcfg, -1,
        None if wmin is None else jnp.int32(wmin),
        None if wmax is None else jnp.int32(wmax))
    to, tn = tattn.segment_attention_paged(tp, tx, tc, pos, _t(positions),
                                           _t(pages), tcfg, -1, wmin, wmax)
    rows = slice(0, (wmax - pos) if bounded else C)   # rows past wmax: pads
    np.testing.assert_allclose(_f32(to[:, rows]), _f32(jo[:, rows]), **BF16)
    np.testing.assert_allclose(_f32(tn["k"]), _f32(jn["k"]), **BF16)
    np.testing.assert_array_equal(_f32(tn["v"]), _f32(jn["v"]))


# -- inside the port: paged equals dense, bit for bit -----------------------------

def _dense_and_paged(rng, cfg, B, S, ps, N):
    """A dense cache and a pool holding the same KV in permuted pages."""
    max_pages = S // ps
    _, k = _pair(rng, (B, S, cfg.num_kv_heads, cfg.head_dim))
    _, v = _pair(rng, (B, S, cfg.num_kv_heads, cfg.head_dim))
    pages = _table(rng, B, max_pages, N)
    pool = tattn.init_paged_kv_cache(N, ps, cfg.num_kv_heads, cfg.head_dim)
    flat = torch.from_numpy(pages.reshape(-1).astype(np.int64))
    for name, t in (("k", k), ("v", v)):
        pool[name][flat] = t.reshape((B * max_pages, ps) + t.shape[2:])
    return {"k": k, "v": v}, pool, _t(pages)


def test_paged_decode_equals_dense_decode_bitwise(model):
    _, _, tcfg, tp = model
    rng = np.random.default_rng(10)
    dense, pool, pages = _dense_and_paged(rng, tcfg, 3, 16, 4, 14)
    _, x = _pair(rng, (3, 1, tcfg.d_model))
    pos = torch.tensor([0, 7, 15])
    do, dc = tattn.decode_attention(tp, x, dense, pos, tcfg)
    po, pc = tattn.decode_attention_paged(tp, x, pool, pos, pages, tcfg)
    torch.testing.assert_close(po, do, rtol=0, atol=0)
    ps = 4
    for b, p in enumerate(pos.tolist()):
        page = int(pages[b, p // ps])
        torch.testing.assert_close(pc["k"][page, p % ps], dc["k"][b, p],
                                   rtol=0, atol=0)


def test_paged_segment_equals_dense_segment_bitwise(model):
    """Through the paged-prefill kernel's plain version (write bounds
    given) and through the gather path: every prompt row equal to the
    dense segment's row, bit for bit."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(11)
    dense, pool, pages = _dense_and_paged(rng, tcfg, 1, 24, 4, 9)
    _, x = _pair(rng, (1, 8, tcfg.d_model))
    pos, plen = 8, 14
    positions = pos + torch.arange(8)[None]
    do, _ = tattn.segment_attention(
        tp, x, {k: t.clone() for k, t in dense.items()}, pos, positions,
        tcfg)
    for bounds in ((0, plen), (None, None)):
        po, _ = tattn.segment_attention_paged(
            tp, x, {k: t.clone() for k, t in pool.items()}, pos, positions,
            pages, tcfg, -1, *bounds)
        torch.testing.assert_close(po[:, :plen - pos], do[:, :plen - pos],
                                   rtol=0, atol=0)


def test_windowed_decode_past_capacity_raises(model):
    """The kernels mask causality and the window with one position, the
    cache slot; past the capacity the model's two masks differ, so a
    windowed layer refuses it instead of scoring the wrong keys."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(12)
    cache = {"k": _pair(rng, (2, 8, 2, 32))[1],
             "v": _pair(rng, (2, 8, 2, 32))[1]}
    _, x = _pair(rng, (2, 1, tcfg.d_model))
    tattn.decode_attention(tp, x, cache, torch.tensor([3, 9]), tcfg)
    with pytest.raises(ValueError, match="past the KV capacity"):
        tattn.decode_attention(tp, x, cache, torch.tensor([3, 9]), tcfg,
                               window=4)
