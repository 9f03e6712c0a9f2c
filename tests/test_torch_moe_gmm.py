"""The port's grouped expert matmuls (``repro_torch.kernels.moe_gmm``)
against the reference's (``repro.kernels.moe_gmm``).

On the CPU the wrappers run their plain PyTorch versions; the reference's
``moe_ffn`` / ``grouped_matmul`` run the Pallas kernels in interpret mode
(as ``tests/test_kernels_moe.py`` runs them) and ``ref.py`` gives the jnp
oracles. The shapes are ``test_kernels_moe.py``'s, the ragged
``(8, 64, 96, 160)`` and decode-sized ``(3, 8, 64, 48)`` included.

Tolerances. float32: the same products summed in another order by
another BLAS agree to fp32 rounding of a sum of at most 384 terms (1e-5).
bfloat16: both sides accumulate in fp32 and round once to bf16, so an
output may land one bf16 ulp apart (2^-8 relative) where the fp32 sums
straddle a rounding boundary; ``moe_ffn`` carries such a flip of its
bf16 intermediate into the down-projection (2e-2, as the reference's own
kernel tests).

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.moe_gmm import grouped_matmul as jax_grouped_matmul  # noqa: E402
from repro.kernels.moe_gmm import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.kernels.moe_gmm import ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import moe_gmm as ops  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402

torch.set_num_threads(2)

SHAPES = [
    (1, 128, 128, 128),
    (4, 128, 256, 128),
    (2, 256, 128, 384),
    (8, 64, 96, 160),      # ragged: the reference pads it to 128s
    (3, 8, 64, 48),        # decode-sized capacity
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, dtype, seed):
    """x [G, C, D], w1/w3 [G, D, F], w2 [G, F, D] from numpy, in ``dtype``
    on the JAX side and the same bits on the port's side."""
    G, C, D, F = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((G, C, D)),
            rng.standard_normal((G, D, F)) * 0.1,
            rng.standard_normal((G, D, F)) * 0.1,
            rng.standard_normal((G, F, D)) * 0.1]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [tensor_from_numpy(np.asarray(a)) for a in j]
    return j, t


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_ffn_matches_reference(shape, dtype):
    (jx, jw1, jw3, jw2), (x, w1, w3, w2) = _inputs(shape, dtype, 1)
    got = _np(ops.moe_ffn(x, w1, w3, w2))
    np.testing.assert_allclose(
        got, np.asarray(jax_moe_ffn(jx, jw1, jw3, jw2), np.float32),
        **_tol(dtype))
    np.testing.assert_allclose(
        got, np.asarray(ref.moe_ffn_ref(jx, jw1, jw3, jw2), np.float32),
        **_tol(dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gmm_matches_reference(shape, dtype):
    (jx, jw1, _, _), (x, w1, _, _) = _inputs(shape, dtype, 0)
    got = _np(ops.gmm(x, w1))
    np.testing.assert_allclose(
        got, np.asarray(jax_grouped_matmul(jx, jw1), np.float32),
        **_tol(dtype))
    np.testing.assert_allclose(
        got, np.asarray(ref.gmm_ref(jx, jw1), np.float32), **_tol(dtype))
    assert _np(ops.grouped_matmul(x, w1)).tobytes() == got.tobytes()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_gmm_matches_reference(shape, dtype):
    (jx, jw1, jw3, _), (x, w1, w3, _) = _inputs(shape, dtype, 2)
    got = _np(ops.swiglu_gmm(x, w1, w3))
    np.testing.assert_allclose(
        got, np.asarray(ref.swiglu_gmm_ref(jx, jw1, jw3), np.float32),
        **_tol(dtype))


def test_plain_versions_round_once():
    """The plain versions keep the reference's rounding points: fp32
    accumulation, silu on the fp32 gate, ONE rounding to bf16 at the end
    (within one bf16 ulp of the fp32 result: the silu formulas differ in
    fp32 ulps), and a bf16 intermediate between the two products of
    ``moe_ffn`` (bitwise)."""
    _, (x, w1, w3, w2) = _inputs((2, 8, 64, 48), "bfloat16", 3)
    a = torch.matmul(x.float(), w1.float())
    b = torch.matmul(x.float(), w3.float())
    exact = torch.nn.functional.silu(a) * b
    h = ops.swiglu_gmm_plain(x, w1, w3)
    assert h.dtype == torch.bfloat16
    assert ((h.float() - exact).abs() <= 2 ** -8 * exact.abs()).all()
    y = torch.matmul(h.float(), w2.float()).to(torch.bfloat16)
    assert torch.equal(ops.moe_ffn(x, w1, w3, w2), y)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    _, (x, w1, w3, w2) = _inputs((3, 8, 64, 48), "bfloat16", 4)
    reset_launches()
    ops.moe_ffn(x, w1, w3, w2)
    assert launches() == {"swiglu_gmm": 0, "gmm": 0}


@pytest.mark.parametrize("case", ["rank", "groups", "depth", "dtype",
                                  "device"])
def test_wrappers_reject_what_the_kernel_does_not_take(case):
    _, (x, w1, w3, _) = _inputs((3, 8, 64, 48), "float32", 5)
    if case == "rank":
        args, err = (x[0], w1), ValueError
    elif case == "groups":
        args, err = (x, w1[:2]), ValueError
    elif case == "depth":
        args, err = (x[:, :, :32], w1), ValueError
    elif case == "dtype":
        args, err = (x, w1.to(torch.bfloat16)), ValueError
    else:   # neither CPU nor CUDA: no plain-version fallback
        args, err = (x.to("meta"), w1.to("meta")), ValueError
    with pytest.raises(err):
        ops.gmm(*args)
    with pytest.raises(err):
        ops.swiglu_gmm(args[0], args[1], args[1])
