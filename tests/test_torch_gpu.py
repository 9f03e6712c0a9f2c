"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA card of capability (9, 0) (the kernels are built for
``sm_90a``) and skips elsewhere. Imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: the kernel and the plain version form the same products and
round once to bf16, summing in another fp32 order, so outputs agree
within one bf16 rounding of the largest output.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels import moe_gmm as ops

SHAPES = [
    (1, 128, 128, 128),
    (8, 64, 96, 160),      # ragged C, D and F
    (3, 8, 64, 48),        # decode-sized capacity
    (8, 8, 512, 1792),
    (2, 13, 1000, 1000),   # N not a multiple of the 16-byte vector
    (5, 8, 4096, 14336),   # the serving path's widths, 5 unique experts
]


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the sm_90a kernels need a CUDA card of capability "
                    "(9, 0) (Hopper)")


def _inputs(shape, seed):
    G, C, D, F = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((G, C, D)),
            rng.standard_normal((G, D, F)) * 0.02,
            rng.standard_normal((G, D, F)) * 0.02,
            rng.standard_normal((G, F, D)) * 0.02]
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", torch.bfloat16)
            for a in arrs]


def _close(got, want):
    tol = 2 ** -7 * want.float().abs().max().item() + 1e-3
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(hopper, shape):
    x, w1, w3, w2 = _inputs(shape, 6)
    reset_launches()
    h = ops.swiglu_gmm(x, w1, w3)
    y = ops.gmm(h, w2)
    torch.cuda.synchronize()
    assert launches() == {"swiglu_gmm": 1, "gmm": 1}
    _close(h, ops.swiglu_gmm_plain(x, w1, w3))
    _close(y, ops.gmm_plain(h, w2))


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(hopper):
    x, w1, w3, _ = _inputs((2, 8, 64, 48), 7)
    with pytest.raises(TypeError):
        ops.gmm(x.float(), w1.float())
    with pytest.raises(ValueError):
        ops.swiglu_gmm(x, w1.transpose(1, 2).contiguous().transpose(1, 2),
                       w3)
