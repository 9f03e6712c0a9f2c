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
    tol = 2 ** -7 * want.float().abs().max().item() + 1e-5
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
    assert {k: n for k, n in launches().items() if n} == \
        {"swiglu_gmm": 1, "gmm": 1}
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


# -- the attention kernels -----------------------------------------------------

ATTENTION = ("flash_decode", "paged_flash_decode", "paged_flash_prefill")


def _entry(name):
    from repro_torch.kernels import ALL
    return next(k for k in ALL if k["name"] == name)


def _ragged(name):
    return [spec for label, spec in _entry(name)["cases"]
            if label == "ragged"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ATTENTION)
@pytest.mark.parametrize("which", [0, 1, 2])
def test_attention_kernels_match_plain_on_card(hopper, name, which):
    """The ragged shapes of ``repro_torch.kernels.cases``: S not a multiple
    of the tile, per-row positions, windows, permuted non-contiguous pages,
    rows of unequal length, last_page_len <= 0 (prefill)."""
    entry = _entry(name)
    gen = torch.Generator(device="cuda").manual_seed(which)
    args = entry["inputs"](_ragged(name)[which], gen)
    reset_launches()
    got = entry["wrapper"](*args)
    torch.cuda.synchronize()
    assert launches()[name] == 1
    _close(got, entry["plain"](*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ATTENTION)
def test_attention_wrappers_raise_instead_of_falling_back(hopper, name):
    entry = _entry(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = list(entry["inputs"](_ragged(name)[0], gen))
    bad_dtype = [args[0].float()] + args[1:]
    with pytest.raises(TypeError):
        entry["wrapper"](*bad_dtype)
    k = args[1]
    strided = k.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        entry["wrapper"](*([args[0], strided] + args[2:]))


# -- the SSD scan --------------------------------------------------------------

def _close_pair(got, want):
    """y (bf16): one bf16 rounding of the largest output; h (fp32, never
    rounded): fp32 sums over a chunk in another order, 2^-13 of max|h|."""
    (y, h), (y_want, h_want) = got, want
    _close(y, y_want)
    assert torch.isfinite(h).all()
    tol = 2 ** -13 * h_want.abs().max().item()
    assert (h - h_want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_ssd_scan_matches_plain_on_card(hopper, which):
    """The ragged cases of ``repro_torch.kernels.cases``: a 232-step tail,
    S < chunk, a non-zero incoming state, the reduced widths."""
    entry = _entry("ssd_scan")
    gen = torch.Generator(device="cuda").manual_seed(which)
    args = entry["inputs"](_ragged("ssd_scan")[which], gen)
    reset_launches()
    got = entry["wrapper"](*args)
    torch.cuda.synchronize()
    assert launches()["ssd_scan"] == 1
    _close_pair(got, entry["plain"](*args))


@pytest.mark.gpu
def test_ssd_scan_raises_instead_of_falling_back(hopper):
    entry = _entry("ssd_scan")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A_log, Bm, Cm, h0, chunk = entry["inputs"](
        _ragged("ssd_scan")[2], gen)
    with pytest.raises(TypeError):
        entry["wrapper"](x.float(), dt, A_log, Bm, Cm, h0, chunk)
    strided = Bm.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        entry["wrapper"](x, dt, A_log, strided, Cm, h0, chunk)
    with pytest.raises(ValueError):
        entry["wrapper"](x, dt, A_log.cpu(), Bm, Cm, h0, chunk)
