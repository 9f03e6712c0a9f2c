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
    S < chunk, a non-zero incoming state, the reduced widths (the chunk
    edges are in ``test_redesigned_kernels_match_plain_on_card``)."""
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


# -- the redesigned kernels: flash_decode and paged_flash_decode (split S),
# paged_flash_prefill (tensor-core tiles split over keys), gmm and swiglu_gmm
# (TMA ring), ssd_scan (chunk-parallel) --------------------------------------

REDESIGNED = ("flash_decode", "paged_flash_decode", "paged_flash_prefill",
              "gmm", "swiglu_gmm", "ssd_scan")

# where each kernel's edge cases start among its ragged cases
_FIRST_EDGE = dict(flash_decode=3, paged_flash_decode=3,
                   paged_flash_prefill=3, gmm=3, swiglu_gmm=3, ssd_scan=4)


def _edge_cases(name):
    """The ragged cases that reach the new kernels' edges (``cases.py``):
    flash_decode's 8 splits of S = 5000 with windows from inside splits and
    a row that ends in split 0; paged_flash_decode's engine rows over 8
    splits, page sizes 12 and 128; paged_flash_prefill's two row tiles on
    ps 12 over 4 splits, ps 128 with windows from inside splits; gmm's and
    swiglu_gmm's C = 13 and 64 at the
    served K and N, a K of 160 (a short last tile), K and N not multiples
    of 8; ssd_scan's single chunk with an incoming state and a last chunk
    of one step."""
    return _ragged(name)[_FIRST_EDGE[name]:]


def _close_any(got, want):
    if isinstance(got, tuple):
        _close_pair(got, want)
    else:
        _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name, which", [
    ("flash_decode", 0), ("paged_flash_decode", 0),
    ("paged_flash_decode", 1), ("paged_flash_decode", 2),
    ("paged_flash_prefill", 0), ("paged_flash_prefill", 1),
    ("gmm", 0), ("gmm", 1), ("gmm", 2), ("gmm", 3),
    ("swiglu_gmm", 0), ("swiglu_gmm", 1), ("swiglu_gmm", 2),
    ("swiglu_gmm", 3), ("ssd_scan", 0), ("ssd_scan", 1)])
def test_redesigned_kernels_match_plain_on_card(hopper, name, which):
    entry = _entry(name)
    gen = torch.Generator(device="cuda").manual_seed(which)
    args = entry["inputs"](_edge_cases(name)[which], gen)
    reset_launches()
    got = entry["wrapper"](*args)
    torch.cuda.synchronize()
    assert launches()[name] == 1
    _close_any(got, entry["plain"](*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", REDESIGNED)
@pytest.mark.parametrize("label", ["served", "long", "ragged"])
def test_redesigned_kernels_are_bitwise_equal_run_to_run(hopper, name, label):
    """No atomics, the attention kernels' splits combined in a fixed order
    and ssd_scan's chunk states summed in chunk order, so two launches on
    the same inputs give the same bits."""
    entry = _entry(name)
    specs = [spec for lbl, spec in entry["cases"] if lbl == label]
    if not specs:
        pytest.skip(f"{name} has no {label} case")
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = entry["inputs"](specs[-1], gen)
    first = entry["wrapper"](*args)
    second = entry["wrapper"](*args)
    torch.cuda.synchronize()
    if not isinstance(first, tuple):
        first, second = (first,), (second,)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _device_kernels(fn):
    """Names of the device kernels one call of fn runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


@pytest.mark.gpu
def test_one_split_runs_one_kernel_and_no_workspace(hopper):
    """At the served attention shape, and for gmm at any shape, the wrapper
    allocates only its output and launches one kernel; a long context runs
    the split kernel and its combine pass."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.moe_gmm import ops as moe
    gen = torch.Generator(device="cuda").manual_seed(9)
    served = dict(_entry("flash_decode")["cases"])["served"]
    att = _entry("flash_decode")["inputs"](served, gen)
    x = torch.randn((8, 8, 14336), generator=gen, device="cuda").bfloat16()
    w = torch.randn((8, 14336, 4096), generator=gen,
                    device="cuda").bfloat16()
    assert dec.decode_splits(4, served["S"], served["H"],
                             served["Hk"])[0] == 1
    for fn in (lambda: dec.flash_decode(*att), lambda: moe.gmm(x, w)):
        fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        fn()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] \
            == before + 1
        assert len(_device_kernels(fn)) == 1
    long = dict(_entry("flash_decode")["cases"])["long"]
    att = _entry("flash_decode")["inputs"](long, gen)
    names = _device_kernels(lambda: dec.flash_decode(*att))
    assert len(names) == 2 and "combine" in names[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["paged_flash_decode",
                                  "paged_flash_prefill"])
def test_paged_one_split_runs_one_kernel_and_no_workspace(hopper, name):
    """At the served shapes (4 decode rows of 8 pages of 16; one 32-token
    segment on an engine row of 8 pages) one split: the wrapper allocates
    only its output and launches one kernel. The long context runs the
    split kernel and its combine pass."""
    entry = _entry(name)
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = dict(entry["cases"])
    args = entry["inputs"](cases["served"], gen)

    def fn():
        return entry["wrapper"](*args)
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == before + 1
    assert len(_device_kernels(fn)) == 1
    long = entry["inputs"](cases["long"], gen)
    names = _device_kernels(lambda: entry["wrapper"](*long))
    assert len(names) == 2 and "combine" in names[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["paged_flash_decode",
                                  "paged_flash_prefill"])
def test_paged_wrappers_raise_value_error_on_unbuilt_head_dim(hopper, name):
    """A head dim the kernels are not built for (96) raises ValueError on
    CUDA tensors, before any launch."""
    entry = _entry(name)
    gen = torch.Generator(device="cuda").manual_seed(12)
    args = list(entry["inputs"](_ragged(name)[0], gen))
    args[0] = args[0][..., :32].repeat_interleave(3, -1).contiguous()
    args[1] = args[1][..., :32].repeat_interleave(3, -1).contiguous()
    args[2] = args[2][..., :32].repeat_interleave(3, -1).contiguous()
    assert args[0].shape[-1] == 96
    reset_launches()
    with pytest.raises(ValueError, match="head_dim 96 not built"):
        entry["wrapper"](*args)
    assert launches()[name] == 0


@pytest.mark.gpu
def test_swiglu_gmm_and_ssd_scan_kernels_and_allocations(hopper):
    """At the served shapes: swiglu_gmm allocates only its output and runs
    one kernel; ssd_scan allocates y, h and its chunk-state workspace and
    runs three kernels (chunk states, the state pass, the chunk outputs)."""
    from repro_torch.kernels.moe_gmm import ops as moe
    from repro_torch.kernels.ssd_scan import ops as ssd
    gen = torch.Generator(device="cuda").manual_seed(10)
    moe_args = _entry("swiglu_gmm")["inputs"](
        dict(_entry("swiglu_gmm")["cases"])["served"], gen)
    ssd_args = _entry("ssd_scan")["inputs"](
        dict(_entry("ssd_scan")["cases"])["served"], gen)
    for fn, allocs, kernels, marks in (
            (lambda: moe.swiglu_gmm(*moe_args), 1, 1, ("gmm_tma_kernel",)),
            (lambda: ssd.ssd_scan(*ssd_args), 3, 3,
             ("chunk_state_kernel", "state_pass_kernel",
              "chunk_output_kernel"))):
        fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        fn()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] \
            == before + allocs
        names = _device_kernels(fn)
        assert len(names) == kernels
        assert all(m in n for m, n in zip(marks, names))
