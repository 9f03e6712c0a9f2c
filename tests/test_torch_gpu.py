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


# -- the copy stream and the host lane ------------------------------------------

def _pinned_tiers(L=2, E=4, D=2048, F=8192, ways=1, seed=11):
    """bf16 tiers on the card over a pinned host tier; each expert matrix
    is 32 MB, so a copy takes long enough for an unordered read to see
    the slot before it lands."""
    from repro_torch.config import CacheConfig
    from repro_torch.core import collaborative as collab
    gen = torch.Generator().manual_seed(seed)
    host = [torch.randn(s, generator=gen).to(torch.bfloat16).pin_memory()
            for s in ((L, E, D, F), (L, E, D, F), (L, E, F, D))]
    ccfg = CacheConfig(num_indexes=L, num_ways=ways, policy="lru")
    return collab.init_tiers(*host, ccfg, num_experts=E, device="cuda"), ccfg


@pytest.mark.gpu
def test_copy_stream_orders_slot_writes_and_reads(hopper):
    """Post-fetch and prefetch write the slots on the copy stream; a read
    issued right after the next probe of the layer equals the host weights
    (what a synchronous copy gives), and a staging read of a slot that the
    same step's post-fetch overwrites sees the old expert."""
    from repro_torch.core import collaborative as collab
    tiers, ccfg = _pinned_tiers()
    assert tiers.copy.stream is not None
    one = lambda e: torch.tensor([[e]], dtype=torch.int32)   # noqa: E731
    # post-fetch of expert 1 into layer 0 (a warm chunk: nothing staged)
    pr = collab.probe(tiers, 0, one(1), ccfg)
    tiers, fetch = collab.commit(tiers, 0, pr, None, ccfg)
    assert fetch.any()
    collab.probe(tiers, 0, one(1), ccfg)            # waits for the copy
    got = [s[0].clone() for s in tiers.slots]
    for g, h in zip(got, tiers.host):
        assert torch.equal(g.cpu(), h[0, 1])
    # prefetch of expert 2 into layer 1, read right after the next probe
    tiers, _, issued, n = collab.prefetch(tiers, 1, one(2), ccfg)
    assert n == 1 and issued.any()
    collab.probe(tiers, 1, one(2), ccfg)
    got = [s[1].clone() for s in tiers.slots]
    for g, h in zip(got, tiers.host):
        assert torch.equal(g.cpu(), h[1, 2])
    # one way: expert 1 resident in layer 0, a step picking 1 and 3 stages
    # 1 from its slot while the post-fetch writes 3 over it
    x = torch.randn((2, tiers.host_w1.shape[2]), device="cuda").to(
        torch.bfloat16)
    top_i = torch.tensor([[1], [3]], dtype=torch.int32)
    pr = collab.probe(tiers, 0, top_i, ccfg)
    assert pr.resident.tolist()[:2] == [True, False]
    y, staged = collab.execute(tiers, 0, x, torch.ones((2, 1),
                                                        device="cuda"),
                               pr, ccfg)
    tiers, _ = collab.commit(tiers, 0, pr, staged, ccfg)
    torch.cuda.synchronize()
    assert torch.equal(staged.w1[0].cpu(), tiers.host_w1[0, 1])
    assert torch.equal(tiers.slot_w1[0].cpu(), tiers.host_w1[0, 3])
    assert torch.isfinite(y.float()).all()


@pytest.mark.gpu
def test_host_lane_round_trip_on_card(hopper):
    """The dispatch buffer's host-lane rows go device->host into pinned
    memory, through the thread pool and back: y on the card, within one
    bf16 rounding of the largest output (2^-6, as chip_smoke's layer
    check) of the device lane's y, the executor ran every miss, and the
    cache state and slots equal the device lane's."""
    from repro_torch import hostexec
    from repro_torch.core import collaborative as collab
    tiers, ccfg = _pinned_tiers(D=512, F=1024, ways=2)
    ref, _ = _pinned_tiers(D=512, F=1024, ways=2)
    ex = hostexec.HostExpertExecutor(*tiers.host, threads=4, fuse_small=1)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(12)
    for _ in range(6):
        layer = int(rng.integers(0, 2))
        top_i = torch.from_numpy(np.stack([rng.choice(4, 2, replace=False)
                                           for _ in range(3)]).astype(
                                               np.int32)).to("cuda")
        top_w = torch.rand((3, 2), generator=gen, device="cuda")
        x = torch.randn((3, 512), generator=gen, device="cuda").to(
            torch.bfloat16)
        pr = collab.probe(tiers, layer, top_i, ccfg)
        misses = int((~pr.resident & (pr.rep_e >= 0)).sum())
        ran = ex.groups
        y, tiers, s = collab.collaborative_moe_offloaded(
            tiers, layer, x, top_i, top_w, ccfg, ex)
        y_ref, ref, s_ref = collab.collaborative_moe(ref, layer, x, top_i,
                                                     top_w, ccfg)
        torch.cuda.synchronize()
        assert y.device.type == "cuda" and s == s_ref
        assert ex.groups - ran == misses
        tol = 2 ** -6 * y_ref.float().abs().max().item()
        assert (y.float() - y_ref.float()).abs().max().item() <= tol
        assert torch.equal(tiers.state.tags, ref.state.tags)
        for a, b in zip(tiers.slots, ref.slots):
            assert torch.equal(a, b)
    assert ex.groups > 0
    ex.close()


# -- the other served models' shapes ------------------------------------------

def _model_cases():
    """(kernel, label) of every ``model:<arch>`` case in
    ``repro_torch.kernels.cases``: phi35-moe's and qwen3-moe's grouped
    expert matmuls and decode attention, the generic dense decode of
    mistral-nemo, smollm (GQA group 3) and qwen2-72b."""
    from repro_torch.kernels import ALL
    return [(k["name"], label) for k in ALL for label, _ in k["cases"]
            if label.startswith("model:")]


@pytest.mark.gpu
@pytest.mark.parametrize("name, label", _model_cases())
def test_kernels_match_plain_at_model_shapes(hopper, name, label):
    """Each kernel at a served model's shape: one launch, within one bf16
    rounding of its plain version (ssd_scan's fp32 state as
    ``_close_pair`` holds it), and bitwise equal to a second launch. The
    hd 256 build of flash_decode (gemma3) and the (hp 64, ds 16) build of
    ssd_scan (jamba) run only at these shapes."""
    entry = _entry(name)
    spec = dict(entry["cases"])[label]
    gen = torch.Generator(device="cuda").manual_seed(13)
    args = entry["inputs"](spec, gen)
    reset_launches()
    got = entry["wrapper"](*args)
    torch.cuda.synchronize()
    assert launches()[name] == 1
    again = entry["wrapper"](*args)
    if isinstance(got, tuple):
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    else:
        assert torch.equal(got, again)
    _close_any(got, entry["plain"](*args))


@pytest.mark.gpu
@pytest.mark.parametrize("pos, window", [([0, 700, 1131], -1),
                                         ([5, 1500, 2047], 1024),
                                         ([40, 1100, 2047], 96)])
def test_flash_decode_head_dim_256_matches_plain(hopper, pos, window):
    """The hd 256 build at ragged per-row positions, with and without a
    window (several splits: 2048 keys), against the plain version."""
    entry = _entry("flash_decode")
    gen = torch.Generator(device="cuda").manual_seed(14)
    spec = dict(B=3, S=2048, pos=pos, window=window, H=8, Hk=4, hd=256)
    args = entry["inputs"](spec, gen)
    reset_launches()
    got = entry["wrapper"](*args)
    torch.cuda.synchronize()
    assert launches()["flash_decode"] == 1
    _close(got, entry["plain"](*args))


@pytest.mark.gpu
def test_head_dim_256_is_built_for_the_dense_cache_only(hopper):
    """flash_decode at hd 256 takes up to 4 query heads a kv head; the paged
    kernels are not built for 256 and raise ValueError before any launch."""
    from repro_torch.kernels.decode_attention import ops as dec
    gen = torch.Generator(device="cuda").manual_seed(15)
    spec = dict(B=1, S=64, pos=[63], window=-1, H=8, Hk=1, hd=256)
    args = _entry("flash_decode")["inputs"](spec, gen)
    reset_launches()
    with pytest.raises(ValueError, match="up to 4 query heads"):
        dec.flash_decode(*args)
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        entry = _entry(name)
        args = list(entry["inputs"](_ragged(name)[0], gen))
        for i in range(3):                   # q, k_pages, v_pages
            args[i] = args[i][..., :32].repeat(*([1] * (args[i].dim() - 1)
                                                 + [8])).contiguous()
        assert args[0].shape[-1] == 256
        with pytest.raises(ValueError, match="head_dim 256 not built"):
            entry["wrapper"](*args)
    assert sum(launches().values()) == 0


# -- the vlm and encoder-decoder stacks' decode step ---------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch, overrides", [
    ("qwen2-vl-7b", {}), ("seamless-m4t-large-v2", dict(num_kv_heads=4))])
def test_front_end_stacks_decode_on_card_as_on_the_cpu(hopper, arch,
                                                       overrides):
    """The reduced qwen2-vl (patches on a grid, M-RoPE) and seamless (frames,
    MHA) with the same weights and inputs: prefill and one decode step on
    the card, its attention through ``flash_decode`` (qwen2-vl once a
    layer, seamless's self- and cross-attention twice), against the CPU's
    plain path. Logits within 2^-5 of the largest (bf16 products that sum
    in other orders, 2 layers deep; as the CPU tests against the
    reference)."""
    from repro_torch import models
    from repro_torch.config import get_config, reduced
    cfg = reduced(get_config(arch), **overrides)
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(16)
    B, S = 2, 40
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, S)))}
    if cfg.family == "vlm":
        P = 16
        pos = torch.arange(S).expand(3, B, S).clone()
        pos[0, :, :P] = 0
        pos[1, :, :P] = torch.arange(P) // 4
        pos[2, :, :P] = torch.arange(P) % 4
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (B, P, cfg.frontend_embed_dim)), dtype=torch.float32).to(
                torch.bfloat16)
        batch["positions"] = pos
    else:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, 24, cfg.frontend_embed_dim)), dtype=torch.float32).to(
                torch.bfloat16)
    nxt = {"tokens": batch["tokens"][:, :1]}
    want = []
    for dev in ("cpu", "cuda"):
        p = _on(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        _, st = models.prefill(p, b, cfg, capacity=S + 1)
        reset_launches()
        logits, st = models.decode_step(p, st, {k: v.to(dev) for k, v
                                                in nxt.items()}, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            per_layer = 2 if cfg.is_encdec else 1
            assert launches()["flash_decode"] == per_layer * cfg.num_layers
            assert int(st["pos"]) == S + 1
        want.append(logits.float().cpu())
    tol = 2 ** -5 * want[0].abs().max().item()
    assert torch.isfinite(want[1]).all()
    assert (want[1] - want[0]).abs().max().item() <= tol


def _on(tree, dev):
    """A parameter tree's copy on ``dev``."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)
