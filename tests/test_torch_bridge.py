"""The weight bridge (``repro_torch.bridge``) and the port's seeded
``init_params``, against the reference's parameter tree on the reduced
Mixtral and the reduced mamba2-370m.

Exact: the round trip reference -> port -> numpy keeps every leaf's bits,
dtype and shape (bf16 leaves included, which numpy only holds as
``ml_dtypes.bfloat16``). ``init_params`` cannot reproduce ``jax.random``'s
bits; it must give the same tree, shapes and dtypes, and each leaf's
spread must match ``_dense_init``'s 1/sqrt(fan_in) within sampling error
(a few percent on the leaves' thousands of draws).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import (params_from_numpy, params_to_numpy,  # noqa: E402
                                tensor_from_numpy, tensor_to_numpy)
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference_tree():
    cfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    return jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_round_trip_is_bitwise(reference_tree):
    params = params_from_numpy(reference_tree, "cpu")
    back = params_to_numpy(params, bf16_dtype=ml_dtypes.bfloat16)
    ref = dict(_leaves(reference_tree))
    got = dict(_leaves(back))
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        b = got[name]
        assert b.dtype == a.dtype, name
        assert b.shape == a.shape, name
        assert b.tobytes() == a.tobytes(), name


def test_layout_and_dtypes(reference_tree):
    params = params_from_numpy(reference_tree, "cpu")
    cfg = reduced(get_config("mixtral-8x7b"))
    moe = params["scan"]["s0"]["moe"]
    L, E, D, F = cfg.num_layers, cfg.moe.num_experts, cfg.d_model, \
        cfg.moe.d_ff
    assert tuple(moe["w1"].shape) == (L, E, D, F)
    assert tuple(moe["w2"].shape) == (L, E, F, D)
    assert moe["w1"].dtype == torch.bfloat16
    assert moe["router"].dtype == torch.float32
    assert params["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, np.int32, ml_dtypes.bfloat16])
def test_tensor_round_trip(dtype):
    a = (np.random.default_rng(0).standard_normal((3, 5)) * 7).astype(dtype)
    t = tensor_from_numpy(a, "cpu")
    b = tensor_to_numpy(t, bf16_dtype=ml_dtypes.bfloat16)
    assert b.dtype == a.dtype and b.tobytes() == a.tobytes()
    # the port's tensor owns its memory: writing the source changes nothing
    a[0, 0] = 0
    assert tensor_to_numpy(t, ml_dtypes.bfloat16)[0, 0] == b[0, 0]


def test_init_params_matches_reference_tree(reference_tree):
    cfg = reduced(get_config("mixtral-8x7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = dict(_leaves(params_to_numpy(params, ml_dtypes.bfloat16)))
    ref = dict(_leaves(reference_tree))
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        b = got[name]
        assert (b.shape, b.dtype) == (a.shape, a.dtype), name
        sa, sb = np.std(a.astype(np.float32)), np.std(b.astype(np.float32))
        if sa == 0:
            assert np.array_equal(a, b), name       # the norms' ones
        else:
            assert abs(sb / sa - 1) < 0.08, (name, sa, sb)


def test_init_params_is_seeded():
    cfg = reduced(get_config("mixtral-8x7b"), num_layers=1)
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    for (_, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y)
    assert not torch.equal(a["scan"]["s0"]["moe"]["w1"],
                           c["scan"]["s0"]["moe"]["w1"])


@pytest.fixture(scope="module")
def mamba_tree():
    cfg = jax_reduced(jax_get_config("mamba2-370m"))
    return jax.tree.map(np.asarray,
                        jax_init_params(cfg, jax.random.PRNGKey(0)))


def test_mamba_round_trip_is_bitwise(mamba_tree):
    """The Mamba tree crosses unchanged: bf16 leaves (in_proj, conv_w,
    conv_b, out_proj, embed) as uint16 bits, A_log, D, dt_bias and norm_w
    as fp32, every leaf on the compute device (no host tier)."""
    params = params_from_numpy(mamba_tree, "cpu")
    m = params["scan"]["s0"]["mamba"]
    for k in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert m[k].dtype == torch.bfloat16, k
    for k in ("A_log", "D", "dt_bias", "norm_w"):
        assert m[k].dtype == torch.float32, k
    back = dict(_leaves(params_to_numpy(params, ml_dtypes.bfloat16)))
    ref = dict(_leaves(mamba_tree))
    assert sorted(back) == sorted(ref)
    for name, a in ref.items():
        b = back[name]
        assert (b.dtype, b.shape) == (a.dtype, a.shape), name
        assert b.tobytes() == a.tobytes(), name


def test_mamba_init_params_matches_reference_tree(mamba_tree):
    """Same leaves, shapes and dtypes; each leaf's spread within sampling
    error of the reference's (conv_w normal x 0.1, in_proj / out_proj
    normal / sqrt(fan_in)); the constant leaves equal (A_log, dt_bias and
    conv_b zero, D and norm_w one); no ln2 and no lm_head (tied)."""
    cfg = reduced(get_config("mamba2-370m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = dict(_leaves(params_to_numpy(params, ml_dtypes.bfloat16)))
    ref = dict(_leaves(mamba_tree))
    assert sorted(got) == sorted(ref)
    assert "lm_head" not in got and "scan/s0/ln2" not in got
    for name, a in ref.items():
        b = got[name]
        assert (b.shape, b.dtype) == (a.shape, a.dtype), name
        sa, sb = np.std(a.astype(np.float32)), np.std(b.astype(np.float32))
        if sa == 0:
            assert np.array_equal(a, b), name
        else:
            assert abs(sb / sa - 1) < 0.08, (name, sa, sb)
