"""The port's Mamba2 layer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), on the reduced mamba2-370m config
(d_model 128, 8 heads of 32, d_state 32, chunk 64) with the reference's
own weights carried by the bridge, and its A_log, D, dt_bias and norm_w
overwritten with the same seeded values on both sides (the reference
draws them as 0, 1, 0 and 1, behind which a mishandled leaf would hide).

Tolerances, and why:
- the conv's new state is a copy of its input rows: bitwise;
- the conv's output: four fp32 taps in the reference's order, silu, one
  bf16 rounding; the two frameworks' fp32 sigmoid may differ in the last
  bit, so within one bf16 rounding (2^-8 of each value);
- ``ssd_decode_step``: fp32 throughout, 1e-5 relative to the largest
  value (one reordered fp32 sum over ds);
- ``mamba_apply``: bf16 matmuls, conv, scan and the gated RMSNorm round at
  the same points but sum in another order; outputs agree within 2^-6 of
  the largest value (about two bf16 roundings), states within 2^-7 (conv,
  bf16) and 2^-9 (ssd, fp32 state from bf16-rounded inputs).
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
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import (params_from_numpy, tensor_from_numpy,  # noqa: E402
                                tensor_to_numpy)
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

torch.set_num_threads(2)


def perturb(tree, seed=0):
    """Seeded A_log, D, dt_bias and norm_w on a reference param tree (in
    place; returned), so both sides see the same non-trivial values."""
    rng = np.random.default_rng(seed)
    m = tree["scan"]["s0"]["mamba"]
    L, nh = m["A_log"].shape
    new = dict(A_log=rng.normal(0.0, 0.5, (L, nh)),
               D=rng.uniform(0.5, 1.5, (L, nh)),
               dt_bias=rng.normal(0.0, 0.5, (L, nh)),
               norm_w=rng.uniform(0.5, 1.5, m["norm_w"].shape))
    for k, v in new.items():
        m[k] = jnp.asarray(v, jnp.float32)
    return tree


@pytest.fixture(scope="module")
def layer():
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    jparams = perturb(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["scan"]["s0"]["mamba"])
    tp = layer_params(tparams["scan"]["s0"]["mamba"], 0)
    return jcfg, jp, reduced(get_config("mamba2-370m")), tp


def _bf16_pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, tensor_from_numpy(np.asarray(jx), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


def _bits(a):
    """The raw bits of a bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return tensor_to_numpy(a)
    return np.asarray(a).view(np.uint16)


def test_split_proj_matches_reference(layer):
    jcfg, _, tcfg, _ = layer
    s = tcfg.ssm
    di, nh = s.d_inner(tcfg.d_model), s.num_heads(tcfg.d_model)
    width = 2 * di + 2 * s.d_state + nh
    a = np.arange(2 * width, dtype=np.float32).reshape(1, 2, width)
    want = jssm._split_proj(jnp.asarray(a), jcfg.ssm, di, nh)
    got = tssm._split_proj(torch.from_numpy(a), s, di, nh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(layer, with_state):
    jcfg, jp, _, tp = layer
    rng = np.random.default_rng(1 + with_state)
    ci = jp["conv_w"].shape[0]
    jx, tx = _bf16_pair(rng, (2, 9, ci), 2.0)
    js = ts = None
    if with_state:
        js, ts = _bf16_pair(rng, (2, 3, ci), 2.0)
    jw, tw = _bf16_pair(rng, (ci, 4), 0.5)           # a conv_w of scale
    jb, tb = _bf16_pair(rng, (ci,), 0.5)
    jo, jst = jssm._causal_conv(jx, jw, jb, js)
    to, tst = tssm._causal_conv(tx, tw, tb, ts)
    assert to.dtype == torch.bfloat16 and tst.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tst), _bits(jst))
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=2 ** -8, atol=1e-6)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    B, nh, hp, ds = 3, 4, 32, 16
    jx, tx = _bf16_pair(rng, (B, nh, hp))
    dt = np.log1p(np.exp(rng.standard_normal((B, nh)))).astype(np.float32)
    A_log = rng.normal(0, 0.5, nh).astype(np.float32)
    jB, tB = _bf16_pair(rng, (B, ds), 0.3)
    jC, tC = _bf16_pair(rng, (B, ds), 0.3)
    state = rng.standard_normal((B, nh, ds, hp)).astype(np.float32)
    jy, jst = jssm.ssd_decode_step(jx, jnp.asarray(dt), jnp.asarray(A_log),
                                   jB, jC, jnp.asarray(state))
    ty, tst = tssm.ssd_decode_step(tx, torch.from_numpy(dt),
                                   torch.from_numpy(A_log), tB, tC,
                                   torch.from_numpy(state))
    assert ty.dtype == torch.bfloat16 and tst.dtype == torch.float32
    _close(tst, jst, 1e-5, "state")
    _close(ty, jy, 2 ** -7, "y")


def test_init_ssm_state_matches_reference(layer):
    jcfg, _, tcfg, _ = layer
    want = jssm.init_ssm_state(jcfg, 3)
    got = tssm.init_ssm_state(tcfg, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert not got[k].any(), k


@pytest.mark.parametrize("S", [1, 70, 150])
def test_mamba_apply_prefill_matches_reference(layer, S):
    """Prefill from a zero state, as the backbone runs it: S < chunk,
    S = a chunk plus a tail, several chunks with a tail."""
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(S)
    jx, tx = _bf16_pair(rng, (2, S, tcfg.d_model))
    jy, jst = jssm.mamba_apply(jp, jx, jcfg, jssm.init_ssm_state(jcfg, 2))
    ty, tst = tssm.mamba_apply(tp, tx, tcfg, tssm.init_ssm_state(tcfg, 2))
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == jy.shape
    _close(ty, jy, 2 ** -6, "y")
    _close(tst["conv"], jst["conv"], 2 ** -7, "conv state")
    _close(tst["ssd"], jst["ssd"], 2 ** -9, "ssd state")


def test_mamba_apply_without_state_returns_none(layer):
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(11)
    jx, tx = _bf16_pair(rng, (1, 20, tcfg.d_model))
    jy, jst = jssm.mamba_apply(jp, jx, jcfg)
    ty, tst = tssm.mamba_apply(tp, tx, tcfg)
    assert jst is None and tst is None
    _close(ty, jy, 2 ** -6, "y")


def test_mamba_apply_decode_matches_reference(layer):
    """A decode step from a random state (conv rows in bf16, ssd in fp32)."""
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(12)
    jx, tx = _bf16_pair(rng, (3, 1, tcfg.d_model))
    st = jssm.init_ssm_state(jcfg, 3)
    jconv, tconv = _bf16_pair(rng, st["conv"].shape)
    ssd = (rng.standard_normal(st["ssd"].shape) * 0.3).astype(np.float32)
    jy, jst = jssm.mamba_apply(jp, jx, jcfg,
                               {"conv": jconv, "ssd": jnp.asarray(ssd)},
                               decode=True)
    ty, tst = tssm.mamba_apply(tp, tx, tcfg,
                               {"conv": tconv, "ssd": torch.from_numpy(ssd)},
                               decode=True)
    _close(ty, jy, 2 ** -6, "y")
    _close(tst["conv"], jst["conv"], 2 ** -7, "conv state")
    _close(tst["ssd"], jst["ssd"], 2 ** -9, "ssd state")
    with pytest.raises(ValueError):
        tssm.mamba_apply(tp, tx.expand(3, 2, -1), tcfg, tst, decode=True)
