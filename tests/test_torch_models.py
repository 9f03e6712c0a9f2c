"""The port's model functions against the reference's, on the reduced
Mixtral with the reference's own weights (carried by the bridge).

Tolerances: fp32-in/fp32-out functions (rope angles, router softmax) agree
to float32 rounding; bf16 outputs agree to one or two bf16 ulps (the two
frameworks round bf16 matmuls and elementwise chains at slightly different
points). Integer outputs (top-k ids) must match exactly.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(2)

BF16 = dict(rtol=2e-2, atol=2e-2)     # ~2 bf16 ulps at unit scale
F32 = dict(rtol=1e-5, atol=1e-5)
# router probabilities move by ~1e-3 under bf16 drift of h2 (D = 128)
ROUTE_TIE = 0.01


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("mixtral-8x7b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, reduced(get_config("mixtral-8x7b")), tparams


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _bf16_pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, tensor_from_numpy(np.asarray(jx))


def test_config_matches_reference(model):
    jcfg, _, tcfg, _ = model
    for name in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                 "head_dim", "vocab_size", "rope_theta", "norm_eps",
                 "window_pattern", "moe_every", "max_seq_len"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for name in ("num_experts", "top_k", "d_ff", "capacity_factor",
                 "serve_capacity_factor"):
        assert getattr(tcfg.moe, name) == getattr(jcfg.moe, name), name
    full_j, full_t = jax_get_config("mixtral-8x7b"), get_config("mixtral-8x7b")
    for name in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                 "head_dim", "vocab_size", "rope_theta"):
        assert getattr(full_t, name) == getattr(full_j, name), name
    assert full_t.moe.d_ff == full_j.moe.d_ff


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    jx, tx = _bf16_pair(rng, (3, 5, 128), 3.0)
    w = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    want = jlayers.rmsnorm(jnp.asarray(w), jx)
    got = tlayers.rmsnorm(torch.from_numpy(w), tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.arange(7)[None] + np.array([[0], [300]])
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    # angles up to ~300 rad: cos/sin of the same f32 angle may differ by a
    # few f32 ulps of the angle between libms
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_route_topk_ids_match_exactly(model):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, jcfg.d_model)).astype(np.float32)
    w = jparams["scan"]["s0"]["moe"]["router"][0]
    jp, ji, jw = jmoe.route(w, jnp.asarray(x), jcfg.moe.top_k)
    tp, ti, tw = tmoe.route(tparams["scan"]["s0"]["moe"]["router"][0],
                            torch.from_numpy(x), tcfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F32)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)


def test_decode_attention_per_row_pos_matches_reference(model):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    B, S = 3, 16
    jx, tx = _bf16_pair(rng, (B, 1, jcfg.d_model))
    shape = (B, S, jcfg.num_kv_heads, jcfg.head_dim)
    jk, tk = _bf16_pair(rng, shape)
    jv, tv = _bf16_pair(rng, shape)
    pos = np.array([0, 5, 15], np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["scan"]["s0"]["attn"])
    tp = ttf.layer_params(tparams["scan"]["s0"]["attn"], 0)
    jo, jc = jattn.decode_attention(jp, jx, {"k": jk, "v": jv},
                                    jnp.asarray(pos), jcfg)
    to, tc = tattn.decode_attention(tp, tx, {"k": tk.clone(),
                                             "v": tv.clone()},
                                    torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(_f32(to), _f32(jo), **BF16)
    np.testing.assert_allclose(_f32(tc["k"]), _f32(jc["k"]), **BF16)
    np.testing.assert_array_equal(_f32(tc["v"]), _f32(jc["v"]))


@pytest.fixture(scope="module")
def prefill(model):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (1, 24)).astype(np.int32)
    jx, jstate, _, jtrace = jtf.backbone(jparams, {"tokens": jnp.asarray(
        tokens)}, jcfg, "prefill", remat=False, want_trace=True)
    jlogits = jtf.lm_logits(jparams, jx, jcfg)
    tx, tstate, ttrace = ttf.backbone(tparams, torch.from_numpy(
        tokens).long(), tcfg, "prefill", want_trace=True)
    tlogits = ttf.lm_logits(tparams, tx, tcfg)
    return (jlogits, jstate, jtrace["scan"]["s0"],
            tlogits, tstate, ttrace["scan"]["s0"])


def test_backbone_prefill_routing_ids_match_exactly(prefill):
    """Top-k ids equal exactly, in order. The one allowance: where the
    reference's own top-k weights are a near tie (two picks within
    ROUTE_TIE of each other, so bf16 drift of h2 may swap their order),
    the SET of picks must still be equal."""
    _, _, jtr, _, _, ttr = prefill
    ji, ti = np.asarray(jtr["top_i"]), ttr["top_i"].numpy()
    jw = np.asarray(jtr["top_w"], np.float32)
    tied = (np.abs(jw[..., :-1] - jw[..., 1:]) < ROUTE_TIE).any(-1)
    np.testing.assert_array_equal(ti[~tied], ji[~tied])
    np.testing.assert_array_equal(np.sort(ti[tied], -1),
                                  np.sort(ji[tied], -1))
    print(f"\nrouting: {int(tied.sum())} near-tied of {tied.size} tokens; "
          f"{int((ti != ji).any(-1).sum())} differ in order")


def test_backbone_prefill_logits_kv_trace_match(prefill):
    jlogits, jstate, jtr, tlogits, tstate, ttr = prefill
    # XLA fuses the reference's layer loop and sums rmsnorm/attention in
    # another order: hidden states drift by bf16 ulps per layer, and the
    # logits (|x| up to ~4, ulp 1/32 there) by a few ulps
    np.testing.assert_allclose(_f32(tlogits), _f32(jlogits), rtol=5e-2,
                               atol=1e-1)
    # KV and h2 of layer 1 carry layer 0's drift: a few bf16 ulps
    drift = dict(rtol=5e-2, atol=5e-2)
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(tstate["scan"]["s0"][name]),
                                   _f32(jstate["scan"]["s0"][name]), **drift)
    assert int(tstate["pos"]) == int(jstate["pos"])
    # renormalised top-k weights under the same drift (sorted, so a
    # near-tied pair that swapped order compares like with like)
    np.testing.assert_allclose(np.sort(_f32(ttr["top_w"]), -1),
                               np.sort(_f32(jtr["top_w"]), -1), atol=2e-2)
    np.testing.assert_allclose(_f32(ttr["h2"]), _f32(jtr["h2"]), **drift)
