"""The port's training loss and its gradients
(``repro_torch.models.loss_fn``) against the reference's
(``jax.value_and_grad(repro.models.loss_fn, has_aux=True)``), on the
reduced configs of every family, with the reference's weights carried by
the bridge and the batch from the port's copy of the synthetic pipeline:

* dense: ``smollm-360m``; MoE: ``mixtral-8x7b`` and ``qwen3-moe-30b-a3b``
  with 16 experts top-8; Mamba2: ``mamba2-370m``; the mixed periods:
  ``jamba-v0.1-52b`` (Mamba/attention with MoE), ``llama4-maverick``
  (interleaved MoE with a shared expert), ``gemma3-4b`` (5:1 windows, the
  softcap, tied embeddings); vlm: ``qwen2-vl-7b`` (patches and M-RoPE
  positions); audio: ``seamless-m4t-large-v2`` (frames, the encoder and
  the decoder's cross-attention).

Two references. The reference's ``loss_fn`` runs its layers inside
``lax.scan`` (its ``jax.checkpoint`` around the scan body), where XLA
fuses elementwise chains and moves rounding points (ROADMAP Queue 3):
at the first step the compiled loss routes some tokens to other experts
than the same ``_apply_layer`` calls run one by one, which at the train
capacity factor of 1.25 also changes which tokens drop. So every case is
also held to the reference's layer-by-layer loss (:func:`_eager_loss`:
its ``_apply_layer`` in train mode, then ``_xent_chunked``), and the
experts each MoE layer chose are compared with it first. The MoE
families' gradients are held to that reference only; the routing-free
families' to both. On jamba the port and even the layer-by-layer
reference flip a near-tied routing in a later MoE layer (a 1-ulp
difference of an expert product), after which the two backward passes
run through other experts: its gradients are held layer by layer
(:func:`test_layer_vjp_on_the_references_input`), each layer on the
reference's own input, where the experts must match exactly, as
``test_torch_mixed_periods.py`` holds its prefill.

Tolerances (each case prints its largest errors): the loss and xent
within 2^-8 of the compiled reference's (relative) and 2^-10 of the
layer-by-layer one's; aux within 2^-6 of the compiled (its routing
differs) and 2^-10 of the layer-by-layer one; every gradient leaf within
2^-5 of its largest value against the layer-by-layer reference (bf16
gradients through 2-16 layers: 0.5-2.4% is measured), and within
2^-4 against the compiled one where no routing can flip; each layer on
the reference's input within 2^-6 of its largest value, its gradients
within 2^-5. The flash backward against the reference's ``_flash_bwd``
within one bf16 rounding (2^-7 of the largest value), the forward's
log-sum-exp within 2^-20.
"""
import dataclasses
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import kernels, models  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(2)

# 80 tokens: past the vlm stub's 64 patches, a ragged tail for the reduced
# Mamba chunk of 64, and past gemma3's reduced window of 64
BATCH, SEQ = 2, 80
LOSS_REL, LOSS_EAGER_REL = 2 ** -8, 2 ** -10
AUX_REL = 2 ** -6
GRAD_REL, GRAD_COMPILED_REL = 2 ** -5, 2 ** -4
LAYER_REL = 2 ** -6
TOP8 = "top8"
# (case id, arch, override)
CASES = [("smollm", "smollm-360m", None), ("mixtral", "mixtral-8x7b", None),
         ("qwen3-moe-top8", "qwen3-moe-30b-a3b", TOP8),
         ("mamba2", "mamba2-370m", None), ("jamba", "jamba-v0.1-52b", None),
         ("llama4", "llama4-maverick-400b-a17b", None),
         ("gemma3", "gemma3-4b", None), ("qwen2-vl", "qwen2-vl-7b", None),
         ("seamless", "seamless-m4t-large-v2", None)]
# where the port's routing parts from the layer-by-layer reference's at a
# near tie (test_moe_routing_against_layer_by_layer_reference): held layer
# by layer for their gradients (module docstring)
LAYERWISE = ("qwen3-moe-top8", "jamba", "llama4")
NEAR_TIE = 2 ** -8


def _cfg(get, reduce, arch, override):
    cfg = get(arch)
    if override != TOP8:
        return reduce(cfg)
    return reduce(cfg, moe=dataclasses.replace(cfg.moe, num_experts=16,
                                               top_k=8, d_ff=128))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _order(cfg):
    slots, G, R = jt.build_slots(cfg)
    return [("scan", f"s{j}", g, s) for g in range(G)
            for j, s in enumerate(slots)] + \
        [("rem", f"r{j}", None, slots[j % len(slots)]) for j in range(R)]


def _at(p, tree, key, g):
    lp = p[tree][key]
    return lp if g is None else jax.tree.map(lambda a: a[g], lp)


def _eager_loss(p, batch, cfg):
    """The reference's loss with its layers run one by one: its
    ``_apply_layer`` in train mode (the encoder-decoder's layer bodies
    and ``_dec_layer``), then its ``_xent_chunked``."""
    if cfg.is_encdec:
        x = (batch["frames"] @ p["frontend_proj"]).astype(jnp.bfloat16)
        pos = jnp.arange(x.shape[1])[None]
        for l in range(cfg.encoder_layers):
            lp = jax.tree.map(lambda a: a[l], p["enc"])
            h = jt.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            x = x + ja.self_attention(lp["attn"], h, pos, cfg, causal=False)
            h = jt.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + jt.ffn_apply(lp["ffn"], h)
        mem = jt.rmsnorm(p["enc_norm"], x, cfg.norm_eps)
        x = jt.embed_lookup(p["embed"], batch["tokens"]).astype(jnp.bfloat16)
        pos = jnp.arange(x.shape[1])[None]
        for l in range(cfg.num_layers):
            lp = jax.tree.map(lambda a: a[l], p["dec"])
            mkv = ja.encode_memory_kv(lp["cross"], mem, cfg.num_kv_heads,
                                      cfg.head_dim)
            x, _ = je._dec_layer(lp, x, pos, cfg, "train", None, None, mkv)
        aux = jnp.zeros((), jnp.float32)
    else:
        x = jt._embed_inputs(p, batch, cfg)
        positions = jt._positions(batch, cfg, x.shape[1], x.shape[0])
        aux = jnp.zeros((), jnp.float32)
        for tree, key, g, slot in _order(cfg):
            x, _, a, _ = jt._apply_layer(_at(p, tree, key, g), x, slot, cfg,
                                         positions, "train", None, None)
            aux = aux + a
    x = jt.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    xent = jm._xent_chunked(p, x, batch["labels"], cfg)
    coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0
    return xent + coef * aux, {"xent": xent, "aux": aux}


def _port_loss_and_grads(tparams, tbatch, tcfg):
    names = [n for n, _ in _leaves(tparams)]
    leaves = [t for _, t in _leaves(tparams)]
    for t in leaves:
        t.requires_grad_(True)
    loss, parts = models.loss_fn(tparams, tbatch, tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in parts.items()},
            dict(zip(names, grads)))


def _routes(mod, run):
    """The experts every MoE layer chose in ``run()``: ``mod.route``
    recorded, (top-k ids, router probs) in call order."""
    seen = []
    orig = mod.route

    def rec(w, x, k):
        probs, top_i, top_w = orig(w, x, k)
        seen.append((np.asarray(top_i), _np(probs)))
        return probs, top_i, top_w
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "route", rec)
        run()
    return seen


@pytest.fixture
def runs(request):
    """One case's references and port run (``request.param`` a case id:
    the tests parametrise it indirectly), computed once a process."""
    return _case(request.param)


@functools.lru_cache(maxsize=None)
def _case(case_id):
    case, arch, override = next(c for c in CASES if c[0] == case_id)
    jcfg = _cfg(jax_get_config, jax_reduced, arch, override)
    tcfg = _cfg(get_config, reduced, arch, override)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = SyntheticLM(tcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                        seed=0).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = dict(case=case, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
               tparams=tparams, jbatch=jbatch, tbatch=tbatch)
    for name, fn in (("compiled", jax_loss_fn), ("eager", _eager_loss)):
        (loss, parts), grads = jax.value_and_grad(
            lambda p: fn(p, jbatch, jcfg), has_aux=True)(jparams)
        out[name] = (float(loss), {k: float(v) for k, v in parts.items()},
                     dict(_leaves(jax.tree.map(np.asarray, grads))))
    out["port"] = _port_loss_and_grads(tparams, tbatch, tcfg)
    if jcfg.moe is not None:
        out["routes"] = (
            _routes(jmoe, lambda: _eager_loss(jparams, jbatch, jcfg)),
            _routes(tmoe, lambda: models.loss_fn(tparams, tbatch, tcfg,
                                                 remat=False)))
        out["flip"] = _first_flip(*out["routes"])
    return out


ALL_IDS = [c[0] for c in CASES]
MOE_IDS = ["mixtral", "qwen3-moe-top8", "jamba", "llama4"]
MIXED_IDS = ["jamba", "llama4", "gemma3"]


@pytest.mark.parametrize("runs", ALL_IDS, indirect=True)
def test_loss_matches_reference(runs):
    tl, tparts, _ = runs["port"]
    # past a routing flip the layer-by-layer reference is no closer than
    # the compiled one
    eager_rel = LOSS_REL if runs.get("flip") else LOSS_EAGER_REL
    eager_aux = AUX_REL if runs.get("flip") else LOSS_EAGER_REL
    for ref, rel, aux_rel in (("compiled", LOSS_REL, AUX_REL),
                              ("eager", eager_rel, eager_aux)):
        jl, jparts, _ = runs[ref]
        errs = {"loss": abs(tl - jl) / abs(jl),
                "xent": abs(tparts["xent"] - jparts["xent"]) /
                abs(jparts["xent"]),
                "aux": abs(tparts["aux"] - jparts["aux"]) /
                max(abs(jparts["aux"]), 1e-30)}
        print(f"[{runs['case']}] vs {ref}: loss {tl:.6f} against {jl:.6f}, "
              + ", ".join(f"{k} rel err {v:.3g}" for k, v in errs.items()))
        assert errs["loss"] <= rel and errs["xent"] <= rel
        assert errs["aux"] <= aux_rel
        if runs["jcfg"].moe is None:
            assert tparts["aux"] == jparts["aux"] == 0.0


def _first_flip(jroutes, troutes):
    """(layer index, tokens whose top-k set differs) of the first MoE
    layer where the two runs chose other experts, or None."""
    assert len(jroutes) == len(troutes)
    for i, ((ji, _), (ti, _)) in enumerate(zip(jroutes, troutes)):
        diff = np.nonzero((np.sort(ji, -1) != np.sort(ti, -1)).any(-1))[0]
        if diff.size:
            return i, diff
    return None


@pytest.mark.parametrize("runs", MOE_IDS, indirect=True)
def test_moe_routing_against_layer_by_layer_reference(runs):
    """The experts chosen, compared first: every MoE layer's top-k sets
    equal to the layer-by-layer reference's (mixtral), or, where they part
    (the LAYERWISE cases), the first layer that differs differs only at
    near-tied tokens (the gap between the k-th and (k+1)-th router
    probability under 2^-8), after which the inputs differ by whole
    experts."""
    jroutes, troutes = runs["routes"]
    flip = runs["flip"]
    print(f"[{runs['case']}] {len(jroutes)} MoE layers; first flip: "
          f"{None if flip is None else (flip[0], flip[1].size)}")
    assert (flip is not None) == (runs["case"] in LAYERWISE)
    if flip is not None:
        layer, tokens = flip
        K = runs["jcfg"].moe.top_k
        probs = np.sort(jroutes[layer][1][tokens], -1)[:, ::-1]
        gaps = probs[:, K - 1] - probs[:, K]
        print(f"[{runs['case']}] layer {layer}: gaps {np.round(gaps, 5)}")
        assert (gaps < NEAR_TIE).all()


@pytest.mark.parametrize("runs", [c for c in ALL_IDS if c not in LAYERWISE],
                         indirect=True)
def test_grads_match_reference(runs):
    _, _, tg = runs["port"]
    dtypes = {n: t.dtype for n, t in _leaves(runs["tparams"])}
    refs = [("eager", GRAD_REL)]
    if runs["jcfg"].moe is None:
        refs.append(("compiled", GRAD_COMPILED_REL))
    for ref, rel in refs:
        jg = runs[ref][2]
        assert set(jg) == set(tg)
        errs = {n: _rel_err(tg[n], jg[n]) for n in jg}
        worst = max(errs, key=errs.get)
        print(f"[{runs['case']}] grads vs {ref}: {len(errs)} leaves, worst "
              f"{worst} {errs[worst]:.4f} (tol {rel:.4f})")
        for n, e in errs.items():
            assert tg[n].dtype == dtypes[n]
            assert e <= rel, f"{n}: rel err {e:.4f} > {rel:.4f}"


@pytest.mark.parametrize("runs", sorted(set(MOE_IDS + MIXED_IDS)),
                         indirect=True)
def test_layer_vjp_on_the_references_input(runs):
    """Each layer of the MoE stacks and the mixed periods on the
    reference's own input to it: the same experts (exactly), the output
    within 2^-6 of its largest value, and the gradients of a seeded
    cotangent (the layer's parameters and its input, with its
    load-balance loss added) within 2^-5."""
    jcfg, tcfg, jp = runs["jcfg"], runs["tcfg"], runs["jparams"]
    x = jt._embed_inputs(jp, runs["jbatch"], jcfg)
    positions = jt._positions(runs["jbatch"], jcfg, SEQ, BATCH)
    tpos = torch.arange(SEQ)[None]
    gen = np.random.default_rng(0)
    worst = (0.0, "")
    for i, (tree, key, g, slot) in enumerate(_order(jcfg)):
        lp = _at(jp, tree, key, g)
        ct = gen.standard_normal(x.shape).astype(np.float32)

        def jf(lp, x):
            y, _, a, _ = jt._apply_layer(lp, x, slot, jcfg, positions,
                                         "train", None, None)
            return jnp.sum(y.astype(jnp.float32) * ct) + a, y
        (_, jy), (jglp, jgx) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(lp, x)
        tlp = params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")
        tx = params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]
        names = [n for n, _ in _leaves(tlp)]
        inputs = [t for _, t in _leaves(tlp)] + [tx]
        jroutes = _routes(jmoe, lambda: jt._apply_layer(
            lp, x, slot, jcfg, positions, "train", None, None))
        troutes = _routes(tmoe, lambda: tt._train_layer(
            tlp, tx, torch.zeros(()), slot, tcfg, tpos))
        assert _first_flip(jroutes, troutes) is None, f"layer {i}"
        for t in inputs:
            t.requires_grad_(True)
        ty, ta = tt._train_layer(tlp, tx, torch.zeros(()), slot, tcfg, tpos)
        obj = (ty.float() * torch.from_numpy(ct)).sum() + ta
        grads = torch.autograd.grad(obj, inputs, allow_unused=True,
                                    materialize_grads=True)
        e = _rel_err(ty, jy)
        assert e <= LAYER_REL, f"layer {i} output: {e:.4f}"
        jgl = dict(_leaves(jax.tree.map(np.asarray, jglp)))
        jgl["x"] = np.asarray(jgx)
        for n, gt in zip(names + ["x"], grads):
            e = _rel_err(gt, jgl[n])
            worst = max(worst, (e, f"layer {i} {n}"))
            assert e <= GRAD_REL, f"layer {i} {n}: {e:.4f}"
        x = jy
    print(f"[{runs['case']}] {len(_order(jcfg))} layers; worst gradient "
          f"{worst[1]} {worst[0]:.4f}")


# -- the flash backward against the reference's _flash_bwd -----------------

# (id, B, Sq, Sk, H, Hk, hd, window, causal)
FLASH = [("causal-gqa2", 2, 64, 64, 4, 2, 32, -1, True),
         ("causal-gqa1", 2, 48, 48, 4, 4, 32, -1, True),
         ("windowed-gqa4", 1, 96, 96, 8, 2, 32, 24, True),
         ("noncausal-cross", 2, 16, 48, 4, 2, 32, -1, False),
         ("past-1024-keys", 1, 2048, 2048, 4, 1, 32, 512, True)]


@pytest.mark.parametrize("spec", FLASH, ids=[f[0] for f in FLASH])
def test_flash_backward_matches_reference(spec):
    _, B, Sq, Sk, H, Hk, hd, window, causal = spec
    rng = np.random.default_rng(1)

    def bf16(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                           jnp.bfloat16)
    q, k, v = bf16(B, Sq, H, hd), bf16(B, Sk, Hk, hd), bf16(B, Sk, Hk, hd)
    do = bf16(B, Sq, H, hd)
    jout, res = ja._flash_fwd(q, k, v, window, causal, 1024)
    jdq, jdk, jdv = ja._flash_bwd(window, causal, 1024, res, do)

    def tt_(a):
        return params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]
    tq, tk, tv = (tt_(a).requires_grad_(True) for a in (q, k, v))
    tout = tattn.flash_attention(tq, tk, tv, window, causal)
    tdq, tdk, tdv = torch.autograd.grad(tout, (tq, tk, tv), tt_(do))
    _, lse = tattn.flash_scan(tq.detach(), tk.detach(), tv.detach(), window,
                              0, None, 1024, causal, with_lse=True)
    assert _rel_err(lse, res[4]) <= 2 ** -20
    errs = {n: _rel_err(t, j) for n, t, j in (
        ("out", tout, jout), ("dq", tdq, jdq), ("dk", tdk, jdk),
        ("dv", tdv, jdv))}
    print(f"[{spec[0]}] " + ", ".join(f"{n} {e:.3g}" for n, e in
                                       errs.items()))
    for n, e in errs.items():
        assert e <= 2 ** -7, f"{n}: {e:.4f}"
    for t, j in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert t.dtype == torch.bfloat16 and t.shape == j.shape


def test_flash_attention_refuses_a_ragged_chunk_past_1024_keys():
    q = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    kv = torch.zeros((1, 1536, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tattn.flash_attention(q, kv, kv)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_gradient_matches_reference(dtype):
    """The gradient of ``silu`` (the SwiGLU gate, Mamba's gate and conv)
    against ``jax.vjp(jax.nn.silu)`` over [-200, 200]: finite everywhere
    (below x = -88, exp(-x) overflows, and differentiating the forward's
    steps would give NaN), within one rounding of x's dtype elsewhere."""
    from repro_torch.models.layers import silu
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.linspace(-200, 200, 4001, dtype=np.float32), dtype)
    g = jnp.asarray(rng.standard_normal(4001).astype(np.float32), dtype)
    _, vjp = jax.vjp(jax.nn.silu, x)
    (want,) = vjp(g)
    tx = params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]
    tx.requires_grad_(True)
    (got,) = torch.autograd.grad(
        silu(tx), tx, params_from_numpy({"g": np.asarray(g)}, "cpu")["g"])
    assert bool(torch.isfinite(got).all())
    rel = 2 ** -7 if dtype == "bfloat16" else 2 ** -20
    np.testing.assert_allclose(_np(got), _np(want), rtol=rel, atol=1e-30)


# -- _xent_chunked's tail quirk ---------------------------------------------

def test_xent_chunked_counts_whole_chunks_only():
    """The reference's quirk, kept: past 512 tokens only ``S // 512 * 512``
    positions count, so a 600-token sequence's last 88 drop out. The
    port's value equals the reference's (within fp32 rounding), equals
    the loss of the first 512 positions, and does not move with the
    tail's labels, on both sides."""
    arch = "smollm-360m"
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 600, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 600)).astype(np.int32)
    other = labels.copy()
    other[:, 512:] = (other[:, 512:] + 1) % tcfg.vocab_size
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]
    want = float(jm._xent_chunked(jp, jx, jnp.asarray(labels), jcfg))
    got = float(tmodel._xent_chunked(tp, tx, torch.as_tensor(labels), tcfg))
    head = float(tmodel._xent_chunked(tp, tx[:, :512],
                                      torch.as_tensor(labels[:, :512]),
                                      tcfg))
    moved = float(tmodel._xent_chunked(tp, tx, torch.as_tensor(other), tcfg))
    jmoved = float(jm._xent_chunked(jp, jx, jnp.asarray(other), jcfg))
    print(f"xent 600 tokens: port {got:.6f}, reference {want:.6f}, first "
          f"512 {head:.6f}")
    assert abs(got - want) <= 2 ** -16 * abs(want)
    assert got == head == moved
    assert jmoved == want


# -- the kernel wrappers refuse autograd ------------------------------------

def _kernel_inputs(name):
    """Tiny CPU inputs of each kernel wrapper of ``kernels.ALL``."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)
    tables = (torch.tensor([0, 2, 4], dtype=torch.int32),
              torch.tensor([0, 1, 2, 3], dtype=torch.int32),
              torch.tensor([8, 8], dtype=torch.int32))
    if name == "swiglu_gmm":
        return (rnd(2, 3, 16), rnd(2, 16, 8), rnd(2, 16, 8)), (0, 1, 2)
    if name == "gmm":
        return (rnd(2, 3, 16), rnd(2, 16, 8)), (0, 1)
    if name == "flash_decode":
        return (rnd(2, 4, 32), rnd(2, 16, 2, 32), rnd(2, 16, 2, 32),
                torch.tensor([5, 9])), (0, 1, 2)
    if name == "paged_flash_decode":
        return (rnd(2, 4, 32), rnd(4, 8, 2, 32), rnd(4, 8, 2, 32),
                *tables, 2), (0, 1, 2)
    if name == "paged_flash_prefill":
        return (rnd(2, 3, 4, 32), rnd(4, 8, 2, 32), rnd(4, 8, 2, 32),
                *tables, torch.tensor([10, 12]), 2), (0, 1, 2)
    if name == "ssd_scan":
        x = rnd(2, 8, 2, 32)
        dt = torch.rand((2, 8, 2), generator=g)
        return (x, dt, torch.zeros(2), rnd(2, 8, 16), rnd(2, 8, 16)), \
            (0, 1, 2, 3, 4)
    raise AssertionError(f"no inputs for kernel {name}")


@pytest.mark.parametrize("entry", kernels.ALL, ids=[k["name"] for k in
                                                    kernels.ALL])
def test_kernel_wrapper_refuses_autograd(entry):
    """Each wrapper raises, naming its kernel, for any input that requires
    grad while grad is enabled, on the CPU too, where it would otherwise
    run its differentiable plain version; with grad disabled, or with no
    input requiring grad (serve mode), it runs."""
    name, wrapper = entry["name"], entry["wrapper"]
    args, float_args = _kernel_inputs(name)
    wrapper(*args)
    for i in float_args:
        a = list(args)
        a[i] = a[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"^{name}: .*no backward"):
            wrapper(*a)
        with torch.no_grad():
            wrapper(*a)


def test_serve_mode_meets_no_guard():
    """Prefill and decode (flash-decode; the Mamba stack's ssd_scan) run
    with grad enabled: no serve-path input requires grad."""
    assert torch.is_grad_enabled()
    for arch in ("smollm-360m", "mamba2-370m"):
        cfg = reduced(get_config(arch))
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        toks = torch.zeros((1, 8), dtype=torch.long)
        logits, st = models.prefill(params, {"tokens": toks}, cfg,
                                    capacity=9)
        models.decode_step(params, st, {"tokens": toks[:, :1]}, cfg)
        assert not logits.requires_grad
