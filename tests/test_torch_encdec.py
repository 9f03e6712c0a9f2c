"""The encoder-decoder stack with its stub audio front end
(``repro_torch.models.encdec``; ``repro_torch.models.prefill`` /
``decode_step`` with ``frames``; ``python -m repro_torch.launch.serve
--arch seamless-m4t-large-v2``) against the reference's
``repro.models.encdec``, on the reduced seamless-m4t-large-v2 config (2
encoder and 2 decoder layers, d_model 128, 4/2 heads of 32, d_ff 256, a
64-wide frame front end) and the same with 4/4 heads (the published
model's MHA), with the reference's weights carried by the bridge. The
inputs, 24 frames and 20 decoder tokens a row, are drawn from a seed with
numpy.

The reference's quirk, pinned here and mirrored: its prefill keeps the
decoder's self-attention KV at the prompt's S slots, so a decode step
writes slot S-1 again (``slot = min(pos, S-1)``). ``capacity=`` widens
that KV in the port, never ``memory_kv``: cross-attention masks no key,
so zero-padded memory keys would enter its softmax.

Tolerances, and why: the encoder memory within 2^-6 of its largest value
(2 layers of bf16 matmuls, each within about two bf16 roundings, then
``enc_norm``); the memory K/V and the cross-attention output within 2^-6
(one bf16 product on a shared input, then a flash scan; a decode row's
through the flash-decode kernel's plain version, one masked softmax
against the reference's one-chunk scan); the decoder's last-token logits
within 2^-5 of their largest value (as ``test_torch_dense_generic.py``),
its hidden states within 2^-5 and its self-attention KV on the same
memory within 2^-6 (from the frames, within 2^-5: layer 1's KV carries
the encoder's drift through layer 0's cross-attention); prefill of
S+1 tokens against prefill of S and a decode step, frames held fixed,
within 2^-4 of the largest logit (as ``chip_smoke.py``). Trees, shapes,
dtypes and positions are exact, the bridge bit for bit. Greedy decoding
over 16 steps is compared token for token and the agreement printed; a
first divergence must sit at a near tie of the reference's logits.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import init_state as jax_init_state  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
BATCH, FRAMES, PROMPT, STEPS = 2, 24, 20, 16
NEAR_TIE = 0.125                  # as tests/test_torch_serving.py
# (case id, reduced() overrides): the reduced GQA 4/2, and MHA as published
CASES = [("gqa", {}), ("mha", dict(num_kv_heads=4))]


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"
    return err, tol


def _shapes(tree):
    return jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]), tree)


def _jshapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


def _widen(state, capacity):
    """The reference's prefill state with its decoder KV (not memory_kv)
    padded to capacity, as ``tests/test_decode_parity.py`` widens it."""
    S = state["kv"]["k"].shape[2]
    pad = [(0, 0), (0, 0), (0, capacity - S), (0, 0), (0, 0)]
    return {"kv": {n: jnp.pad(state["kv"][n], pad) for n in ("k", "v")},
            "memory_kv": state["memory_kv"], "pos": state["pos"]}


def _serve(overrides):
    jcfg = jax_reduced(jax_get_config(ARCH), **overrides)
    tcfg = reduced(get_config(ARCH), **overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tcfg.vocab_size, (BATCH, PROMPT))
    frames = rng.standard_normal(
        (BATCH, FRAMES, tcfg.frontend_embed_dim)).astype(np.float32)
    jframes = jnp.asarray(frames, jnp.bfloat16)
    tframes = torch.as_tensor(frames).to(torch.bfloat16)
    jbatch = {"tokens": jnp.asarray(prompt, jnp.int32), "frames": jframes}
    tbatch = {"tokens": torch.as_tensor(prompt), "frames": tframes}
    cap = PROMPT + STEPS
    jl, jst = jax_prefill(jparams, jbatch, jcfg)
    tl, tst = models.prefill(tparams, tbatch, tcfg, capacity=cap)
    snap = jax.tree.map(lambda t: t.clone(), tst)
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               prompt=prompt, jbatch=jbatch, tbatch=tbatch,
               prefill=(jl, tl), states=(jst, snap))
    jst = _widen(jst, cap)
    jrows, jtoks, ttoks = [], [], []
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = tl[:, -1].argmax(-1)[:, None]
    for _ in range(STEPS):
        jtoks.append(np.asarray(jt)[:, 0])
        ttoks.append(tt[:, 0].numpy())
        jl, jst = jax_decode_step(jparams, jst, {"tokens": jt}, jcfg)
        tl, tst = models.decode_step(tparams, tst, {"tokens": tt}, tcfg)
        jrows.append(np.asarray(jl[:, 0], np.float32))
        jt = jnp.argmax(jl[:, 0], -1)[:, None].astype(jnp.int32)
        tt = tl[:, 0].argmax(-1)[:, None]
    out.update(jtoks=np.stack(jtoks, 1), ttoks=np.stack(ttoks, 1),
               jrows=jrows, final=(jst, tst))
    return out


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def runs(request):
    return _serve(request.param[1])


def test_param_and_state_trees_match_reference(runs):
    tcfg, jparams, tparams = runs["tcfg"], runs["jparams"], runs["tparams"]
    assert transformer.stack_kind(tcfg) == "encdec"
    own = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = _jshapes(jparams)
    assert _shapes(own) == want and _shapes(tparams) == want
    assert set(own) == {"frontend_proj", "embed", "enc", "dec", "enc_norm",
                        "final_norm"}
    zero = models.init_state(tcfg, BATCH, FRAMES, "cpu")
    assert _shapes(zero) == _jshapes(jax_init_state(runs["jcfg"], BATCH,
                                                    FRAMES))
    jst, tst = runs["states"]
    want = _jshapes(jst)
    want["kv"] = {n: ((s[0], s[1], PROMPT + STEPS) + s[3:], d)
                  for n, (s, d) in want["kv"].items()}
    assert _shapes(tst) == want
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-7b"])
def test_bridge_round_trip_is_bitwise(arch):
    """The encoder-decoder tree and the vlm stack's ``frontend_proj`` cross
    the bridge and back bit for bit."""
    cfg = jax_reduced(jax_get_config(arch))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(3)))
    back = params_to_numpy(params_from_numpy(tree, "cpu"),
                           bf16_dtype=ml_dtypes.bfloat16)
    assert "frontend_proj" in back
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_want:
        b = flat_got[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        assert b.tobytes() == a.tobytes(), path


def test_encode_matches_reference(runs):
    jmem = jencdec.encode(runs["jparams"], runs["jbatch"]["frames"],
                          runs["jcfg"], remat=False)
    tmem = encdec.encode(runs["tparams"], runs["tbatch"]["frames"],
                         runs["tcfg"])
    assert tmem.dtype == torch.bfloat16 and tuple(tmem.shape) == jmem.shape
    err, tol = _close(tmem, jmem, 2 ** -6, "encoder memory")
    print(f"\nencode: max abs err {err:.4g} (tolerance {tol:.4g})")


@pytest.mark.parametrize("Sq", [PROMPT, 1])
def test_memory_kv_and_cross_attention_match_reference(runs, Sq):
    """On the same memory and decoder input: the memory K/V, then the
    cross-attention of a prompt (flash scan, unmasked) and of one decode
    row (the flash-decode kernel's plain version, every key visible)."""
    tcfg = runs["tcfg"]
    rng = np.random.default_rng(Sq)
    mem = rng.standard_normal((BATCH, FRAMES, tcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((BATCH, Sq, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], runs["jparams"]["dec"]["cross"])
    tp = transformer.layer_params(runs["tparams"]["dec"]["cross"], 0)
    jkv = jattn.encode_memory_kv(jp, jnp.asarray(mem, jnp.bfloat16),
                                 tcfg.num_kv_heads, tcfg.head_dim)
    tkv = tattn.encode_memory_kv(tp, torch.as_tensor(mem).to(torch.bfloat16),
                                 tcfg.num_kv_heads, tcfg.head_dim)
    for n in ("k", "v"):
        assert tuple(tkv[n].shape) == jkv[n].shape
        _close(tkv[n], jkv[n], 2 ** -6, f"memory {n}")
    want = jattn.cross_attention(jp, jnp.asarray(x, jnp.bfloat16), jkv)
    got = tattn.cross_attention(tp, torch.as_tensor(x).to(torch.bfloat16),
                                tkv)
    err, tol = _close(got, want, 2 ** -6, f"cross-attention, {Sq} rows")
    print(f"\ncross-attention {Sq} rows: max abs err {err:.4g} (tolerance "
          f"{tol:.4g})")


def test_decode_stack_matches_reference(runs):
    """``decode_stack`` prefill on the same encoder memory, then one decode
    step on the prefill's own state, against the reference's."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    jmem = jencdec.encode(runs["jparams"], runs["jbatch"]["frames"], jcfg,
                          remat=False)
    tmem = torch.as_tensor(np.asarray(jmem, np.float32)).to(torch.bfloat16)
    jx, jst = jencdec.decode_stack(runs["jparams"], runs["jbatch"]["tokens"],
                                   jmem, jcfg, "prefill", remat=False)
    tx, tst = encdec.decode_stack(runs["tparams"], runs["tbatch"]["tokens"],
                                  tmem, tcfg, "prefill")
    _close(tx, jx, 2 ** -5, "prefill hidden states")
    for tree in ("kv", "memory_kv"):
        for n in ("k", "v"):
            _close(tst[tree][n], jst[tree][n], 2 ** -6, f"prefill {tree} {n}")
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT
    nxt = np.asarray(runs["prompt"][:, :1])
    jx, jst = jencdec.decode_stack(runs["jparams"], jnp.asarray(nxt, jnp.int32),
                                   None, jcfg, "decode", state=jst)
    tx, tst = encdec.decode_stack(runs["tparams"], torch.as_tensor(nxt), None,
                                  tcfg, "decode", state=tst)
    _close(tx, jx, 2 ** -5, "decode hidden state")
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + 1


def test_prefill_logits_match_reference(runs):
    jl, tl = runs["prefill"]
    assert tuple(tl.shape) == jl.shape == (BATCH, 1, runs["tcfg"].vocab_size)
    err, tol = _close(tl, jl, 2 ** -5, "last-token logits")
    print(f"\nseamless prefill: logits max abs err {err:.4g} (tolerance "
          f"{tol:.4g})")


def test_decoder_kv_keeps_the_prompts_slots_without_capacity(runs):
    """The reference's quirk, on both sides: without ``capacity`` the
    decoder's KV holds S slots, a decode step keeps its shape and writes
    slot S-1 again (the slots before it stay), and the two agree."""
    tcfg, jcfg = runs["tcfg"], runs["jcfg"]
    jl, jst = jax_prefill(runs["jparams"], runs["jbatch"], jcfg)
    tl, tst = models.prefill(runs["tparams"], runs["tbatch"], tcfg)
    L, Hk, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    assert tuple(tst["kv"]["k"].shape) == jst["kv"]["k"].shape \
        == (L, BATCH, PROMPT, Hk, hd)
    before = {n: tst["kv"][n].clone() for n in ("k", "v")}
    jbefore = {n: np.asarray(jst["kv"][n], np.float32) for n in ("k", "v")}
    nxt = tl[:, -1].argmax(-1)[:, None]
    tl, tst = models.decode_step(runs["tparams"], tst, {"tokens": nxt}, tcfg)
    jl, jst = jax_decode_step(runs["jparams"], jst, {
        "tokens": jnp.asarray(nxt.numpy(), jnp.int32)}, jcfg)
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + 1
    for n in ("k", "v"):
        t, j = tst["kv"][n], np.asarray(jst["kv"][n], np.float32)
        assert tuple(t.shape) == j.shape == (L, BATCH, PROMPT, Hk, hd)
        assert torch.equal(t[:, :, :-1], before[n][:, :, :-1])
        assert np.array_equal(j[:, :, :-1], jbefore[n][:, :, :-1])
        assert not torch.equal(t[:, :, -1], before[n][:, :, -1])
        assert not np.array_equal(j[:, :, -1], jbefore[n][:, :, -1])
        _close(t[:, :, -1], j[:, :, -1], 2 ** -6, f"rewritten slot {n}")
    _close(tl, jl, 2 ** -5, "decode step into slot S-1")


def test_capacity_widens_only_the_decoder_kv(runs):
    jst, tst = runs["states"]
    assert tst["kv"]["k"].shape[2] == PROMPT + STEPS
    assert not tst["kv"]["k"][:, :, PROMPT:].any()
    for n in ("k", "v"):
        assert tuple(tst["memory_kv"][n].shape) == jst["memory_kv"][n].shape
        assert tst["memory_kv"][n].shape[2] == FRAMES
        _close(tst["memory_kv"][n], jst["memory_kv"][n], 2 ** -6,
               f"memory_kv {n}")
        # layer 1's KV carries the encoder's drift through layer 0's
        # cross-attention: 2^-5, as the logits
        _close(tst["kv"][n][:, :, :PROMPT], jst["kv"][n], 2 ** -5,
               f"prefill kv {n}")


def test_prefill_then_decode_equals_longer_prefill(runs):
    """Prefill of S+1 decoder tokens against prefill of S and one decode
    step, the frames held fixed (the encoder memory must be the same)."""
    tcfg, tparams, tb = runs["tcfg"], runs["tparams"], runs["tbatch"]
    full, _ = models.prefill(tparams, tb, tcfg)
    _, st = models.prefill(tparams, {"tokens": tb["tokens"][:, :-1],
                                     "frames": tb["frames"]}, tcfg,
                           capacity=PROMPT)
    step, _ = models.decode_step(tparams, st, {"tokens": tb["tokens"][:, -1:]},
                                 tcfg)
    _close(step, full.float().numpy(), 2 ** -4, "decode after prefill")


def test_greedy_decode_matches_reference(runs):
    jt, tt = runs["jtoks"], runs["ttoks"]
    same = int((jt == tt).sum())
    print(f"\nseamless {runs['tcfg'].num_heads}/{runs['tcfg'].num_kv_heads}"
          f" heads: greedy token agreement {same}/{jt.size} = "
          f"{same / jt.size:.4f}")
    for b in range(BATCH):
        diff = np.nonzero(jt[b] != tt[b])[0]
        if diff.size:
            s = int(diff[0])
            row = runs["jrows"][s - 1][b] if s else \
                np.asarray(runs["prefill"][0][b, -1], np.float32)
            gap = float(row[jt[b, s]] - row[tt[b, s]])
            print(f"row {b}: first differing token {s}, reference logit gap "
                  f"{gap:.4f}")
            assert gap <= NEAR_TIE, f"row {b} diverges at {s}, gap {gap}"
    jst, tst = runs["final"]
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + STEPS


def test_decoder_refuses_segment_mode():
    cfg = reduced(get_config(ARCH))
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="segment"):
        encdec.decode_stack(params, torch.zeros((1, 4), dtype=torch.long),
                            None, cfg, "segment")
    with pytest.raises(ValueError, match="encdec"):
        transformer.backbone(params, torch.zeros((1, 4), dtype=torch.long),
                             cfg, "prefill")
