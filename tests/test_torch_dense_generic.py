"""The generic serve path on the dense-FFN attention stacks
(``repro_torch.models.prefill`` / ``decode_step``, ``python -m
repro_torch.launch.serve --arch smollm-360m``) against the reference's
``repro.models.model.prefill`` / ``decode_step``, on the reduced configs
(2 layers, d_model 128, 4/2 heads of 32, d_ff 256) with the reference's
weights carried by the bridge:

* ``smollm-360m`` (tied embeddings), and the same with 6/2 heads: the
  published model's GQA group of 3 (15/5 heads);
* ``mistral-nemo-12b``;
* ``qwen2-72b`` with its QKV biases set to seeded non-zero values on the
  reference tree before bridging (zero biases would hide a missing add).

Both sides pad the prefill's KV to the prompt plus the decoded tokens
(the reference's state keeps the prompt's length: a decode step past it
writes the last slot again), then decode 16 greedy tokens.

Tolerances, and why: the last-token logits agree within 2^-5 of their
largest value (2 layers of bf16 matmuls, each within about two bf16
roundings, then the logits product); the prefill KV within 2^-6 of its
largest value (layer 1's carries layer 0's bf16 drift). Greedy decoding
is compared token for token and the agreement printed; a first
divergence must sit at a near tie of the reference's logits, and every
step both sides decoded from the same tokens holds its logits within
2^-5.
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
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(2)

BATCH, PROMPT, STEPS = 2, 40, 16
NEAR_TIE = 0.125                  # as tests/test_torch_serving.py
# (case id, arch, reduced() overrides)
CASES = [("smollm-360m", "smollm-360m", {}),
         ("smollm-gqa3", "smollm-360m", dict(num_heads=6, num_kv_heads=2)),
         ("mistral-nemo-12b", "mistral-nemo-12b", {}),
         ("qwen2-72b", "qwen2-72b", {})]


def _bias(tree, seed=0):
    """Seeded non-zero QKV biases on a reference tree (in place)."""
    rng = np.random.default_rng(seed)
    a = tree["scan"]["s0"]["attn"]
    for name in ("bq", "bk", "bv"):
        a[name] = jnp.asarray(rng.normal(0.0, 0.5, a[name].shape),
                              jnp.bfloat16)
    return tree


def _pad(state, capacity):
    """The reference's prefill state with its KV padded to capacity."""
    kv = state["scan"]["s0"]
    S = kv["k"].shape[2]
    pad = [(0, 0), (0, 0), (0, capacity - S), (0, 0), (0, 0)]
    return {"scan": {"s0": {n: jnp.pad(kv[n], pad) for n in ("k", "v")}},
            "pos": state["pos"]}


def _serve(arch, overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    tcfg = reduced(get_config(arch), **overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        jparams = _bias(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (BATCH, PROMPT))
    cap = PROMPT + STEPS
    jl, jst = jax_prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg)
    tl, tst = models.prefill(tparams, {"tokens": torch.as_tensor(prompt)},
                             tcfg, capacity=cap)
    # the port decodes into its state in place: keep the prefill's copy
    snap = {"scan": {"s0": {n: t.clone()
                            for n, t in tst["scan"]["s0"].items()}},
            "pos": tst["pos"]}
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               prompt=prompt, prefill=(jl, tl), states=(jst, snap))
    jst = _pad(jst, cap)
    jrows, trows, jtoks, ttoks = [], [], [], []
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = tl[:, -1].argmax(-1)[:, None]
    for _ in range(STEPS):
        jtoks.append(np.asarray(jt)[:, 0])
        ttoks.append(tt[:, 0].numpy())
        jl, jst = jax_decode_step(jparams, jst, {"tokens": jt}, jcfg)
        tl, tst = models.decode_step(tparams, tst, {"tokens": tt}, tcfg)
        jrows.append(np.asarray(jl[:, 0], np.float32))
        trows.append(tl[:, 0].float().numpy())
        jt = jnp.argmax(jl[:, 0], -1)[:, None].astype(jnp.int32)
        tt = tl[:, 0].argmax(-1)[:, None]
    out.update(jtoks=np.stack(jtoks, 1), ttoks=np.stack(ttoks, 1),
               jrows=jrows, trows=trows, final=(jst, tst))
    return out


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def runs(request):
    _, arch, overrides = request.param
    return _serve(arch, overrides)


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"
    return err, tol


def test_stack_is_dense_and_params_match_reference(runs):
    tcfg, jparams, tparams = runs["tcfg"], runs["jparams"], runs["tparams"]
    assert transformer.stack_kind(tcfg) == "dense"
    own = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    for tree in (own, tparams):
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), tree)
        assert got == want
    assert ("bq" in own["scan"]["s0"]["attn"]) == tcfg.qkv_bias
    assert ("lm_head" in own) == (not tcfg.tie_embeddings)


def test_prefill_logits_and_kv_match_reference(runs):
    jl, tl = runs["prefill"]
    assert tuple(tl.shape) == jl.shape == (BATCH, 1, runs["tcfg"].vocab_size)
    err, tol = _close(tl, jl, 2 ** -5, "last-token logits")
    print(f"\n{runs['tcfg'].name}: prefill logits max abs err {err:.4g} "
          f"(tolerance {tol:.4g})")
    jst, tst = runs["states"]
    for name in ("k", "v"):
        j, t = jst["scan"]["s0"][name], tst["scan"]["s0"][name]
        assert tuple(t.shape[:2]) + tuple(t.shape[3:]) \
            == j.shape[:2] + j.shape[3:]
        assert t.shape[2] == PROMPT + STEPS and j.shape[2] == PROMPT
        _close(t[:, :, :PROMPT], j, 2 ** -6, f"prefill {name}")
        assert not t[:, :, PROMPT:].any()
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT


def test_greedy_decode_matches_reference(runs):
    jt, tt = runs["jtoks"], runs["ttoks"]
    same = int((jt == tt).sum())
    print(f"\n{runs['tcfg'].name}: greedy token agreement {same}/{jt.size} "
          f"= {same / jt.size:.4f}")
    first = STEPS
    for b in range(BATCH):
        diff = np.nonzero(jt[b] != tt[b])[0]
        if diff.size:
            s = int(diff[0])
            first = min(first, s)
            row = runs["jrows"][s - 1][b] if s else \
                np.asarray(runs["prefill"][0][b, -1], np.float32)
            gap = float(row[jt[b, s]] - row[tt[b, s]])
            print(f"row {b}: first differing token {s}, reference logit gap "
                  f"{gap:.4f}")
            assert gap <= NEAR_TIE, f"row {b} diverges at {s}, gap {gap}"
    for s in range(first):
        _close(runs["trows"][s], runs["jrows"][s], 2 ** -5,
               f"decode step {s} logits")
    jst, tst = runs["final"]
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + STEPS


def test_prefill_then_decode_equals_longer_prefill(runs):
    """Inside the port: prefill of S+1 tokens against prefill of S tokens
    and one decode step through the flash-decode kernel's plain version:
    within 2^-5 of the largest logit."""
    tcfg, tparams, prompt = runs["tcfg"], runs["tparams"], runs["prompt"]
    toks = torch.as_tensor(prompt)
    long_logits, _ = models.prefill(tparams, {"tokens": toks}, tcfg)
    short_logits, st = models.prefill(tparams, {"tokens": toks[:, :-1]}, tcfg,
                                      capacity=PROMPT)
    step_logits, _ = models.decode_step(tparams, st, {"tokens": toks[:, -1:]},
                                        tcfg)
    _close(step_logits, long_logits.float().numpy(), 2 ** -5,
           "decode after prefill")


def test_state_without_capacity_is_the_references():
    """Without ``capacity`` the prefill state keeps the prompt's length, as
    the reference's does, and a decode step past it writes the last slot
    again on both sides: the step's logits agree within 2^-5."""
    r = _serve("smollm-360m", {})
    tcfg, jcfg = r["tcfg"], r["jcfg"]
    toks = torch.as_tensor(r["prompt"])
    tl, tst = models.prefill(r["tparams"], {"tokens": toks}, tcfg)
    jl, jst = jax_prefill(r["jparams"], {"tokens": jnp.asarray(
        r["prompt"], jnp.int32)}, jcfg)
    assert tuple(tst["scan"]["s0"]["k"].shape) == jst["scan"]["s0"]["k"].shape
    nxt = tl[:, -1].argmax(-1)[:, None]
    tl, _ = models.decode_step(r["tparams"], tst, {"tokens": nxt}, tcfg)
    jl, _ = jax_decode_step(r["jparams"], jst, {"tokens": jnp.asarray(
        nxt.numpy(), jnp.int32)}, jcfg)
    _close(tl, jl, 2 ** -5, "decode past the prompt's capacity")


def test_ffn_apply_matches_reference():
    rng = np.random.default_rng(9)
    D, F = 128, 256
    x = jnp.asarray(rng.standard_normal((3, 5, D)), jnp.bfloat16)
    p = {n: jnp.asarray(rng.standard_normal(s) / np.sqrt(s[0]), jnp.bfloat16)
         for n, s in (("w1", (D, F)), ("w3", (D, F)), ("w2", (F, D)))}
    want = jlayers.ffn_apply(p, x)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    got = tlayers.ffn_apply(tp, params_from_numpy(
        {"x": np.asarray(x)}, "cpu")["x"])
    assert got.dtype == torch.bfloat16
    # every op rounds where the reference's does; XLA may fuse silu's
    # chain in another order: one bf16 rounding of the largest output
    _close(got, want, 2 ** -7, "ffn_apply")


@pytest.mark.parametrize("arch", ["smollm-360m", "mistral-nemo-12b",
                                  "qwen2-72b"])
def test_serve_generic_dense_runs_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt", "12", "--tokens", "6"])
    out = capsys.readouterr().out
    assert f"generic path: {arch}" in out
    assert "generated (2, 6)" in out


def test_moe_stack_refuses_generic_decode():
    """The attention+MoE stack decodes in the collaborative engine."""
    cfg = reduced(get_config("mixtral-8x7b"))
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    st = models.init_state(cfg, 1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="collaborative"):
        models.decode_step(params, st, {"tokens": torch.zeros(
            (1, 1), dtype=torch.long)}, cfg)


def test_dense_segment_equals_prefill(runs):
    """Segment mode runs on the dense stack too: the prompt streamed in
    two segments gives the one-shot prefill's last hidden state."""
    tcfg, tparams, prompt = runs["tcfg"], runs["tparams"], runs["prompt"]
    toks = torch.as_tensor(prompt[:1])
    x, _, _ = transformer.backbone(tparams, toks, tcfg, "prefill")
    st = models.init_state(tcfg, 1, PROMPT, "cpu")
    half = PROMPT // 2
    _, st, _ = transformer.backbone(tparams, toks[:, :half], tcfg,
                                    "segment", state=st)
    xs, st, _ = transformer.backbone(tparams, toks[:, half:], tcfg,
                                     "segment", state=st)
    assert int(st["pos"]) == PROMPT
    _close(xs[:, -1], x[:, -1].float().numpy(), 2 ** -6,
           "segmented vs one-shot prefill")

