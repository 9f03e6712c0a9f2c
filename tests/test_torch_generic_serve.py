"""The generic serve path of the port (``repro_torch.models.prefill`` /
``decode_step``, ``python -m repro_torch.launch.serve --arch mamba2-370m``)
against the reference's, on the reduced mamba2-370m config (2 layers,
d_model 128) with the reference's weights carried by the bridge and
A_log, D, dt_bias and norm_w perturbed alike on both sides.

Tolerances, and why: the last-token logits agree within 2^-5 of their
largest value (2 layers of bf16 matmuls and scans, each within about two
bf16 roundings, then the tied-embedding product). Layer 0 sees the same
embeddings on both sides: its ``conv`` state is a copy of the first
``in_proj`` output rows and matches bit for bit, its ``ssd`` state is
fp32 sums in another order, within 2^-12 of its largest value. Layer 1's
inputs carry layer 0's output in bf16, where a rounding that falls the
other way moves an element by 2^-8; its state sums many such elements,
so the whole state is held within 2^-6 (``conv``, bf16 rows) and 2^-5
(``ssd``) of its largest value.
Greedy decoding is compared token for token and the agreement printed; a
first divergence must sit at a near tie of the reference's logits.
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
from repro.models import init_state as jax_init_state  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving import build  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(2)

BATCH, PROMPT, STEPS = 2, 150, 16       # a 64-token chunk twice plus a tail
NEAR_TIE = 0.05                          # logit gap a bf16 drift can flip


def perturb(tree, seed=0):
    """Seeded A_log, D, dt_bias and norm_w on a reference param tree (in
    place; returned), as ``tests/test_torch_ssm.py`` does."""
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
def runs():
    """Prefill, then 16 greedy decode steps, on both sides."""
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    tcfg = reduced(get_config("mamba2-370m"))
    jparams = perturb(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (BATCH, PROMPT))
    jl, jst = jax_prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg)
    tl, tst = models.prefill(tparams, {"tokens": torch.as_tensor(prompt)},
                             tcfg)
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               prompt=prompt, prefill=(jl, tl), states=(jst, tst))
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


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


def _states_close(jst, tst, what):
    j, t = jst["scan"]["s0"], tst["scan"]["s0"]
    for leaf, rel in (("conv", 2 ** -6), ("ssd", 2 ** -5)):
        assert tuple(t[leaf].shape) == j[leaf].shape, leaf
        assert str(t[leaf].dtype).split(".")[-1] == str(j[leaf].dtype), leaf
        _close(t[leaf], j[leaf], rel, f"{what}: state {leaf}")
    np.testing.assert_array_equal(tensor_to_numpy(t["conv"][0]),
                                  np.asarray(j["conv"][0]).view(np.uint16))
    _close(t["ssd"][0], j["ssd"][0], 2 ** -12, f"{what}: layer 0 ssd")


def test_prefill_logits_and_state_match_reference(runs):
    jl, tl = runs["prefill"]
    assert tuple(tl.shape) == jl.shape == (BATCH, 1, runs["tcfg"].vocab_size)
    _close(tl, jl, 2 ** -5, "last-token logits")
    jst, tst = runs["states"]
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT
    _states_close(jst, tst, "prefill")


def test_greedy_decode_matches_reference(runs):
    jt, tt = runs["jtoks"], runs["ttoks"]
    same = int((jt == tt).sum())
    print(f"\ngreedy token agreement: {same}/{jt.size} = {same / jt.size:.4f}")
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
    # the logits of every step both sides decoded from the same tokens
    for s in range(first):
        _close(runs["trows"][s], runs["jrows"][s], 2 ** -5,
               f"decode step {s} logits")
    if first == STEPS:
        jst, tst = runs["final"]
        assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + STEPS
        _states_close(jst, tst, f"{STEPS} decode steps")


def test_prefill_then_decode_equals_longer_prefill(runs):
    """Inside the port: prefill of S+1 tokens against prefill of S tokens
    and one decode step (the kernel's final state and the conv state
    against the recurrence): within 2^-5 of the largest logit."""
    tcfg, tparams, prompt = runs["tcfg"], runs["tparams"], runs["prompt"]
    toks = torch.as_tensor(prompt)
    long_logits, _ = models.prefill(tparams, {"tokens": toks}, tcfg)
    short_logits, st = models.prefill(tparams, {"tokens": toks[:, :-1]}, tcfg)
    step_logits, _ = models.decode_step(tparams, st, {"tokens": toks[:, -1:]},
                                        tcfg)
    _close(step_logits, long_logits.float().numpy(), 2 ** -5,
           "decode after prefill")


def test_init_state_matches_reference(runs):
    """The decode state of ``models.init_state``: the reference's leaves,
    shapes and dtypes (conv [L, B, K-1, ci] bf16, ssd [L, B, nh, ds, hp]
    fp32), all zero."""
    got = models.init_state(runs["tcfg"], 3, 0, "cpu")
    want = jax.tree.map(np.asarray, jax_init_state(runs["jcfg"], 3, 0))
    for k in ("conv", "ssd"):
        t, j = got["scan"]["s0"][k], want["scan"]["s0"][k]
        assert tuple(t.shape) == j.shape, k
        assert str(t.dtype).split(".")[-1] == j.dtype.name, k
        assert not t.any(), k
    assert int(got["pos"]) == 0


def test_serve_generic_path_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", "mamba2-370m", "--device", "cpu", "--batch",
                    "2", "--prompt", "40", "--tokens", "8"])
    out = capsys.readouterr().out
    assert "generic path: mamba2-370m" in out
    assert "generated (2, 8)" in out


def test_serve_generic_path_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "mamba2-370m", "--tokens", "2"])


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_unported_archs_raise(arch, capsys):
    """The vlm and encoder-decoder archs serve on the generic path (the
    CLI and ``init_params`` run without raising); what still raises for
    them is the collaborative engine, which serves homogeneous
    attention+MoE stacks only, as the reference's does."""
    serve_cli.main(["--arch", arch, "--device", "cpu", "--tokens", "2",
                    "--prompt", "4"])
    out = capsys.readouterr().out
    assert f"generic path: {arch}" in out and "generated (1, 2)" in out
    cfg = reduced(get_config(arch))
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "frontend_proj" in params
    with pytest.raises(ValueError, match="homogeneous"):
        build(cfg, params=params, device="cpu")


def test_mamba_stack_refuses_segment_mode(runs):
    tcfg, tparams = runs["tcfg"], runs["tparams"]
    st = models.init_state(tcfg, 1, 0, "cpu")
    with pytest.raises(NotImplementedError, match="attention layers only"):
        transformer.backbone(tparams, torch.zeros((1, 4), dtype=torch.long),
                             tcfg, "segment", state=st)
