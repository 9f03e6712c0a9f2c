"""Multimodal RoPE and the vlm patch front end on the generic serve path
(``repro_torch.models.prefill`` / ``decode_step`` with ``patches`` and
``positions``, ``python -m repro_torch.launch.serve --arch qwen2-vl-7b``)
against the reference's ``repro.models``, on the reduced qwen2-vl config
(2 layers, d_model 128, 4/2 heads of 32, d_ff 256, a 64-wide patch
front end) with the reference's weights carried by the bridge.

The prompt is 40 tokens a row whose first 16 are patch embeddings, drawn
from a seed with numpy: the patches sit on a 4 x 4 grid (t = 0, h = i // 4,
w = i % 4) and the text after them at t = h = w = its index, so the three
position streams differ and decode's ``pos`` on all three agrees with the
prefill's layout.

Tolerances, and why: ``apply_mrope`` within one bf16 rounding of the
largest output (the two frameworks' fp32 cos and sin may differ in the
last bit, which moves an output across a rounding boundary), and bit for
bit equal to ``apply_rope`` where the three streams coincide (the same
angles); the last-token logits within 2^-5 of their largest value (as
``test_torch_dense_generic.py``: 2 layers of bf16 matmuls, each within
about two bf16 roundings, then the logits product); the prefill KV within
2^-6 of its largest value; prefill of S+1 tokens against prefill of S and
a decode step within 2^-4 of the largest logit (as ``chip_smoke.py``);
segment mode's last hidden state within 2^-6 of the reference's. Greedy
decoding over 16 steps is compared token for token and the agreement
printed; a first divergence must sit at a near tie of the reference's
logits.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(2)

ARCH = "qwen2-vl-7b"
BATCH, PROMPT, PATCHES, GRID, STEPS = 2, 40, 16, 4, 16
NEAR_TIE = 0.125                  # as tests/test_torch_serving.py


def grid_positions(B: int, S: int, P: int, grid: int) -> np.ndarray:
    """[3, B, S]: P patches on a grid x grid layout at t = 0, then text at
    t = h = w = its index."""
    pos = np.broadcast_to(np.arange(S), (3, B, S)).copy()
    i = np.arange(P)
    pos[0, :, :P] = 0
    pos[1, :, :P] = i // grid
    pos[2, :, :P] = i % grid
    return pos


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"
    return err, tol


def _pad(state, capacity):
    """The reference's prefill state with its KV padded to capacity."""
    kv = state["scan"]["s0"]
    S = kv["k"].shape[2]
    pad = [(0, 0), (0, 0), (0, capacity - S), (0, 0), (0, 0)]
    return {"scan": {"s0": {n: jnp.pad(kv[n], pad) for n in ("k", "v")}},
            "pos": state["pos"]}


@pytest.fixture(scope="module")
def runs():
    jcfg = jax_reduced(jax_get_config(ARCH))
    tcfg = reduced(get_config(ARCH))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tcfg.vocab_size, (BATCH, PROMPT))
    patches = rng.standard_normal(
        (BATCH, PATCHES, tcfg.frontend_embed_dim)).astype(np.float32)
    positions = grid_positions(BATCH, PROMPT, PATCHES, GRID)
    jbatch = {"tokens": jnp.asarray(prompt, jnp.int32),
              "patches": jnp.asarray(patches, jnp.bfloat16),
              "positions": jnp.asarray(positions, jnp.int32)}
    tbatch = {"tokens": torch.as_tensor(prompt),
              "patches": torch.as_tensor(patches).to(torch.bfloat16),
              "positions": torch.as_tensor(positions)}
    cap = PROMPT + STEPS
    jl, jst = jax_prefill(jparams, jbatch, jcfg)
    tl, tst = models.prefill(tparams, tbatch, tcfg, capacity=cap)
    snap = {"scan": {"s0": {n: t.clone()
                            for n, t in tst["scan"]["s0"].items()}},
            "pos": tst["pos"]}
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               prompt=prompt, jbatch=jbatch, tbatch=tbatch,
               prefill=(jl, tl), states=(jst, snap))
    jst = _pad(jst, cap)
    jrows, jtoks, ttoks = [], [], []
    jt_ = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = tl[:, -1].argmax(-1)[:, None]
    for _ in range(STEPS):
        jtoks.append(np.asarray(jt_)[:, 0])
        ttoks.append(tt[:, 0].numpy())
        jl, jst = jax_decode_step(jparams, jst, {"tokens": jt_}, jcfg)
        tl, tst = models.decode_step(tparams, tst, {"tokens": tt}, tcfg)
        jrows.append(np.asarray(jl[:, 0], np.float32))
        jt_ = jnp.argmax(jl[:, 0], -1)[:, None].astype(jnp.int32)
        tt = tl[:, 0].argmax(-1)[:, None]
    out.update(jtoks=np.stack(jtoks, 1), ttoks=np.stack(ttoks, 1),
               jrows=jrows, final=(jst, tst))
    return out


@pytest.mark.parametrize("hd, want", [(128, (16, 24, 24)), (32, (4, 6, 6)),
                                      (64, (8, 12, 12)), (256, (32, 48, 48))])
def test_mrope_sections_match_reference(hd, want):
    assert tlayers.mrope_sections(hd) == jlayers.mrope_sections(hd) == want


@pytest.mark.parametrize("hd", [32, 128])
def test_apply_mrope_matches_reference(hd):
    rng = np.random.default_rng(hd)
    B, S, H = 2, 24, 3
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.stack([rng.integers(0, 4000, (B, S)) for _ in range(3)])
    assert len({tuple(p.ravel()) for p in pos}) == 3   # three streams
    want = jlayers.apply_mrope(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(pos, jnp.int32), 1e6)
    got = tlayers.apply_mrope(torch.as_tensor(x).to(torch.bfloat16),
                              torch.as_tensor(pos), 1e6)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err, tol = _close(got, want, 2 ** -7, f"apply_mrope hd {hd}")
    print(f"\napply_mrope hd {hd}: max abs err {err:.4g} (tolerance "
          f"{tol:.4g})")


@pytest.mark.parametrize("hd", [32, 128])
def test_text_positions_are_apply_rope_bitwise(hd):
    rng = np.random.default_rng(hd + 1)
    B, S, H = 2, 17, 4
    x = torch.as_tensor(rng.standard_normal((B, S, H, hd)),
                        dtype=torch.float32).to(torch.bfloat16)
    p = torch.as_tensor(rng.integers(0, 30000, (B, S)))
    got = tlayers.apply_mrope(x, p[None].expand(3, B, S), 1e6)
    assert torch.equal(got, tlayers.apply_rope(x, p, 1e6))


def test_param_and_state_trees_match_reference(runs):
    tcfg, jparams, tparams = runs["tcfg"], runs["jparams"], runs["tparams"]
    assert transformer.stack_kind(tcfg) == "dense"
    own = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    for tree in (own, tparams):
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), tree)
        assert got == want
    assert tuple(own["frontend_proj"].shape) == (tcfg.frontend_embed_dim,
                                                 tcfg.d_model)
    jst, tst = runs["states"]
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).split(".")[-1]), tst)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jst)
    want["scan"]["s0"] = {n: ((s[0], s[1], PROMPT + STEPS) + s[3:], d)
                          for n, (s, d) in want["scan"]["s0"].items()}
    assert got == want
    zero = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax_init_state(runs["jcfg"], BATCH, PROMPT))
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]),
                        models.init_state(tcfg, BATCH, PROMPT, "cpu")) == zero


def test_prefill_logits_and_kv_match_reference(runs):
    jl, tl = runs["prefill"]
    assert tuple(tl.shape) == jl.shape == (BATCH, 1, runs["tcfg"].vocab_size)
    err, tol = _close(tl, jl, 2 ** -5, "last-token logits")
    print(f"\nqwen2-vl prefill with {PATCHES} patches on a grid: logits "
          f"max abs err {err:.4g} (tolerance {tol:.4g})")
    jst, tst = runs["states"]
    for name in ("k", "v"):
        j, t = jst["scan"]["s0"][name], tst["scan"]["s0"][name]
        _close(t[:, :, :PROMPT], j, 2 ** -6, f"prefill {name}")
        assert not t[:, :, PROMPT:].any()
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT


def test_patches_and_grid_positions_are_live(runs):
    """The prefill moves with the patches and with one patch's grid
    position, on both sides alike."""
    tcfg, tparams, tbatch = runs["tcfg"], runs["tparams"], runs["tbatch"]
    base = runs["prefill"][1]
    moved = dict(tbatch, positions=tbatch["positions"].clone())
    moved["positions"][1, :, 5] += 3              # patch 5 three rows down
    text = {"tokens": tbatch["tokens"]}
    for what, batch in (("a patch's grid position", moved),
                        ("the patches", text)):
        tl, _ = models.prefill(tparams, batch, tcfg)
        jb = {k: jnp.asarray(v.float().numpy() if v.is_floating_point()
                             else v.numpy(),
                             jnp.bfloat16 if v.is_floating_point()
                             else jnp.int32) for k, v in batch.items()}
        jl, _ = jax_prefill(runs["jparams"], jb, runs["jcfg"])
        assert (tl - base).abs().max() > 0, what
        _close(tl, jl, 2 ** -5, f"prefill without {what}")


def test_greedy_decode_matches_reference(runs):
    jt_, tt = runs["jtoks"], runs["ttoks"]
    same = int((jt_ == tt).sum())
    print(f"\nqwen2-vl: greedy token agreement {same}/{jt_.size} = "
          f"{same / jt_.size:.4f}")
    for b in range(BATCH):
        diff = np.nonzero(jt_[b] != tt[b])[0]
        if diff.size:
            s = int(diff[0])
            row = runs["jrows"][s - 1][b] if s else \
                np.asarray(runs["prefill"][0][b, -1], np.float32)
            gap = float(row[jt_[b, s]] - row[tt[b, s]])
            print(f"row {b}: first differing token {s}, reference logit gap "
                  f"{gap:.4f}")
            assert gap <= NEAR_TIE, f"row {b} diverges at {s}, gap {gap}"
    jst, tst = runs["final"]
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + STEPS


def test_prefill_then_decode_equals_longer_prefill(runs):
    """Prefill of S+1 tokens (patches and grid positions, the last token
    at t = h = w = S) against prefill of S and one decode step, whose
    M-RoPE takes pos = S on all three streams."""
    tcfg, tparams, tb = runs["tcfg"], runs["tparams"], runs["tbatch"]
    full, _ = models.prefill(tparams, tb, tcfg)
    short = {"tokens": tb["tokens"][:, :-1], "patches": tb["patches"],
             "positions": tb["positions"][:, :, :-1]}
    _, st = models.prefill(tparams, short, tcfg, capacity=PROMPT)
    step, _ = models.decode_step(tparams, st, {"tokens": tb["tokens"][:, -1:]},
                                 tcfg)
    _close(step, full.float().numpy(), 2 ** -4, "decode after prefill")


def test_segment_mode_matches_reference(runs):
    """Segment mode under M-RoPE (text positions on all three streams):
    the prompt in two segments against the reference's segment mode."""
    tcfg, jcfg = runs["tcfg"], runs["jcfg"]
    toks = runs["prompt"][:1]
    half = PROMPT // 2
    jst = jax_init_state(jcfg, 1, PROMPT)
    tst = models.init_state(tcfg, 1, PROMPT, "cpu")
    for seg in (toks[:, :half], toks[:, half:]):
        jx, jst, _, _ = jt.backbone(runs["jparams"],
                                    {"tokens": jnp.asarray(seg, jnp.int32)},
                                    jcfg, "segment", state=jst, remat=False)
        tx, tst, _ = transformer.backbone(runs["tparams"],
                                          torch.as_tensor(seg), tcfg,
                                          "segment", state=tst)
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT
    _close(tx[:, -1], np.asarray(jx[:, -1], np.float32), 2 ** -6,
           "segment mode's last hidden state")
    _close(tst["scan"]["s0"]["k"], jst["scan"]["s0"]["k"], 2 ** -6,
           "segment mode's KV")
