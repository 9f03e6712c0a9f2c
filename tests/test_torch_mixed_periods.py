"""The generic serve path on the reference's mixed layer periods
(``repro_torch.models.prefill`` / ``decode_step``, ``python -m
repro_torch.launch.serve --arch <arch>``) against the reference's, on the
reduced configs with the reference's weights carried by the bridge:

* ``jamba-v0.1-52b``: 16 layers, a period of 8 (7 Mamba layers and 1
  attention layer, each followed by the MoE on odd layers, 8 experts top-2,
  and a dense FFN on even ones; Mamba d_state 32, 8 heads of 32);
* ``llama4-maverick-400b-a17b``: 4 layers, a period of 2 (a dense-FFN
  layer, then an MoE layer of 8 experts top-1 with a shared expert);
* ``gemma3-4b``: 12 layers, a period of 6 windows (5 local layers of 64
  keys, then a global one), the embedding scale, tied embeddings and the
  logit softcap;
* the remainder layers (``rem/r{j}``): gemma3-4b cut to 8 layers (one
  group of 6, then 2) and llama4 cut to 3 (one group of 2, then a
  dense-FFN layer).

Which reference, and why. The port mirrors the rounding points the
reference's code states, op by op. The reference's ``prefill`` runs its
layers inside ``lax.scan``, where XLA fuses elementwise chains and keeps
some intermediates in fp32: on the reduced jamba its own compiled forward
and the same ``_apply_layer`` calls run one by one differ in 64-65% of
layer 0's outputs, and the two route 0-3 of 80 tokens to other experts
at the first MoE layer, 9-15 at the eighth (three seeded prompts, on a
CPU). A routing flip
moves a token's output by a whole expert, so jamba's logits are not
within any bf16 tolerance of the reference's compiled forward, and the
port's are no closer to it than the reference's own eager run. The
logits, KV and states are therefore held against the reference's
``_apply_layer`` run layer by layer in the backbone's order (the
reference's prefill with each op dispatched by itself), for every model;
gemma3, which has no routing to flip, against the compiled
``repro.models.prefill`` too.

Even against that run, a 1-ulp difference of an expert product (the two
frameworks sum matmuls in other orders) flips a near-tied routing now
and then in the later MoE layers. So every layer is also held on the
reference's own input to it, where the routing must match exactly.

Tolerances: the last-token logits within 2^-5 of their largest value
(as ``test_torch_dense_generic.py``; jamba's late flips stay inside it);
every attention layer's prefill KV and Mamba ``conv`` state within 2^-5,
the fp32 ``ssd`` state within 2^-4, of their largest value, up to the
first routing flip; each layer on the reference's input within a bf16
rounding or two (test docstrings); prefill of S+1 tokens against prefill
of S and a decode step within 2^-4 of the largest logit (as
``chip_smoke.py``); the MoE layer with its shared expert within 2^-6 of
the reference's ``moe_apply``. Greedy decoding over 32 steps is compared
token for token with the layer-by-layer reference's and with the
compiled ``decode_step``'s, and both agreements printed, with each first
divergence's logit gap.
"""
import dataclasses
import math
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import (params_from_numpy, params_to_numpy,  # noqa: E402
                                tensor_from_numpy, tensor_to_numpy)
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(2)

BATCH, PROMPT, STEPS = 2, 40, 32
JAMBA, LLAMA4, GEMMA3 = ("jamba-v0.1-52b", "llama4-maverick-400b-a17b",
                         "gemma3-4b")
# (case id, arch, reduced() overrides)
CASES = [("jamba", JAMBA, {}), ("llama4", LLAMA4, {}),
         ("gemma3", GEMMA3, {}), ("gemma3-rem", GEMMA3, dict(num_layers=8)),
         ("llama4-rem", LLAMA4, dict(num_layers=3))]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, rel, what):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"
    return err, tol


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _spec(tree):
    """{leaf path: (shape, dtype name)} of a reference or port tree."""
    out = {}
    for name, a in _leaves(tree):
        if isinstance(a, torch.Tensor):
            out[name] = (tuple(a.shape), str(a.dtype).split(".")[-1])
        else:
            out[name] = (tuple(a.shape), np.dtype(a.dtype).name)
    return out


def _eager_prefill(jparams, prompt, jcfg):
    """The reference's prefill with its layers run one by one: its
    ``_apply_layer`` in the backbone's order (groups, then the
    remainder), then the final norm and the last token's logits. Returns
    (logits [B, 1, V], per layer in order: (where, slot, input, output,
    state, top-k ids or None)) with where = (tree, key, group)."""
    slots, G, R = jt.build_slots(jcfg)
    x = jt._embed_inputs(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                         jcfg)
    positions = jnp.arange(prompt.shape[1])[None]
    order = [("scan", f"s{j}", g, slot) for g in range(G)
             for j, slot in enumerate(slots)]
    order += [("rem", f"r{j}", None, slots[j % len(slots)])
              for j in range(R)]
    layers = []
    for tree, key, g, slot in order:
        lp = jparams[tree][key]
        if g is not None:
            lp = jax.tree.map(lambda a: a[g], lp)
        y, st, _, tr = jt._apply_layer(lp, x, slot, jcfg, positions,
                                       "prefill", None, None,
                                       want_trace=True)
        layers.append(((tree, key, g), slot, x, y, st,
                       None if tr is None else np.asarray(tr["top_i"])))
        x = y
    x = jt.rmsnorm(jparams["final_norm"], x, jcfg.norm_eps)
    return jt.lm_logits(jparams, x[:, -1:], jcfg), layers


def _eager_decode(jparams, jcfg, layers, tok, steps, capacity):
    """The reference's greedy decode with its layers run one by one (its
    ``_apply_layer`` in decode mode), from the layer-by-layer prefill's
    states (KV padded to ``capacity``) and first token ``tok`` [B, 1].
    Returns (tokens [B, steps], logits rows [steps][B, V])."""
    S = layers[0][2].shape[1]
    states = []
    for _, _, _, _, st, _ in layers:
        if "k" in st:
            st = {n: jnp.pad(st[n], [(0, 0), (0, capacity - S), (0, 0),
                                     (0, 0)]) for n in ("k", "v")}
        states.append(st)
    toks, rows = [], []
    for step in range(steps):
        toks.append(np.asarray(tok)[:, 0])
        x = jt._embed_inputs(jparams, {"tokens": tok}, jcfg)
        pos = jnp.int32(S + step)
        for i, ((tree, key, g), slot, _, _, _, _) in enumerate(layers):
            lp = jparams[tree][key]
            if g is not None:
                lp = jax.tree.map(lambda a: a[g], lp)
            x, states[i], _, _ = jt._apply_layer(lp, x, slot, jcfg, None,
                                                 "decode", states[i], pos)
        x = jt.rmsnorm(jparams["final_norm"], x, jcfg.norm_eps)
        lg = jt.lm_logits(jparams, x, jcfg)
        rows.append(np.asarray(lg[:, 0], np.float32))
        tok = jnp.argmax(lg[:, 0], -1)[:, None].astype(jnp.int32)
    return np.stack(toks, 1), rows


def _port_states(state, cfg):
    """The port's prefill state as {(tree, key, group): layer state}."""
    out = {}
    for kind, key, g, _ in transformer.layer_order(cfg):
        st = state[kind][key]
        out[(kind, key, g)] = st if g is None else \
            {n: t[g] for n, t in st.items()}
    return out


def _pad(state, capacity):
    """The reference's prefill state with every attention layer's KV
    padded to capacity (the key axis is the third from last)."""
    def pad(kv):
        if "k" not in kv:
            return kv
        out = {}
        for n in ("k", "v"):
            t = kv[n]
            width = [(0, 0)] * t.ndim
            width[t.ndim - 3] = (0, capacity - t.shape[t.ndim - 3])
            out[n] = jnp.pad(t, width)
        return out
    new = {"pos": state["pos"]}
    for tree in ("scan", "rem"):
        if tree in state:
            new[tree] = {k: pad(v) for k, v in state[tree].items()}
    return new


def _snapshot(state):
    """A copy of a port state (decode writes the KV in place)."""
    return {k: ({kk: {n: t.clone() for n, t in vv.items()}
                 for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in state.items()}


def _serve(arch, overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    tcfg = reduced(get_config(arch), **overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (BATCH, PROMPT))
    cap = PROMPT + STEPS
    jl, jst = jax_prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg)
    tl, tst = models.prefill(tparams, {"tokens": torch.as_tensor(prompt)},
                             tcfg, capacity=cap)
    el, layers = _eager_prefill(jparams, prompt, jcfg)
    _, _, trace = transformer.backbone(tparams, torch.as_tensor(prompt), tcfg,
                                       "prefill", want_trace=True)
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               prompt=prompt, prefill=(jl, tl, el), layers=layers,
               trace=trace, states=(jst, _snapshot(tst)))
    jst = _pad(jst, cap)
    jrows, trows, jtoks, ttoks = [], [], [], []
    jt_ = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = tl[:, -1].argmax(-1)[:, None]
    for _ in range(STEPS):
        jtoks.append(np.asarray(jt_)[:, 0])
        ttoks.append(tt[:, 0].numpy())
        jl, jst = jax_decode_step(jparams, jst, {"tokens": jt_}, jcfg)
        tl, tst = models.decode_step(tparams, tst, {"tokens": tt}, tcfg)
        jrows.append(np.asarray(jl[:, 0], np.float32))
        trows.append(tl[:, 0].float().numpy())
        jt_ = jnp.argmax(jl[:, 0], -1)[:, None].astype(jnp.int32)
        tt = tl[:, 0].argmax(-1)[:, None]
    etoks, erows = _eager_decode(
        jparams, jcfg, layers,
        jnp.argmax(el[:, -1], -1)[:, None].astype(jnp.int32), STEPS, cap)
    out.update(jtoks=np.stack(jtoks, 1), ttoks=np.stack(ttoks, 1),
               jrows=jrows, trows=trows, final=(jst, tst),
               etoks=etoks, erows=erows)
    return out


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def runs(request):
    _, arch, overrides = request.param
    return _serve(arch, overrides)


@pytest.mark.parametrize("arch", [JAMBA, LLAMA4, GEMMA3, "qwen2-vl-7b",
                                  "seamless-m4t-large-v2"])
def test_config_copies_match_reference(arch):
    """The port's copies of the reference's configs, full and reduced:
    every field equal (the MoE and SSM configs field by field)."""
    for tc, jc in ((get_config(arch), jax_get_config(arch)),
                   (reduced(get_config(arch)),
                    jax_reduced(jax_get_config(arch)))):
        for f in dataclasses.fields(tc):
            t, j = getattr(tc, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(t):
                assert dataclasses.asdict(t) == dataclasses.asdict(j), f.name
            else:
                assert t == j, f.name
        assert {f.name for f in dataclasses.fields(tc)} \
            <= {f.name for f in dataclasses.fields(jc)}


def test_param_and_state_trees_match_reference(runs):
    """``scan/s{j}`` with the leading [G], ``rem/r{j}`` without: the port's
    own ``init_params``, the bridged tree and ``init_state`` (attention KV
    and Mamba ``conv``/``ssd`` per slot) have the reference's leaves,
    shapes and dtypes; the bridge round trip is bitwise."""
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    jparams = jax.tree.map(np.asarray, runs["jparams"])
    want = _spec(jparams)
    own = models.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _spec(own) == want
    assert _spec(runs["tparams"]) == want
    back = dict(_leaves(params_to_numpy(runs["tparams"])))
    for name, a in _leaves(jparams):
        bits = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert back[name].tobytes() == bits.tobytes(), name
    slots, G, R = transformer.build_slots(tcfg)
    assert ("rem" in own) == bool(R) and len(own["scan"]) == len(slots)
    got = models.init_state(tcfg, 3, 16, "cpu")
    ref = jax.tree.map(np.asarray, jax_init_state(jcfg, 3, 16))
    assert _spec(got) == _spec(ref)
    for name, t in _leaves(got):
        assert not t.any(), name
    kinds = {JAMBA: "mixed", LLAMA4: "mixed", GEMMA3: "dense"}
    assert transformer.stack_kind(tcfg) == kinds[tcfg.name]


def _routing_differs(runs, where, ids):
    """Whether the port's prefill picked other experts than the
    layer-by-layer reference for some token at this MoE layer."""
    kind, key, g = where
    top = runs["trace"][kind][key]["top_i"]
    top = (top if g is None else top[g]).numpy()
    return bool((np.sort(top, -1) != np.sort(ids, -1)).any())


def test_prefill_logits_match_reference(runs):
    """The last-token logits within 2^-5 of the largest against the
    layer-by-layer reference (every model) and against the compiled
    ``repro.models.prefill`` (gemma3: no routing to flip; the MoE stacks'
    distance to it is printed beside the reference's own)."""
    tcfg = runs["tcfg"]
    jl, tl, el = runs["prefill"]
    assert tuple(tl.shape) == jl.shape == (BATCH, 1, tcfg.vocab_size)
    err, tol = _close(tl, el, 2 ** -5, "last-token logits (layer by layer)")
    print(f"\n{tcfg.name} ({tcfg.num_layers} layers): prefill logits max "
          f"abs err {err:.4g} against the layer-by-layer reference "
          f"(tolerance {tol:.4g})")
    compiled = np.abs(_np(tl) - _np(jl)).max() / np.abs(_np(jl)).max()
    own = np.abs(_np(el) - _np(jl)).max() / np.abs(_np(jl)).max()
    print(f"against the compiled reference: {compiled:.4g} of the largest "
          f"logit (the reference's own layer-by-layer run: {own:.4g})")
    if tcfg.name == GEMMA3:
        _close(tl, jl, 2 ** -5, "last-token logits (compiled reference)")
    assert int(runs["states"][1]["pos"]) == int(runs["states"][0]["pos"]) \
        == PROMPT


def test_every_layer_matches_reference_on_the_same_input(runs):
    """Each layer of the port's stack, fed the reference's input to that
    layer, against the reference's ``_apply_layer``: the same experts for
    every token, the output within 2^-6 of its largest value (a bf16
    rounding or two: the two frameworks sum the matmuls in other orders
    and XLA may round silu's chain elsewhere), the attention KV and the
    Mamba ``conv`` state within 2^-7 (one rounding), the fp32 SSD state
    within 2^-12 (sums in another order)."""
    tcfg, tparams = runs["tcfg"], runs["tparams"]
    positions = torch.arange(PROMPT)[None]
    for where, slot, x, y, st, ids in runs["layers"]:
        kind, key, g = where
        lp = tparams[kind][key]
        lp = lp if g is None else transformer.layer_params(lp, g)
        tx = tensor_from_numpy(np.asarray(x), "cpu")
        got, new, tr = transformer._apply_layer(
            lp, tx, slot, tcfg, "prefill", None, 0, positions,
            want_trace=True)
        if ids is not None:
            np.testing.assert_array_equal(tr["top_i"].numpy(), ids)
        _close(got, y, 2 ** -6, f"{where} output")
        for name, t in new.items():
            rel = 2 ** -12 if name == "ssd" else 2 ** -7
            _close(t, st[name], rel, f"{where} {name}")


def test_prefill_state_matches_reference(runs):
    """The port's prefill state (every attention layer's KV padded to the
    prompt plus the decoded tokens, every Mamba layer's state) against the
    layer-by-layer reference's, within 2^-5 (KV, ``conv``) and 2^-4
    (``ssd``) of its largest value, for every layer up to the first MoE
    layer where the two picked other experts for some token (a flip moves
    that token's later layers by a whole expert: the count is printed;
    each later layer is held on the reference's own input by
    ``test_every_layer_matches_reference_on_the_same_input``)."""
    tcfg = runs["tcfg"]
    port = _port_states(runs["states"][1], tcfg)
    assert len(port) == tcfg.num_layers
    held = 0
    for where, slot, _, _, want, ids in runs["layers"]:
        got = port[where]
        assert set(got) == set(want)
        for name in sorted(want):
            g, w = got[name], want[name]
            if name in ("k", "v"):
                assert g.shape[1] == PROMPT + STEPS and w.shape[1] == PROMPT
                assert not g[:, PROMPT:].any()
                g = g[:, :PROMPT]
            _close(g, w, 2 ** -4 if name == "ssd" else 2 ** -5,
                   f"{where} prefill {name}")
        held += 1
        if ids is not None and _routing_differs(runs, where, ids):
            break
    print(f"\n{tcfg.name}: prefill state held for {held} of "
          f"{tcfg.num_layers} layers (then a routing flip)")
    if tcfg.name == GEMMA3:
        assert held == tcfg.num_layers


def _agreement(name, ref_toks, ref_rows, ref_first_row, ttoks, trows):
    """Prints the greedy agreement of the port's tokens with a reference's
    and, at each row's first differing token, the reference's logit gap
    between the two picks. Returns (agreement, steps before the first
    difference, the worst logit error of those steps, relative)."""
    same = int((ref_toks == ttoks).sum())
    first = STEPS
    for b in range(BATCH):
        diff = np.nonzero(ref_toks[b] != ttoks[b])[0]
        if diff.size:
            s = int(diff[0])
            first = min(first, s)
            row = ref_rows[s - 1][b] if s else ref_first_row[b]
            gap = float(row[ref_toks[b, s]] - row[ttoks[b, s]])
            print(f"  {name}: row {b} first differs at token {s}, "
                  f"reference logit gap {gap:.4f}")
    worst = max((np.abs(trows[s] - ref_rows[s]).max()
                 / np.abs(ref_rows[s]).max() for s in range(first)),
                default=0.0)
    print(f"  {name}: greedy token agreement {same}/{ref_toks.size} = "
          f"{same / ref_toks.size:.4f}; {first} steps before the first "
          f"difference, worst logit error {worst:.4g} of the largest")
    return same / ref_toks.size, first, worst


def test_greedy_decode_agreement_is_reported(runs):
    """32 greedy steps, the port's against the layer-by-layer reference's
    (its ``_apply_layer`` in decode mode from its layer-by-layer prefill)
    and against the compiled ``repro.models.decode_step`` (from the
    compiled prefill, the state padded to the same capacity): the
    agreement of each, and at the first differing token the reference's
    logit gap between the two picks. Every step both sides decoded from the
    same tokens must agree within 2^-5 with the layer-by-layer reference,
    and with the compiled one where no routing can flip (gemma3)."""
    tcfg = runs["tcfg"]
    tt, trows = runs["ttoks"], runs["trows"]
    print(f"\n{tcfg.name} ({tcfg.num_layers} layers):")
    _, _, worst = _agreement("layer by layer", runs["etoks"], runs["erows"],
                             _np(runs["prefill"][2])[:, -1], tt, trows)
    assert worst <= 2 ** -5
    _, _, worst = _agreement("compiled", runs["jtoks"], runs["jrows"],
                             _np(runs["prefill"][0])[:, -1], tt, trows)
    if tcfg.name == GEMMA3:
        assert worst <= 2 ** -5
    assert tt.min() >= 0 and tt.max() < tcfg.vocab_size
    assert all(np.isfinite(r).all() for r in trows)
    jst, tst = runs["final"]
    assert int(tst["pos"]) == int(jst["pos"]) == PROMPT + STEPS


def test_prefill_then_decode_equals_longer_prefill(runs):
    """Inside the port: prefill of S+1 tokens against prefill of S tokens
    and one decode step (flash-decode's plain version with each layer's
    window, the Mamba recurrence against the chunked scan, the one-group
    MoE dispatch against the per-example one): within 2^-4 of the largest
    logit."""
    tcfg, tparams, prompt = runs["tcfg"], runs["tparams"], runs["prompt"]
    toks = torch.as_tensor(prompt)
    long_logits, _ = models.prefill(tparams, {"tokens": toks}, tcfg)
    _, st = models.prefill(tparams, {"tokens": toks[:, :-1]}, tcfg,
                           capacity=PROMPT)
    step_logits, st = models.decode_step(tparams, st,
                                         {"tokens": toks[:, -1:]}, tcfg)
    err, tol = _close(step_logits, long_logits, 2 ** -4,
                      "decode after prefill")
    print(f"\n{tcfg.name}: prefill {PROMPT - 1} + decode against prefill "
          f"{PROMPT}: {err:.4g} (tolerance {tol:.4g})")
    assert int(st["pos"]) == PROMPT


def test_gemma_embedding_scale_rounds_as_the_reference():
    """gemma's sqrt(d_model) is rounded to bf16 before the product (sqrt(128)
    = 11.3137 becomes 11.3125, sqrt(2560) = 50.596 becomes 50.5): the port's
    scaled embeddings equal the reference's bit for bit; other models'
    embeddings are not scaled."""
    assert torch.tensor(math.sqrt(2560), dtype=torch.bfloat16).item() == 50.5
    for arch, scaled in ((GEMMA3, True), (LLAMA4, False)):
        jcfg, tcfg = jax_reduced(jax_get_config(arch)), \
            reduced(get_config(arch))
        jparams = {"embed": jax_init_params(jcfg, jax.random.PRNGKey(1))[
            "embed"]}
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 9))
        want = jt._embed_inputs(jparams, {"tokens": jnp.asarray(
            toks, jnp.int32)}, jcfg)
        got = transformer._embed_inputs(tparams, torch.as_tensor(toks), tcfg)
        np.testing.assert_array_equal(tensor_to_numpy(got),
                                      np.asarray(want).view(np.uint16))
        plain = tparams["embed"][torch.as_tensor(toks)]
        assert torch.equal(got, plain) != scaled


@pytest.mark.parametrize("S", [1, 7])
def test_shared_expert_matches_reference_moe_apply(S):
    """llama4's MoE layer (8 experts top-1 and one shared expert) against
    the reference's ``moe_apply`` on the same weights and inputs, for a
    decode-shaped (S = 1: one flat dispatch group) and a prompt-shaped
    batch: the layer's output, and the shared expert's contribution alone
    (with ``shared`` minus without), within 2^-6 of their largest value."""
    jcfg = jax_reduced(jax_get_config(LLAMA4))
    tcfg = reduced(get_config(LLAMA4))
    m = tcfg.moe
    assert m.num_shared_experts == 1 and m.top_k == 1
    jp = jax.tree.map(lambda a: a[0],
                      jax_init_params(jcfg, jax.random.PRNGKey(3))
                      ["scan"]["s1"]["moe"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tuple(tp["shared"]["w1"].shape) == (tcfg.d_model, m.d_ff)
    x = np.random.default_rng(4).standard_normal((3, S, tcfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = tensor_from_numpy(np.asarray(jx), "cpu")
    cf = m.serve_capacity_factor
    want, _ = jmoe.moe_apply(jp, jx, jcfg.moe, capacity_factor=cf)
    got = tmoe.moe_apply(tp, tx, m, capacity_factor=cf)
    _close(got, want, 2 ** -6, "moe_apply with the shared expert")
    j_no, _ = jmoe.moe_apply({k: v for k, v in jp.items() if k != "shared"},
                             jx, jcfg.moe, capacity_factor=cf)
    t_no = tmoe.moe_apply({k: v for k, v in tp.items() if k != "shared"}, tx,
                          m, capacity_factor=cf)
    shared_want = _np(want) - _np(j_no)
    assert np.abs(shared_want).max() > 0
    _close(_np(got) - _np(t_no), shared_want, 2 ** -6,
           "the shared expert's contribution")


@pytest.mark.parametrize("arch", [JAMBA, LLAMA4, GEMMA3])
def test_serve_generic_runs_mixed_periods_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt", "12", "--tokens", "6"])
    out = capsys.readouterr().out
    assert f"generic path: {arch}" in out
    assert "generated (2, 6)" in out


def test_mamba_slots_refuse_segment_mode():
    """Segment mode serves attention layers only, as the reference's: a
    hybrid stack refuses it before touching its state."""
    cfg = reduced(get_config(JAMBA))
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    st = models.init_state(cfg, 1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="attention layers only"):
        transformer.backbone(params, torch.zeros((1, 4), dtype=torch.long),
                             cfg, "segment", state=st)
