"""The generic serve path with the prefill scan routed through
``ssd_scan_chunked_plain``, the CUDA ``ssd_scan`` kernels' chunk-parallel
algorithm (with their bf16 hi/lo split of every fp32 operand), against
the reference's ``repro.models`` on the reduced mamba2-370m config.

``tests/test_torch_generic_serve.py`` runs the same model through
``ssd_scan_plain``, the sequential transcription the wrapper takes for
CPU tensors; ``tests/test_torch_ssd_chunk_parallel.py`` holds the chunked
mirror to the reference op by op. This file closes the gap between the
two: the chunked algorithm end to end, prefill and 16 greedy steps, with
the same weights on both sides (``repro_torch.bridge``) and the same
seeded perturbation of A_log, D, dt_bias and norm_w.

Tolerances, as ``tests/test_torch_generic_serve.py`` states them: the
last-token logits within 2^-5 of their largest value (2 layers of bf16
matmuls and scans, each within about two bf16 roundings, then the
tied-embedding product); the ssd state within 2^-5 of its largest value
(layer 1 carries layer 0's bf16 output) and layer 0's within 2^-12 (fp32
sums in another order; the hi/lo split keeps each product within 2^-17
of the fp32 one). Greedy agreement is printed as a number; a first
divergence must sit at a near tie of the reference's logits.
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
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reduced  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(2)

BATCH, PROMPT, STEPS = 2, 150, 16       # a 64-token chunk twice plus a tail
NEAR_TIE = 0.05                          # logit gap a bf16 drift can flip


def perturb(tree, seed=0):
    """Seeded A_log, D, dt_bias and norm_w on a reference param tree (in
    place; returned), as ``tests/test_torch_generic_serve.py`` does."""
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
    """Prefill through the chunked mirror, then 16 greedy decode steps, on
    both sides; also the port's prefill through the sequential plain scan,
    for the prefill's error against the path the CPU wrapper takes."""
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    tcfg = reduced(get_config("mamba2-370m"))
    jparams = perturb(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (BATCH, PROMPT))
    toks = {"tokens": torch.as_tensor(prompt)}
    seq_logits, _ = models.prefill(tparams, toks, tcfg)
    calls = []

    def chunked(*args):
        calls.append(args[0].shape)
        return ssd_ops.ssd_scan_chunked_plain(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "ssd_scan", chunked)
        tl, tst = models.prefill(tparams, toks, tcfg)
    jl, jst = jax_prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                          jcfg)
    out = dict(tcfg=tcfg, prefill=(jl, tl), seq_logits=seq_logits,
               states=(jst, tst), calls=calls)
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
               jrows=jrows)
    return out


def _err(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max()), rel * float(np.abs(want).max())


def test_prefill_routes_every_layer_through_the_chunked_mirror(runs):
    assert len(runs["calls"]) == runs["tcfg"].num_layers
    assert all(s == runs["calls"][0] for s in runs["calls"])


def test_chunked_prefill_logits_and_state_match_reference(runs):
    jl, tl = runs["prefill"]
    assert tuple(tl.shape) == jl.shape == (BATCH, 1, runs["tcfg"].vocab_size)
    err, tol = _err(tl, jl, 2 ** -5)
    print(f"\nchunked prefill vs reference, last-token logits: max_abs_err="
          f"{err:.6g} tol={tol:.6g}")
    assert err <= tol
    err, tol = _err(tl, runs["seq_logits"].float().numpy(), 2 ** -5)
    print(f"chunked prefill vs sequential plain scan: max_abs_err={err:.6g} "
          f"tol={tol:.6g}")
    assert err <= tol
    jst, tst = runs["states"]
    j, t = jst["scan"]["s0"]["ssd"], tst["scan"]["s0"]["ssd"]
    assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    err, tol = _err(t, j, 2 ** -5)
    assert err <= tol, ("ssd state", err, tol)
    err, tol = _err(t[0], j[0], 2 ** -12)
    print(f"layer 0 ssd state: max_abs_err={err:.6g} tol={tol:.6g}")
    assert err <= tol


def test_chunked_prefill_greedy_decode_matches_reference(runs):
    jt, tt = runs["jtoks"], runs["ttoks"]
    same = int((jt == tt).sum())
    print(f"\ngreedy token agreement (chunked prefill): {same}/{jt.size} = "
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
