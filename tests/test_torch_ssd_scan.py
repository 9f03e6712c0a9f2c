"""The port's ``ssd_scan`` (its plain version, on the CPU) against the
reference's SSD functions, with the same inputs drawn from seeded numpy.

Tolerances, and why:
- against ``repro.models.ssm.ssd_chunked`` with bf16 x: both form a, xd,
  the scores and the decays in fp32 and round y once to bf16, summing in
  another order (einsum against einsum); y agrees within one bf16 rounding
  of its largest value (2^-7 max|y|), h (fp32, never rounded) within
  1e-4 of max|h| (fp32 sums of up to Q * ds terms in another order);
- against the Pallas kernel's adapter ``ssd_chunked_kernel`` (interpret
  mode) with fp32 x, so that the adapter's bf16 rounding of xd and B/C
  does not enter: the reference's own tolerance for kernel against model,
  5e-4 (``tests/test_kernels_ssd.py``);
- against ``ref.ssd_multi_chunk_ref`` per head, fp32 throughout: 5e-4.
Never bitwise against the Pallas output (ROADMAP Queue 3).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd_scan import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunked_kernel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import cases, launches, reset_launches  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402

torch.set_num_threads(2)

Y_REL = 2 ** -7          # one bf16 rounding of the largest output
H_REL = 1e-4             # fp32 sums in another order
PALLAS_TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(seed, B, S, nh, hp, ds, h0, x_dtype=np.float32):
    """numpy inputs at the model's scales: x, dt = softplus(N - 1),
    A_log ~ N(0, 0.5), B/C ~ 0.3 N, h0 ~ 0.5 N or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 1.0)
                  ).astype(np.float32)
    A_log = (rng.standard_normal(nh) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, ds)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, ds)) * 0.3).astype(np.float32)
    state = (rng.standard_normal((B, nh, ds, hp)) * 0.5).astype(np.float32) \
        if h0 else None
    return x, dt, A_log, Bm, Cm, state


def _bf16(a):
    """The same bf16 values on both sides."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


# B, S, nh, hp, ds, chunk, h0: full chunks and ragged tails, S < chunk,
# zero and random incoming state, the reduced config's widths (hp 32,
# ds 32, chunk 64) and the full config's chunk of 256
MODEL_CASES = [
    (2, 128, 4, 32, 32, 64, False),
    (2, 200, 4, 32, 32, 64, True),
    (1, 37, 3, 32, 32, 64, True),
    (2, 300, 2, 64, 128, 256, False),
    (1, 512, 2, 64, 128, 256, True),
    (3, 50, 2, 64, 128, 256, False),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=str)
def test_ssd_scan_matches_model_ssd_chunked(case):
    B, S, nh, hp, ds, chunk, h0 = case
    x, dt, A_log, Bm, Cm, state = _inputs(sum(case[:6]), B, S, nh, hp, ds,
                                          h0)
    jx, tx = _bf16(x)
    jB, tB = _bf16(Bm)
    jC, tC = _bf16(Cm)
    jy, jh = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A_log), jB,
                              jC, None if state is None
                              else jnp.asarray(state), chunk=chunk)
    reset_launches()
    ty, th = ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A_log), tB,
                      tC, None if state is None else torch.from_numpy(state),
                      chunk)
    assert launches()["ssd_scan"] == 0        # the CPU runs the plain version
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    assert tuple(ty.shape) == (B, S, nh, hp)
    assert tuple(th.shape) == (B, nh, ds, hp)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), Y_REL, "y")
    _close(th.numpy(), np.asarray(jh), H_REL, "h")


@pytest.mark.parametrize("case", [(2, 256, 4, 32, 32), (1, 384, 2, 64, 128)],
                         ids=str)
def test_ssd_scan_matches_pallas_adapter_in_fp32(case):
    """``ssd_chunked_kernel`` (zero initial state, chunk 128, the Pallas
    kernel in interpret mode) with fp32 x, B and C."""
    B, S, nh, hp, ds = case
    x, dt, A_log, Bm, Cm, _ = _inputs(sum(case), B, S, nh, hp, ds, False)
    jy, jh = ssd_chunked_kernel(*(jnp.asarray(a)
                                  for a in (x, dt, A_log, Bm, Cm)))
    ty, th = ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A_log, Bm, Cm)),
                      None, 128)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **PALLAS_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **PALLAS_TOL)


def test_ssd_scan_matches_multi_chunk_ref_per_head():
    """``ref.ssd_multi_chunk_ref`` takes one head's a = -exp(A_log) dt and
    dt-scaled x, chunk by chunk, from a given state."""
    B, S, nh, hp, ds, Q = 2, 192, 3, 32, 32, 64
    x, dt, A_log, Bm, Cm, state = _inputs(5, B, S, nh, hp, ds, True)
    ty, th = ssd_scan(*(torch.from_numpy(a)
                        for a in (x, dt, A_log, Bm, Cm, state)), Q)
    a = -np.exp(A_log) * dt                               # [B, S, nh]
    xd = x * dt[..., None]
    n = S // Q
    for b in range(B):
        for h in range(nh):
            y_ref, h_ref = jref.ssd_multi_chunk_ref(
                jnp.asarray(a[b, :, h].reshape(n, Q)),
                jnp.asarray(xd[b, :, h].reshape(n, Q, hp)),
                jnp.asarray(Bm[b].reshape(n, Q, ds)),
                jnp.asarray(Cm[b].reshape(n, Q, ds)),
                jnp.asarray(state[b, h]))
            np.testing.assert_allclose(ty[b, :, h].numpy(),
                                       np.asarray(y_ref).reshape(S, hp),
                                       **PALLAS_TOL)
            np.testing.assert_allclose(th[b, h].numpy(), np.asarray(h_ref),
                                       **PALLAS_TOL)


def test_chunking_changes_y_by_at_most_one_rounding():
    """Q = min(chunk, S) as in ``ssd_chunked``: another chunking is the same
    recurrence summed in another order."""
    x, dt, A_log, Bm, Cm, _ = _inputs(9, 1, 200, 2, 32, 32, False)
    args = [torch.from_numpy(a) for a in (x, dt, A_log, Bm, Cm)]
    args[0] = args[0].to(torch.bfloat16)
    y64, h64 = ssd_scan_plain(*args, None, 64)
    y256, h256 = ssd_scan_plain(*args, None, 256)
    _close(y64.float().numpy(), y256.float().numpy(), Y_REL, "y")
    _close(h64.numpy(), h256.numpy(), H_REL, "h")


def test_wrapper_checks_shapes():
    x, dt, A_log, Bm, Cm, _ = _inputs(1, 2, 16, 2, 32, 32, False)
    t = [torch.from_numpy(a) for a in (x, dt, A_log, Bm, Cm)]
    with pytest.raises(ValueError):
        ssd_scan(t[0], t[1][:, :8], *t[2:])
    with pytest.raises(ValueError):
        ssd_scan(*t, torch.zeros(2, 2, 32, 16))


def test_work_counts_the_triangle_and_the_shared_b_c():
    """``cases.ssd_work``: bytes of every input and output once (B and C
    once per row); operations chunk by chunk over the valid steps."""
    B, S, nh, hp, ds, Q = 2, 100, 3, 32, 16, 64
    x, dt, A_log, Bm, Cm, _ = _inputs(2, B, S, nh, hp, ds, False)
    args = tuple(torch.from_numpy(a) for a in (x, dt, A_log, Bm, Cm)) + \
        (None, Q)
    out = ssd_scan(*args)
    nbytes, ops = cases.ssd_work(args, out)
    assert nbytes == sum(a.nbytes for a in (x, dt, A_log, Bm, Cm)) + \
        out[0].numel() * 4 + out[1].numel() * 4
    want = 0
    for v, state_in in ((64, False), (36, True)):
        tri = v * (v + 1) // 2
        want += 2 * tri * ds + nh * (2 * tri * hp + 2 * v * ds * hp
                                     + (2 * v * ds * hp if state_in else 0))
    assert ops == B * want
