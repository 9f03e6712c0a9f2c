"""The chunk-parallel algorithm of the CUDA ``ssd_scan`` kernels, in plain
PyTorch (``ssd_scan_chunked_plain``), against the JAX reference and the
port's one-chunk-at-a-time plain version.

The kernels compute every chunk's own state at once, then the chunk states
in chunk order, then every chunk's output from its incoming state; the
products run on bf16 tensor cores with the fp32 operand split into bf16 hi
+ lo. A CUDA kernel cannot run here, so the mirror carries the same
algorithm and the same split, and these tests show that the scheme meets
the tolerances before the card sees it. ``tests/test_torch_gpu.py`` holds
the kernels to ``ssd_scan_plain`` on the card.

Tolerances, as ``tests/test_torch_ssd_scan.py`` states them:
- against ``repro.models.ssm.ssd_chunked`` with bf16 x: y within one bf16
  rounding of its largest value (2^-7 max|y|), h (fp32) within 1e-4 of
  max|h| (fp32 sums in another order);
- against ``ref.ssd_multi_chunk_ref`` per head, fp32 throughout: 5e-4;
- against ``ssd_scan_plain``: the card check's tolerances
  (``chip_smoke.py::_compare``), 2^-7 max|y| and 2^-13 max|h|; the split
  leaves about 2^-17 of each fp32 operand.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd_scan import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

torch.set_num_threads(2)

Y_REL = 2 ** -7
H_REL = 1e-4
CARD_H_REL = 2 ** -13
PALLAS_TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(seed, B, S, nh, hp, ds, h0):
    """numpy inputs at the model's scales, as in test_torch_ssd_scan."""
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
    j = jnp.asarray(a, jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = rel * np.abs(want).max()
    assert np.isfinite(got).all(), what
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


# B, S, nh, hp, ds, chunk, h0: the reduced widths (hp 32, ds 32, chunk 64)
# with a ragged tail; mamba2-370m's head widths (hp 64, ds 128, chunk 256):
# full chunks, a ragged tail with an incoming state, S < chunk, exactly one
# chunk, a last chunk of one step
CASES = [
    (2, 200, 4, 32, 32, 64, True),
    (1, 128, 3, 32, 32, 64, False),
    (1, 512, 2, 64, 128, 256, False),
    (2, 300, 2, 64, 128, 256, True),
    (3, 37, 2, 64, 128, 256, False),
    (2, 256, 2, 64, 128, 256, True),
    (1, 513, 2, 64, 128, 256, False),
    # jamba-v0.1-52b's Mamba widths (hp 64, ds 16, chunk 256): full chunks
    # with a ragged tail and an incoming state, a single short chunk
    (2, 600, 3, 64, 16, 256, True),
    (1, 100, 4, 64, 16, 256, False),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunk_parallel_matches_model_ssd_chunked(case):
    B, S, nh, hp, ds, chunk, h0 = case
    x, dt, A_log, Bm, Cm, state = _inputs(sum(case[:6]), B, S, nh, hp, ds,
                                          h0)
    jx, tx = _bf16(x)
    jB, tB = _bf16(Bm)
    jC, tC = _bf16(Cm)
    jy, jh = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A_log), jB,
                              jC, None if state is None
                              else jnp.asarray(state), chunk=chunk)
    ty, th = ops.ssd_scan_chunked_plain(
        tx, torch.from_numpy(dt), torch.from_numpy(A_log), tB, tC,
        None if state is None else torch.from_numpy(state), chunk)
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    assert tuple(ty.shape) == (B, S, nh, hp)
    assert tuple(th.shape) == (B, nh, ds, hp)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), Y_REL, "y")
    _close(th.numpy(), np.asarray(jh), H_REL, "h")


@pytest.mark.parametrize("case", [c for c in CASES if c[4] == 16], ids=str)
def test_plain_scan_matches_model_ssd_chunked_at_d_state_16(case):
    """``ssd_scan_plain`` (what the CPU runs, and what the card check holds
    the kernels to) at jamba's widths against the reference's
    ``ssd_chunked``: y within one bf16 rounding, h within 1e-4."""
    B, S, nh, hp, ds, chunk, h0 = case
    x, dt, A_log, Bm, Cm, state = _inputs(sum(case[:6]) + 2, B, S, nh, hp,
                                          ds, h0)
    jx, tx = _bf16(x)
    jB, tB = _bf16(Bm)
    jC, tC = _bf16(Cm)
    jy, jh = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A_log), jB,
                              jC, None if state is None
                              else jnp.asarray(state), chunk=chunk)
    ty, th = ops.ssd_scan_plain(
        tx, torch.from_numpy(dt), torch.from_numpy(A_log), tB, tC,
        None if state is None else torch.from_numpy(state), chunk)
    assert tuple(th.shape) == (B, nh, ds, hp)
    _close(ty.float().numpy(), np.asarray(jy, np.float32), Y_REL, "y")
    _close(th.numpy(), np.asarray(jh), H_REL, "h")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunk_parallel_meets_the_card_tolerances(case):
    """Against the one-chunk-at-a-time plain version that the card check
    holds the kernels to, at that check's tolerances."""
    B, S, nh, hp, ds, chunk, h0 = case
    args = [torch.from_numpy(a) if a is not None else None
            for a in _inputs(sum(case[:6]) + 1, B, S, nh, hp, ds, h0)]
    for i in (0, 3, 4):                       # x, B, C in bf16
        args[i] = args[i].to(torch.bfloat16)
    y, h = ops.ssd_scan_chunked_plain(*args, chunk)
    y_want, h_want = ops.ssd_scan_plain(*args, chunk)
    _close(y.float().numpy(), y_want.float().numpy(), Y_REL, "y")
    _close(h.numpy(), h_want.numpy(), CARD_H_REL, "h")


@pytest.mark.parametrize("hp, ds, Q, n", [(32, 32, 64, 3), (64, 128, 256, 2),
                                         (64, 16, 256, 2)])
def test_chunk_parallel_matches_multi_chunk_ref_per_head(hp, ds, Q, n):
    """``ref.ssd_multi_chunk_ref`` takes one head's a = -exp(A_log) dt and
    dt-scaled x, chunk by chunk, from a given state; fp32 throughout."""
    B, nh, S = 2, 2, Q * n
    x, dt, A_log, Bm, Cm, state = _inputs(5 + hp, B, S, nh, hp, ds, True)
    ty, th = ops.ssd_scan_chunked_plain(
        *(torch.from_numpy(a) for a in (x, dt, A_log, Bm, Cm, state)), Q)
    a = -np.exp(A_log) * dt
    xd = x * dt[..., None]
    for b in range(B):
        for hd in range(nh):
            y_ref, h_ref = jref.ssd_multi_chunk_ref(
                jnp.asarray(a[b, :, hd].reshape(n, Q)),
                jnp.asarray(xd[b, :, hd].reshape(n, Q, hp)),
                jnp.asarray(Bm[b].reshape(n, Q, ds)),
                jnp.asarray(Cm[b].reshape(n, Q, ds)),
                jnp.asarray(state[b, hd]))
            np.testing.assert_allclose(ty[b, :, hd].numpy(),
                                       np.asarray(y_ref).reshape(S, hp),
                                       **PALLAS_TOL)
            np.testing.assert_allclose(th[b, hd].numpy(), np.asarray(h_ref),
                                       **PALLAS_TOL)


def test_split_leaves_about_two_to_the_minus_17():
    """hi + lo, each bf16, carries v to within 2^-16 of |v| (2^-17 from the
    rounding of lo, at most twice that in the worst binade)."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 100
    err = (ops._split(v) - v).abs()
    assert (err <= 2 ** -16 * v.abs()).all()
    assert not torch.equal(v.to(torch.bfloat16).float(), v)
