"""The port's two-tier collaborative MoE stages against the reference's
(``repro.core.collaborative``): probe -> execute -> commit over a seeded
stream of decode steps that hits, misses, evicts, moves ways, masks rows
and repeats experts.

Exact: hits, fetched experts, cache tags/ages/flags and the slot buffer
contents (both sides copy the same weights). Tolerance on y: fp32 weights
and activations, so the grouped products agree to fp32 rounding of a
sum of D = 32 terms (1e-5); bf16 runs agree to bf16 rounding (2e-2).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.core import collaborative as jcollab  # noqa: E402
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.config import CacheConfig  # noqa: E402
from repro_torch.core import collaborative as tcollab  # noqa: E402

torch.set_num_threads(2)

L, E, D, F, T, K = 3, 6, 32, 48, 4, 2


def _weights(rng, dtype):
    ws = [rng.standard_normal((L, E, D, F)), rng.standard_normal((L, E, D, F)),
          rng.standard_normal((L, E, F, D))]
    return [np.asarray(jnp.asarray(w * 0.2, dtype)) for w in ws]


def _steps(rng, n):
    """Seeded decode steps: (layer, top_i [T, K] distinct per row, top_w,
    active [T])."""
    out = []
    for _ in range(n):
        layer = int(rng.integers(0, L))
        top_i = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
        # skew toward a few experts so the small cache both hits and evicts
        top_i = np.where(rng.random((T, K)) < 0.5, top_i % 3, top_i)
        for t in range(T):
            if top_i[t, 0] == top_i[t, 1]:
                top_i[t, 1] = (top_i[t, 0] + 1) % E
        w = rng.random((T, K)).astype(np.float32)
        w /= w.sum(-1, keepdims=True)
        active = rng.random(T) < 0.8
        out.append((layer, top_i.astype(np.int32), w, active))
    return out


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_execute_commit_match_reference(policy, dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    w1, w3, w2 = _weights(rng, jdt)
    jcfg = JaxCacheConfig(num_indexes=2, num_ways=2, policy=policy)
    tcfg = CacheConfig(num_indexes=2, num_ways=2, policy=policy)
    jt = jcollab.init_tiers(jnp.asarray(w1), jnp.asarray(w3), jnp.asarray(w2),
                            jcfg, num_experts=E)
    tt = tcollab.init_tiers(*(tensor_from_numpy(w) for w in (w1, w3, w2)),
                            tcfg, num_experts=E, device="cpu")
    for layer, top_i, top_w, active in _steps(rng, 40):
        x = np.asarray(jnp.asarray(rng.standard_normal((T, D)), jdt))
        jpr = jcollab.probe(jt, jnp.int32(layer), jnp.asarray(top_i), jcfg,
                            active=jnp.asarray(active))
        jy, jhost = jcollab.execute(jt, jnp.int32(layer), jnp.asarray(x),
                                    jnp.asarray(top_w), jpr, jcfg)
        jt, jfetch = jcollab.commit(jt, jnp.int32(layer), jpr, jhost, jcfg)

        tpr = tcollab.probe(tt, layer, torch.from_numpy(top_i), tcfg,
                            active=torch.from_numpy(active))
        ty, staged = tcollab.execute(tt, layer, tensor_from_numpy(x),
                                     torch.from_numpy(top_w), tpr, tcfg)
        tt, tfetch = tcollab.commit(tt, layer, tpr, staged, tcfg)

        np.testing.assert_array_equal(tpr.hits.numpy(), np.asarray(jpr.hits))
        np.testing.assert_array_equal(tpr.rep_e.numpy(),
                                      np.asarray(jpr.rep_e))
        np.testing.assert_array_equal(tpr.resident.numpy(),
                                      np.asarray(jpr.resident))
        np.testing.assert_array_equal(tfetch.numpy(), np.asarray(jfetch))
        for name in ("tags", "age", "clock", "in_flight"):
            np.testing.assert_array_equal(
                getattr(tt.state, name).numpy(),
                np.asarray(getattr(jt.state, name)), err_msg=name)
        for tslot, jslot in zip(tt.slots, (jt.slot_w1, jt.slot_w3,
                                           jt.slot_w2)):
            np.testing.assert_array_equal(
                tensor_to_numpy(tslot), np.asarray(jslot).view(
                    np.uint16 if dtype == "bfloat16" else np.float32))
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy, np.float32), **tol)
        stats = tcollab._stats(tpr, tfetch)
        jstats = jcollab._stats(jpr, jfetch)
        for k in ("hits", "accesses", "host_flops_assignments",
                  "fetched_experts", "prefetch_hits"):
            assert stats[k] == int(jstats[k]), k


def test_group_by_expert_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(20):
        A = int(rng.integers(1, 12))
        flat = rng.integers(-1, E, A).astype(np.int32)
        want = jcollab._group_by_expert(jnp.asarray(flat), E)
        got = tcollab._group_by_expert(torch.from_numpy(flat), E)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_policy_preloads_pinned_experts():
    rng = np.random.default_rng(2)
    w1, w3, w2 = _weights(rng, jnp.float32)
    tcfg = CacheConfig(num_indexes=2, num_ways=2, policy="random")
    tt = tcollab.init_tiers(*(tensor_from_numpy(w) for w in (w1, w3, w2)),
                            tcfg, num_experts=E,
                            generator=torch.Generator().manual_seed(0))
    for i in range(2):
        for j in range(2):
            e = int(tt.state.tags[i, j])
            np.testing.assert_array_equal(tt.slot_w1[i * 2 + j].numpy(),
                                          w1[i, e])
