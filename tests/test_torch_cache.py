"""The port's host-side expert cache (``repro_torch.core.cache``) against
the reference's (``repro.core.cache``), for lru and fifo, and for the
static random policy fed identical initial tags.

Everything here is integer state, so everything must match exactly:
tags, ages, clock and in-flight flags after every access, and each
access's hits, ways and speculative-hit flags. The seeded streams repeat
experts within a step, mask picks (-1), address layers beyond the cache's
coverage, and start from states holding PENDING and SPEC reservations so
``land`` and the flag paths are exercised although the port has no
``reserve`` yet.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro_torch.config import CacheConfig  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402

torch.set_num_threads(2)

N, M, E, L = 3, 2, 8, 5          # layers 3 and 4 are beyond coverage
FIELDS = ("tags", "age", "clock", "in_flight")


def _random_state(rng, flags: bool):
    tags = np.full((N, M), -1, np.int32)
    for i in range(N):
        k = int(rng.integers(0, M + 1))
        tags[i, :k] = rng.choice(E, k, replace=False)
    age = np.where(tags >= 0, rng.integers(0, 20, (N, M)), 0).astype(np.int32)
    fl = rng.integers(0, 3, (N, M)) if flags else np.zeros((N, M))
    fl = np.where(tags >= 0, fl, 0).astype(np.int32)
    clock = np.int32(20)
    j = jcache.CacheState(jnp.asarray(tags), jnp.asarray(age),
                          jnp.asarray(clock), jnp.asarray(fl))
    t = tcache.CacheState(torch.from_numpy(tags), torch.from_numpy(age),
                          torch.tensor(clock), torch.from_numpy(fl))
    return j, t


def _assert_same_state(t, j):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


def _picks(rng):
    A = int(rng.integers(1, 9))
    e = rng.integers(-1, E, A)
    e = np.where(rng.random(A) < 0.4, e % 3, e)    # skew: repeats and hits
    return e.astype(np.int32)


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("flags", [False, True])
def test_access_ex_stream_matches_reference(policy, flags):
    rng = np.random.default_rng(0 if policy == "lru" else 1)
    js, ts = _random_state(rng, flags)
    for _ in range(60):
        layer = int(rng.integers(0, L))
        e = _picks(rng)
        if rng.random() < 0.5:
            js, ts = jcache.land(js), tcache.land(ts)
            _assert_same_state(ts, js)
        js, jh, jw, jsp = jcache.access_ex(js, jnp.int32(layer),
                                           jnp.asarray(e), policy)
        ts, th, tw, tsp = tcache.access_ex(ts, layer, torch.from_numpy(e),
                                           policy)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
        _assert_same_state(ts, js)


@pytest.mark.parametrize("flags", [False, True])
def test_random_policy_matches_reference_on_same_tags(flags):
    rng = np.random.default_rng(2)
    js, ts = _random_state(rng, flags)
    for _ in range(30):
        layer = int(rng.integers(0, L))
        e = _picks(rng)
        js2, jh, jw, jsp = jcache.access_ex(js, jnp.int32(layer),
                                            jnp.asarray(e), "random")
        ts2, th, tw, tsp = tcache.access_ex(ts, layer, torch.from_numpy(e),
                                            "random")
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
        _assert_same_state(ts2, js2)
        _assert_same_state(ts2, js)        # static: the state never moves


@pytest.mark.parametrize("flags", [False, True])
def test_lookup_matches_reference(flags):
    rng = np.random.default_rng(3)
    for _ in range(20):
        js, ts = _random_state(rng, flags)
        layer = int(rng.integers(0, L))
        e = _picks(rng)
        jh, jw = jcache.lookup(js, jnp.int32(layer), jnp.asarray(e))
        th, tw = tcache.lookup(ts, layer, torch.from_numpy(e))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_land_matches_reference():
    rng = np.random.default_rng(4)
    js, ts = _random_state(rng, True)
    assert (ts.in_flight == 2).any()
    _assert_same_state(tcache.land(ts), jcache.land(js))


@pytest.mark.parametrize("policy", ["lru", "fifo", "random"])
def test_init_cache_state_matches_reference(policy):
    jcfg = JaxCacheConfig(num_indexes=N, num_ways=M, policy=policy)
    tcfg = CacheConfig(num_indexes=N, num_ways=M, policy=policy)
    if policy == "random":
        import jax
        js = jcache.init_cache_state(jcfg, E, jax.random.PRNGKey(0))
        ts = tcache.init_cache_state(tcfg, E, torch.Generator().manual_seed(0))
        # other generators, other picks: M distinct experts per set
        for row in ts.tags.numpy():
            assert len(set(row.tolist())) == M and row.min() >= 0 \
                and row.max() < E
        for name in ("age", "clock", "in_flight"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        assert ts.tags.dtype == torch.int32
    else:
        _assert_same_state(tcache.init_cache_state(tcfg),
                           jcache.init_cache_state(jcfg))


def test_slot_id_matches_reference():
    for layer in range(N):
        for way in range(M):
            assert tcache.slot_id(layer, way, M) == \
                int(jcache.slot_id(jnp.int32(layer), jnp.int32(way), M))
