"""The port's page pool against the reference's, operation by operation.

``repro_torch.serving.kv_pool`` is the port's own copy of the reference's
pure-bookkeeping ``repro.serving.kv_pool``. The same operation sequence
(alloc with prefix hits, append with copy-on-write, fork, free, prefix
retention, exhaustion) drives both pools; after every operation the whole
integer state must be equal: page tables, refcounts, the free list, the
retention LRU, commitments, the prefix index and every counter.
Exceptions must match in type.
"""
import numpy as np
import pytest

from repro.serving import kv_pool as jpool
from repro_torch.serving import kv_pool as tpool


def _table_state(t):
    return (list(t.pages), t.length, t.budget, t.shared_tokens, t.alive,
            t.last_page_len)


def _pool_state(p):
    return dict(
        free=list(p._free), ref=p._ref.tolist(), epoch=p._epoch.tolist(),
        indexed=p._indexed_epoch.tolist(), retained=list(p._retained),
        committed=p._committed, index=dict(p._index),
        tables=sorted(_table_state(t) for t in p._tables),
        counters=(p.prefix_hits, p.prefix_tokens_shared, p.cow_forks,
                  p.peak_pages_in_use, p.retention_evictions),
        gauges=(p.pages_in_use, p.prefix_pages_retained, p.available))


class Lockstep:
    """Both pools, their tables by index, compared after every call."""

    def __init__(self, num_pages, page_size, keep):
        self.pools = (jpool.KVPagePool(num_pages, page_size, keep),
                      tpool.KVPagePool(num_pages, page_size, keep))
        self.tables = []            # [(reference table, port table)]
        self.ops = 0

    def call(self, name, *args, table=None):
        outs = []
        for side, pool in enumerate(self.pools):
            a = args if table is None else (self.tables[table][side],) + args
            try:
                outs.append(("ok", getattr(pool, name)(*a)))
            except (jpool.PoolExhausted, tpool.PoolExhausted) as e:
                outs.append(("exhausted", str(e)))
            except (RuntimeError, ValueError) as e:
                outs.append((type(e).__name__, str(e)))
        (jk, jv), (tk, tv) = outs
        assert jk == tk, (name, outs)
        self.check()
        self.ops += 1
        return jk, jv, tv

    def check(self):
        js, ts = (_pool_state(p) for p in self.pools)
        assert js == ts
        for jt, tt in self.tables:
            assert _table_state(jt) == _table_state(tt)
        for p in self.pools:
            p.check_invariants()


def _overcommits(ls, prompt, total):
    """The reference pool's one known edge (ROADMAP Queue 3): an admission
    that adopts prefix pages parked in the retention LRU checks its need
    against ``available`` BEFORE those pages leave the LRU, so it can
    commit more pages than the pool then holds. Both pools share it;
    the random sequences step around it (and count the state equal up to
    there)."""
    _, (shared, _), _ = ls.call("_match", prompt)
    pool = ls.pools[1]
    revived = sum(p in pool._retained for p in shared)
    need = pool.pages_for(total) - len(shared)
    return pool.available - revived < need <= pool.available


def _plan(plan):
    return (plan.page, plan.slot, plan.cow_src)


def test_scenario_prefix_hit_cow_fork_retention_exhaustion():
    ls = Lockstep(num_pages=12, page_size=4, keep=3)
    shared = np.arange(100, 110, dtype=np.int32)         # 2 full pages + 2
    # a cold admission, registered after its (notional) prefill
    k, jt, tt = ls.call("alloc_prompt", shared, 14)
    assert k == "ok" and jt[1] == tt[1] == 0
    ls.tables.append((jt[0], tt[0]))
    for side, pool in enumerate(ls.pools):
        pool.register(shared, ls.tables[0][side])
    ls.check()
    # a prompt that opens with the same two full pages: a prefix hit
    p2 = np.concatenate([shared[:8], np.int32([7, 7, 7])])
    k, jt, tt = ls.call("alloc_prompt", p2, 13)
    assert jt[1] == tt[1] == 8
    ls.tables.append((jt[0], tt[0]))
    # appends: the first table's partial last page is its own (no COW)
    for _ in range(3):
        _, jp, tp = ls.call("prepare_append", table=0)
        assert _plan(jp) == _plan(tp)
        ls.call("commit_append", table=0)
    # fork the second table: the child shares its partial last page,
    # whose next append copies on write
    _, jc, tc = ls.call("fork", 13, table=1)
    ls.tables.append((jc, tc))
    _, jp, tp = ls.call("prepare_append", table=2)
    assert _plan(jp) == _plan(tp) and jp.cow_src is not None
    ls.call("commit_append", table=2)
    assert ls.pools[0].cow_forks == ls.pools[1].cow_forks == 1
    # free all: the registered prefix pages park in the retention LRU
    for i in range(3):
        ls.call("free", table=i)
    assert ls.pools[1].prefix_pages_retained == 2
    # a double free raises on both sides
    k, _, _ = ls.call("free", table=0)
    assert k == "RuntimeError"
    # the retained prefix is adopted back by the next matching prompt
    k, jt, tt = ls.call("alloc_prompt", shared, 12)
    assert jt[1] == tt[1] == 8
    ls.tables.append((jt[0], tt[0]))
    # exhaustion: more than the pool can commit
    assert not ls.pools[1].can_admit(np.arange(40, dtype=np.int32), 48)
    k, _, _ = ls.call("alloc_prompt", np.arange(40, dtype=np.int32), 48)
    assert k == "exhausted"
    j_csr = ls.pools[0].page_table_arrays([ls.tables[3][0]])
    t_csr = ls.pools[1].page_table_arrays([ls.tables[3][1]])
    for a, b in zip(j_csr, t_csr):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,num_pages,page_size,keep", [
    (0, 16, 4, 0), (1, 16, 4, 4), (2, 24, 8, 6), (3, 9, 2, 3),
    (4, 32, 4, 8)])
def test_random_operation_sequences_agree(seed, num_pages, page_size, keep):
    """Seeded random sequences over prompts drawn from a few shared
    prefixes, so prefix hits, COW, forks, retention and exhaustion all
    occur."""
    rng = np.random.default_rng(seed)
    ls = Lockstep(num_pages, page_size, keep)
    stems = [rng.integers(0, 50, 3 * page_size).astype(np.int32)
             for _ in range(3)]
    live = []                       # indices into ls.tables
    for _ in range(160):
        op = rng.choice(["alloc", "append", "fork", "free"],
                        p=[0.3, 0.4, 0.1, 0.2])
        if op == "alloc" or not live:
            stem = stems[rng.integers(len(stems))]
            n = int(rng.integers(1, 3 * page_size + 1))
            tail = rng.integers(0, 50, int(rng.integers(0, 4)))
            prompt = np.concatenate([stem[:n], tail]).astype(np.int32)
            total = len(prompt) + int(rng.integers(0, 2 * page_size))
            ls.call("can_admit", prompt, total)
            if _overcommits(ls, prompt, total):
                continue
            k, jt, tt = ls.call("alloc_prompt", prompt, total)
            if k == "ok":
                assert jt[1] == tt[1]
                ls.tables.append((jt[0], tt[0]))
                live.append(len(ls.tables) - 1)
                if rng.random() < 0.7:
                    for side, pool in enumerate(ls.pools):
                        pool.register(prompt, ls.tables[-1][side])
                    ls.check()
            continue
        i = live[int(rng.integers(len(live)))]
        if op == "append":
            k, jp, tp = ls.call("prepare_append", table=i)
            if k == "ok":
                assert _plan(jp) == _plan(tp)
                ls.call("commit_append", table=i)
        elif op == "fork":
            total = ls.tables[i][1].length + int(rng.integers(0, 6))
            k, jc, tc = ls.call("fork", total, table=i)
            if k == "ok":
                ls.tables.append((jc, tc))
                live.append(len(ls.tables) - 1)
        else:
            ls.call("free", table=i)
            live.remove(i)
    j, t = ls.pools
    print(f"\n{ls.ops} ops: prefix_hits={t.prefix_hits} "
          f"cow_forks={t.cow_forks} evictions={t.retention_evictions} "
          f"peak={t.peak_pages_in_use}")
    assert (j.prefix_hits, j.cow_forks) == (t.prefix_hits, t.cow_forks)


def test_retained_prefix_overcommit_edge_is_shared():
    """The edge ``_overcommits`` steps around, driven on purpose: the
    port's pool reproduces the reference's state there too (both then
    fail their own invariant audit)."""
    pools = (jpool.KVPagePool(4, 2, 2), tpool.KVPagePool(4, 2, 2))
    stem = np.arange(4, dtype=np.int32)
    for pool in pools:
        t, _ = pool.alloc_prompt(stem, 4)
        pool.register(stem, t)
        pool.free(t)
        assert pool.prefix_pages_retained == 2 and pool.available == 4
        prompt = np.concatenate([stem, np.int32([9, 9])])
        assert pool.can_admit(prompt, 12)
        t2, shared = pool.alloc_prompt(prompt, 12)
        assert shared == 4
        with pytest.raises(AssertionError, match="over-committed"):
            pool.check_invariants()
    assert _pool_state(pools[0]) == _pool_state(pools[1])
