"""Global paged KV pool: fixed-size pages, refcounts, copy-on-write and
a hash prefix index (the port's own copy of the reference's
``serving/kv_pool.py``; pure bookkeeping, so its integer state matches
the reference's exactly).

Dense serving reserves ``capacity`` KV slots per scheduler slot for the
request's whole lifetime — worst-case memory, zero sharing. The pool
replaces that with the vLLM/flashinfer paging idiom: KV lives in ONE ``[num_pages, page_size, ...]`` tensor per
layer and a request holds an ordered list of physical page ids — its
*page table*, exported in CSR form as ``page_indptr`` / ``page_indices``
/ ``last_page_len``. Three mechanisms ride on the indirection:

  * refcounting + copy-on-write — a physical page may back several
    requests at once. Full pages are immutable while shared, so prefix
    sharing never copies anything; only :meth:`fork` (cloning a live
    request mid-generation) can leave a *partial* page shared, and the
    first side to append then copies it (:meth:`prepare_append` returns
    the copy plan; the engine performs the device copy).
  * prefix index — every full-page prompt prefix is registered under a
    hash of its tokens; a new request whose prompt starts with an
    indexed prefix adopts those pages (refcount bump, zero KV writes)
    and the engine skips the cache-warming replay for the shared span.
    Entries invalidate lazily: each page carries an epoch bumped when it
    returns to the free list, and lookups revalidate epochs.
  * commitment accounting — admission promises a request every page it
    could ever need (``ceil(total_tokens / page_size)`` minus what the
    prefix supplied). ``committed`` pages are subtracted from
    :meth:`available`, so an admitted request can always append inside
    its budget — decode never deadlocks on page exhaustion mid-request,
    and :meth:`can_admit` is the scheduler's backpressure signal.
  * eviction-aware prefix retention — with ``prefix_keep_pages > 0``, a
    retiring request's zero-ref pages that still back a live prefix-index
    entry park in a bounded LRU instead of returning to the free list
    (vLLM's cached-prefix idiom): their epochs stay valid, so a RAG-burst
    re-admission adopts them by reference. Retained pages are reclaimable
    — :meth:`available` counts them, and an allocation that outgrows the
    free list evicts the least-recently-retired first (epoch bump, index
    entries lazily invalidate).

Everything here is host-side bookkeeping (python lists + small numpy
arrays); the engine owns the device tensors and consumes page ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["KVPagePool", "PageTable", "AppendPlan", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list
    net of commitments — the paged equivalent of a full batch."""


@dataclass(eq=False)
class PageTable:
    """One request's view of the pool: ordered physical page ids plus the
    token count written so far and the pages still committed to it.
    Identity semantics — tables are keys in the pool's live set."""
    page_size: int
    pages: List[int]
    length: int                   # tokens written
    budget: int                   # pages still reserved for this table
    shared_tokens: int = 0        # prefix-index tokens adopted at alloc
    alive: bool = True

    @property
    def last_page_len(self) -> int:
        """Tokens held by the last page (flashinfer's ``last_page_len``)."""
        return self.length - (len(self.pages) - 1) * self.page_size


@dataclass(frozen=True)
class AppendPlan:
    """Where the next token's KV goes. ``cow_src`` set means the page was
    shared: the engine must copy page ``cow_src`` -> ``page`` on device
    before writing (copy-on-write)."""
    page: int                     # physical destination page
    slot: int                     # offset inside the page
    cow_src: Optional[int] = None


class KVPagePool:
    """Fixed-size page allocator with refcounts, CoW and a prefix index."""

    def __init__(self, num_pages: int, page_size: int,
                 prefix_keep_pages: int = 0):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"pool needs >= 1 page of >= 1 token, got "
                f"num_pages={num_pages}, page_size={page_size}")
        if prefix_keep_pages < 0:
            raise ValueError(
                f"prefix_keep_pages must be >= 0, got {prefix_keep_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_keep_pages = prefix_keep_pages
        # stack popped from the end: pages hand out in 0, 1, 2, ... order
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)
        self._epoch = np.zeros(num_pages, np.int64)
        # epoch at which page p last backed an index registration; equal
        # to _epoch[p] iff some index entry may still name it
        self._indexed_epoch = np.full(num_pages, -1, np.int64)
        # zero-ref prefix pages kept alive past their last sharer, oldest
        # retirement first (dict preserves insertion order)
        self._retained: Dict[int, None] = {}
        self._committed = 0
        self._tables: set = set()
        # prompt[:n*page_size].tobytes() -> (page ids, their epochs)
        self._index: Dict[bytes, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
        self.prefix_hits = 0
        self.prefix_tokens_shared = 0
        self.cow_forks = 0
        self.peak_pages_in_use = 0
        # cumulative retained-page reclaims (LRU evictions): the ledger
        # the trace's eviction instants are derived from at drain points
        self.retention_evictions = 0

    # -- geometry ----------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free) - len(self._retained)

    @property
    def prefix_pages_retained(self) -> int:
        """Zero-ref prefix pages parked in the retention LRU."""
        return len(self._retained)

    @property
    def available(self) -> int:
        """Pages an admission may claim: free plus reclaimable retained,
        minus already-committed."""
        return len(self._free) + len(self._retained) - self._committed

    # -- internal page plumbing --------------------------------------------
    def _evict_retained(self) -> int:
        """Reclaim the least-recently-retired retained page: its epoch
        bump lazily invalidates any index entry naming it."""
        p = next(iter(self._retained))
        del self._retained[p]
        self._epoch[p] += 1
        self.retention_evictions += 1
        return p

    def _take(self) -> int:
        if self._free:
            p = self._free.pop()
        elif self._retained:
            p = self._evict_retained()
        else:
            raise PoolExhausted("KV page free list is empty")
        self._ref[p] = 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return p

    @staticmethod
    def _tokens(prompt) -> np.ndarray:
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be [P], got {prompt.shape}")
        return prompt

    # -- prefix index ------------------------------------------------------
    def _match(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed full-page prefix of ``prompt`` whose pages are
        all still live (epoch unchanged since registration). Stale
        entries met along the way are dropped."""
        ps = self.page_size
        for n in range(len(prompt) // ps, 0, -1):
            key = prompt[:n * ps].tobytes()
            entry = self._index.get(key)
            if entry is None:
                continue
            pages, epochs = entry
            if all(self._epoch[p] == e for p, e in zip(pages, epochs)):
                return list(pages), n * ps
            del self._index[key]
        return [], 0

    def register(self, prompt, table: PageTable) -> None:
        """Index every full-page prefix of ``prompt`` against the table's
        leading physical pages. Call AFTER the KV is written to them —
        a lookup may adopt the pages on the very next admission. The
        partial last page (if any) is never indexed: decode appends
        mutate it."""
        prompt = self._tokens(prompt)
        ps = self.page_size
        for n in range(1, len(prompt) // ps + 1):
            pages = tuple(table.pages[:n])
            self._index[prompt[:n * ps].tobytes()] = (
                pages, tuple(int(self._epoch[p]) for p in pages))
            for p in pages:
                self._indexed_epoch[p] = self._epoch[p]
        if len(self._index) > 4 * self.num_pages:
            self._index = {
                k: (pgs, eps) for k, (pgs, eps) in self._index.items()
                if all(self._epoch[p] == e for p, e in zip(pgs, eps))}

    # -- request lifecycle -------------------------------------------------
    def can_admit(self, prompt, total_tokens: int) -> bool:
        """Would :meth:`alloc_prompt` succeed right now? (Admission
        capacity is a function of free pages and prefix hits, not slot
        count.)"""
        prompt = self._tokens(prompt)
        shared_pages, _ = self._match(prompt)
        need = self.pages_for(total_tokens) - len(shared_pages)
        return need <= self.available

    def alloc_prompt(self, prompt,
                     total_tokens: int) -> Tuple[PageTable, int]:
        """Claim pages for a prompt plus a committed budget through
        ``total_tokens`` (prompt + max new tokens). An indexed prefix
        supplies its pages by reference (no writes, no budget). Returns
        ``(table, shared_tokens)``."""
        prompt = self._tokens(prompt)
        P = len(prompt)
        if P < 1:
            raise ValueError("prompt must contain at least one token")
        if total_tokens < P:
            raise ValueError(
                f"total_tokens {total_tokens} < prompt length {P}")
        shared_pages, shared_toks = self._match(prompt)
        need_now = self.pages_for(P) - len(shared_pages)
        budget = self.pages_for(total_tokens) - self.pages_for(P)
        if need_now + budget > self.available:
            raise PoolExhausted(
                f"prompt needs {need_now} pages + {budget} committed, "
                f"pool has {self.available} available "
                f"({len(self._free)} free - {self._committed} committed)")
        for p in shared_pages:
            self._ref[p] += 1
            # a retained page's first new sharer revives it from the LRU
            if self._ref[p] == 1:
                self._retained.pop(p, None)
        pages = shared_pages + [self._take() for _ in range(need_now)]
        self._committed += budget
        table = PageTable(page_size=self.page_size, pages=pages, length=P,
                          budget=budget, shared_tokens=shared_toks)
        self._tables.add(table)
        if shared_toks:
            self.prefix_hits += 1
            self.prefix_tokens_shared += shared_toks
        return table, shared_toks

    def prepare_append(self, table: PageTable) -> AppendPlan:
        """Plan the write of token ``table.length`` (the engine writes
        the KV on device, then calls :meth:`commit_append`). Draws a
        fresh page from the table's budget at a page boundary, and
        copy-on-writes a shared partial last page. Idempotent until the
        commit — a step retried after a crash never double-allocates."""
        if not table.alive:
            raise RuntimeError("append on a freed page table")
        ps = self.page_size
        pos = table.length
        if len(table.pages) < pos // ps + 1:     # page boundary: grow
            if table.budget < 1:
                raise PoolExhausted(
                    "append beyond the table's committed budget")
            p = self._take()
            table.budget -= 1
            self._committed -= 1
            table.pages.append(p)
            return AppendPlan(page=p, slot=pos % ps)
        last = table.pages[-1]
        if self._ref[last] > 1:                  # shared partial page: CoW
            if table.budget < 1:
                raise PoolExhausted(
                    "copy-on-write beyond the table's committed budget")
            p = self._take()
            table.budget -= 1
            self._committed -= 1
            self._ref[last] -= 1
            table.pages[-1] = p
            self.cow_forks += 1
            return AppendPlan(page=p, slot=pos % ps, cow_src=last)
        return AppendPlan(page=last, slot=pos % ps)

    def commit_append(self, table: PageTable) -> None:
        """The planned token's KV is on device: account for it."""
        if not table.alive:
            raise RuntimeError("commit on a freed page table")
        table.length += 1

    def fork(self, table: PageTable, total_tokens: int) -> PageTable:
        """Clone a live table copy-on-write: the child references every
        physical page (zero copies now). A partial last page becomes
        shared-mutable, so BOTH sides gain +1 budget as a CoW reserve —
        whichever appends first copies; the other side's unused reserve
        returns at :meth:`free`."""
        if not table.alive:
            raise RuntimeError("fork of a freed page table")
        if total_tokens < table.length:
            raise ValueError(
                f"total_tokens {total_tokens} < forked length "
                f"{table.length}")
        reserve = 1 if table.length % self.page_size else 0
        child_budget = self.pages_for(total_tokens) \
            - self.pages_for(table.length)
        if child_budget + 2 * reserve > self.available:
            raise PoolExhausted(
                f"fork needs {child_budget + 2 * reserve} committed "
                f"pages, pool has {self.available} available")
        for p in table.pages:
            self._ref[p] += 1
        child = PageTable(page_size=self.page_size,
                          pages=list(table.pages), length=table.length,
                          budget=child_budget + reserve)
        table.budget += reserve
        self._committed += child_budget + 2 * reserve
        self._tables.add(child)
        return child

    def free(self, table: PageTable) -> None:
        """Release a table: refcounts drop, zero-ref pages return to the
        free list (their epoch bump lazily invalidates index entries),
        unused budget returns to the admission pool. With retention on,
        zero-ref pages that still back a live index entry park in the
        retention LRU instead (epoch untouched, so the prefix stays
        adoptable); pages deepest in the prompt retire as the coldest so
        trimming preserves the shortest (most reusable) prefixes longest.
        Raises on a second free of the same table."""
        if not table.alive:
            raise RuntimeError("page table already freed")
        table.alive = False
        self._tables.discard(table)
        self._committed -= table.budget
        table.budget = 0
        for p in reversed(table.pages):
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if self.prefix_keep_pages > 0 \
                        and self._indexed_epoch[p] == self._epoch[p]:
                    self._retained[p] = None
                else:
                    self._epoch[p] += 1
                    self._free.append(p)
        while len(self._retained) > self.prefix_keep_pages:
            self._free.append(self._evict_retained())
        table.pages = []

    # -- views / self-checks ----------------------------------------------
    def page_table_arrays(self, tables: Sequence[PageTable]
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR page tables for a request batch — the flashinfer layout
        the paged attention kernels consume: ``(page_indptr [B+1],
        page_indices [sum pages], last_page_len [B])``."""
        indptr = np.zeros(len(tables) + 1, np.int32)
        for i, t in enumerate(tables):
            indptr[i + 1] = indptr[i] + len(t.pages)
        indices = np.concatenate(
            [np.asarray(t.pages, np.int32) for t in tables]) \
            if tables else np.zeros(0, np.int32)
        lastlen = np.array([t.last_page_len for t in tables], np.int32)
        return indptr, indices, lastlen

    def check_invariants(self) -> None:
        """Every page is free XOR retained XOR referenced, refcounts
        equal the live tables' usage, the free list holds no duplicates,
        and commitments never exceed the reclaimable pages. The
        hypothesis property test drives this after every operation."""
        ref = np.zeros(self.num_pages, np.int64)
        for t in self._tables:
            assert t.alive, "freed table still registered live"
            assert 0 < t.length <= len(t.pages) * self.page_size, \
                (t.length, len(t.pages))
            assert t.budget >= 0
            for p in t.pages:
                ref[p] += 1
        assert (ref == self._ref).all(), "refcount drift"
        assert len(set(self._free)) == len(self._free), "double-freed page"
        assert all(self._ref[p] == 0 for p in self._free), \
            "referenced page on the free list"
        assert len(self._retained) <= self.prefix_keep_pages, \
            "retention LRU over its bound"
        assert not set(self._retained) & set(self._free), \
            "page both free and retained"
        assert all(self._ref[p] == 0 for p in self._retained), \
            "referenced page in the retention LRU"
        assert all(self._indexed_epoch[p] == self._epoch[p]
                   for p in self._retained), "retained page not indexed"
        assert len(self._free) + len(self._retained) \
            + int((self._ref > 0).sum()) == self.num_pages, "leaked pages"
        assert self._committed == sum(t.budget for t in self._tables), \
            "commitment drift"
        assert 0 <= self._committed <= len(self._free) \
            + len(self._retained), "over-committed"
