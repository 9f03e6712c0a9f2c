"""Two-tier collaborative MoE execution — the paper's workflow (Fig. 4) on
one GPU (counterpart of the reference's ``core/collaborative.py``):

  probe    — land in-flight reservations, service the router's top-k picks
             against the host-side set-associative cache
             (:mod:`repro_torch.core.cache`) and bucket the step's
             assignments by unique expert. The picks must be on the host:
             reading them is the one device->host sync of a MoE layer,
             which the engine makes just before the probe (its ``picks``
             phase).
  execute  — grouped: the assignments run through a [G, A, D] dispatch
             buffer and the hand-written grouped kernels
             (:func:`repro_torch.kernels.moe_gmm.moe_ffn`). Each unique
             expert's weights are staged ONCE per step into a [G, D, F]
             buffer on the device — resident experts from the slot buffer
             in HBM (device copy), the others from the host tier in pinned
             memory (asynchronous host->device copy). Padded groups are not
             staged at all. With a host lane (:func:`execute_lanes`, the
             paper's CPU compute of cache misses) the groups it takes skip
             the staging: their rows of the dispatch buffer go to the host,
             a thread pool runs their FFN over the pinned tier, and the
             outputs come back before the combine.
  commit   — install the probe's cache state and post-fetch the newly
             inserted experts into their slots, once per unique expert.
             Experts staged from the host this step are copied from the
             staging buffer; the rest (an expert that was resident but
             moved way, or one the host lane computed) from the host tier.
  prefetch — speculative cross-layer prefetch: reserve slots for the
             experts the next layer's router is predicted to pick and copy
             their weights in from the host tier. A reservation stays
             PENDING (invisible) until the next probe lands it.

The post-fetch and the prefetch write the slots on a second CUDA stream,
the copy stream the tiers own (:class:`CopyStream`, the paper's second
copy engine), off the compute stream's critical path. They feed only later
probes. Ordering: (a) the copy stream waits for the compute stream's work
issued so far before it writes, since this step's staging may still read a
slot being overwritten; (b) a probe of layer l makes the compute stream
wait for the last copy into layer l's slots before its staging reads them;
(c) a staging buffer a copy reads is kept from the allocator until the
copy ends; (d) on the CPU there is no stream and copies are synchronous.

The engine's prefill forward reads the tiers as well
(:class:`ForwardExperts`): each layer's whole [E, ...] table, resident
experts copied from their slots on the compute stream and the rest from
the host tier on the copy stream, queued one layer ahead, so layer l+1's
misses cross PCIe while layer l computes. The cache state and the slots
are only read, under the same ordering (a), (b) and (d); the compute
stream waits for a layer's host copies before it reads its table.

Tiers: ``host_*`` [L, E, D, F|F, D] in host memory (pinned on a GPU), the
slot buffers ``slot_*`` [N*M, D, F|F, D] on the compute device, updated IN
PLACE by commit and prefetch; the cache state is replaced functionally.

Copies by route (:func:`copy_bytes`, counted on the host from the probe,
the staged groups and the fetch mask, whole experts of ``w1 + w3 + w2``):
staging reads resident experts device to device (``stage_d2d_bytes``) and
the others host to device (``stage_h2d_bytes``), both on the compute
stream; the post-fetch writes slots from the staging buffer
(``slot_d2d_bytes``) or from the host tier (``slot_h2d_bytes``), on the
copy stream. The prefetch's slot writes are not counted.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import CacheConfig
from repro_torch.kernels.moe_gmm import moe_ffn
from repro_torch.models.layers import mm, silu
from . import cache as cache_lib


Copies = List[Tuple[torch.Tensor, torch.Tensor]]     # (dst, src) pairs


class CopyStream:
    """The second CUDA stream that slot writes and a forward's host-tier
    reads run on, with the event of the last copy into each layer's slots
    (no stream on the CPU). The only code that touches the stream."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._last: Dict[int, torch.cuda.Event] = {}

    def queue(self, copies: Copies, keep: Tuple[torch.Tensor, ...] = ()
              ) -> Optional[torch.cuda.Event]:
        """Copy each (dst, src) pair of ``copies``: on the copy stream after
        the compute stream's work so far (a); the tensors of ``keep``,
        which the copies read, stay allocated until they end (c). On the
        CPU, synchronously (d). Returns the event of their end, None when
        nothing was queued."""
        if not copies:
            return None
        if self.stream is None:
            for dst, src in copies:
                dst.copy_(src)
            return None
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            for dst, src in copies:
                dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        for t in keep:
            t.record_stream(self.stream)
        return done

    def join(self, done: Optional[torch.cuda.Event]) -> None:
        """(b) The compute stream waits for ``done`` (from :meth:`queue`):
        whatever it queues next, a read of what the copies wrote or an
        allocation over their memory once freed, comes after them."""
        if done is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(done)

    def write(self, layer: int, writes: Copies,
              keep: Tuple[torch.Tensor, ...] = ()) -> None:
        """:meth:`queue` copies into ``layer``'s slots, remembered until the
        layer's next :meth:`wait`."""
        done = self.queue(writes, keep)
        if done is not None:
            self._last[layer] = done

    def wait(self, layer: int) -> None:
        """The compute stream waits for the last copy into ``layer``'s
        slots; later compute work is ordered after it, so it waits once."""
        self.join(self._last.pop(layer, None))


class ExpertTiers(NamedTuple):
    """The two memory tiers of one model's expert weights."""
    host_w1: torch.Tensor     # [L, E, D, F], host memory
    host_w3: torch.Tensor
    host_w2: torch.Tensor     # [L, E, F, D]
    slot_w1: torch.Tensor     # [N*M, D, F], device
    slot_w3: torch.Tensor
    slot_w2: torch.Tensor     # [N*M, F, D]
    state: cache_lib.CacheState
    copy: CopyStream          # the slot writes' stream

    @property
    def host(self):
        return self.host_w1, self.host_w3, self.host_w2

    @property
    def slots(self):
        return self.slot_w1, self.slot_w3, self.slot_w2


def init_tiers(host_w1, host_w3, host_w2, ccfg: CacheConfig,
               num_experts: int = 0,
               generator: Optional[torch.Generator] = None,
               device=None) -> ExpertTiers:
    """Empty slot buffers on ``device`` over the given host tier; the
    static-random policy preloads its pinned experts."""
    S = ccfg.num_slots
    D, F = host_w1.shape[-2], host_w1.shape[-1]
    device = host_w1.device if device is None else torch.device(device)
    state = cache_lib.init_cache_state(ccfg, num_experts, generator)
    tiers = ExpertTiers(
        host_w1=host_w1, host_w3=host_w3, host_w2=host_w2,
        slot_w1=torch.zeros((S, D, F), dtype=host_w1.dtype, device=device),
        slot_w3=torch.zeros((S, D, F), dtype=host_w3.dtype, device=device),
        slot_w2=torch.zeros((S, F, D), dtype=host_w2.dtype, device=device),
        state=state, copy=CopyStream(device))
    if ccfg.policy == "random":
        for i in range(ccfg.num_indexes):
            for j in range(ccfg.num_ways):
                e = int(state.tags[i, j])
                for slot, host in zip(tiers.slots, tiers.host):
                    slot[i * ccfg.num_ways + j].copy_(host[i, e])
    return tiers


def _group_by_expert(flat_e: torch.Tensor, num_experts: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket assignments by expert id (sort-based). flat_e [A] int32 on
    the host (-1 = masked). Returns (gid [A], pos [A], rep_e [G]) with
    G = min(A, E+1); masked picks sort first into group 0 (rep_e -1)."""
    A = flat_e.shape[0]
    G = min(A, num_experts + 1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.ones(A, dtype=torch.bool)
    if A > 1:
        first[1:] = se[1:] != se[:-1]
    gid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
    ar = torch.arange(A)
    seg_start = torch.cummax(torch.where(first, ar, 0), 0).values
    pos_sorted = ar - seg_start
    inv = torch.empty_like(order)
    inv[order] = ar
    rep_e = torch.full((G,), -1, dtype=flat_e.dtype)
    keep = gid_sorted < G
    rep_e[gid_sorted[keep]] = se[keep]
    return (gid_sorted[inv].to(torch.int32), pos_sorted[inv].to(torch.int32),
            rep_e)


class ProbeResult(NamedTuple):
    """What probe() learned about one layer's picks (host tensors).

    state     — post-access cache state; commit() installs it.
    hits      — [A] reported demand hits.
    spec_hits — [A] hits on a landed speculative entry.
    valid     — [A] unmasked assignments.
    flat_e    — [A] expert per assignment (-1 = masked).
    gid/pos   — [A] group index / row within the group.
    rep_e     — [G] expert per group (-1 = padded group).
    resident  — [G] residency at probe time (read the slot buffer).
    res_way   — [G] way of resident groups.
    """
    state: cache_lib.CacheState
    hits: torch.Tensor
    spec_hits: torch.Tensor
    valid: torch.Tensor
    flat_e: torch.Tensor
    gid: torch.Tensor
    pos: torch.Tensor
    rep_e: torch.Tensor
    resident: torch.Tensor
    res_way: torch.Tensor


def probe(tiers: ExpertTiers, layer: int, top_i: torch.Tensor,
          ccfg: CacheConfig,
          active: Optional[torch.Tensor] = None) -> ProbeResult:
    """Stage 1 — cache check + grouping for one layer's top-k picks.
    ``top_i`` [T, K] and ``active`` [T] bool on the host (the engine reads
    the picks before the probe).
    Residency for execution is probed against the landed PRE-access state
    (a slot claimed this step holds its weights from the next step on).
    Landing is where the compute stream waits for the layer's slot copies."""
    T, K = top_i.shape
    flat_e = top_i.reshape(-1).to(torch.int32)
    if active is not None:
        flat_e = torch.where(active.repeat_interleave(K), flat_e,
                             torch.full_like(flat_e, -1))
    valid = flat_e >= 0
    tiers.copy.wait(layer)
    state0 = cache_lib.land(tiers.state)
    new_state, hits, _, spec_hits = cache_lib.access_ex(
        state0, layer, flat_e, ccfg.policy)
    gid, pos, rep_e = _group_by_expert(flat_e, tiers.host_w1.shape[1])
    resident, res_way = cache_lib.lookup(state0, layer, rep_e)
    return ProbeResult(state=new_state, hits=hits, spec_hits=spec_hits,
                       valid=valid, flat_e=flat_e, gid=gid, pos=pos,
                       rep_e=rep_e, resident=resident, res_way=res_way)


class Staged(NamedTuple):
    """The step's per-unique-expert weights on the device."""
    groups: List[int]         # probe group ids, in staging order
    w1: torch.Tensor          # [len(groups), D, F]
    w3: torch.Tensor
    w2: torch.Tensor          # [len(groups), F, D]


def _empty_table(tiers: ExpertTiers, n: int, device
                 ) -> Tuple[torch.Tensor, ...]:
    """Fresh w1, w3 [n, D, F] and w2 [n, F, D] buffers on ``device``."""
    return tuple(torch.empty((n,) + tuple(s.shape[1:]), dtype=s.dtype,
                             device=device) for s in tiers.slots)


def _row_copies(tiers: ExpertTiers, layer: int,
                out: Tuple[torch.Tensor, ...],
                rows: List[Tuple[int, int, int]], ccfg: CacheConfig
                ) -> Copies:
    """Where a read finds an expert: the copies, in order, that fill row c
    of ``out``'s w1, w3 and w2 with ``layer``'s expert e for each
    (c, e, way) of ``rows``, from the expert's slot where ``way >= 0``
    (resident), else from the host tier."""
    copies = []
    for c, e, way in rows:
        if way >= 0:
            at = cache_lib.slot_id(layer, way, ccfg.num_ways)
            srcs = [slot[at] for slot in tiers.slots]
        else:
            srcs = [host[layer, e] for host in tiers.host]
        copies += [(buf[c], src) for buf, src in zip(out, srcs)]
    return copies


def _stage_group_weights(tiers: ExpertTiers, layer: int, pr: ProbeResult,
                         ccfg: CacheConfig, groups: List[int],
                         device) -> Staged:
    """Each unique expert's weights once, on the compute stream, into
    fresh buffers on ``device``: resident groups from the slot buffer, the
    rest host->device from pinned memory (non-blocking)."""
    out = _empty_table(tiers, len(groups), device)
    rows = [(c, int(pr.rep_e[g]),
             int(pr.res_way[g]) if bool(pr.resident[g]) else -1)
            for c, g in enumerate(groups)]
    for dst, src in _row_copies(tiers, layer, out, rows, ccfg):
        dst.copy_(src, non_blocking=True)
    return Staged(groups, *out)


class _Reads(NamedTuple):
    """One layer's expert table while its host-tier reads are in flight."""
    layer: int
    table: Tuple[torch.Tensor, ...]     # w1, w3 [E, D, F], w2 [E, F, D]
    ways: List[int]                     # each expert's way; -1: the host's
    done: Optional[torch.cuda.Event]    # the host reads' end (or None)


def _read_host(tiers: ExpertTiers, layer: int,
               table: Tuple[torch.Tensor, ...], ccfg: CacheConfig) -> _Reads:
    """Queue ``layer``'s non-resident experts host->device into their rows
    of ``table`` on the copy stream (:meth:`CopyStream.queue`), after the
    compute stream's work so far, which covers every earlier read of
    ``table``'s memory. Residency is
    :func:`~repro_torch.core.cache.lookup` on the state as it stands."""
    E = tiers.host_w1.shape[1]
    hit, way = cache_lib.lookup(tiers.state, layer,
                                torch.arange(E, dtype=torch.int32))
    ways = torch.where(hit, way, -1).tolist()
    misses = [(e, e, w) for e, w in enumerate(ways) if w < 0]
    done = tiers.copy.queue(_row_copies(tiers, layer, table, misses, ccfg))
    return _Reads(layer, table, ways, done)


def _read_slots(tiers: ExpertTiers, reads: _Reads, ccfg: CacheConfig
                ) -> Tuple[torch.Tensor, ...]:
    """On the compute stream: wait for the layer's last slot write (b) and
    for its host reads, then copy each resident expert from its slot."""
    tiers.copy.wait(reads.layer)
    tiers.copy.join(reads.done)
    hits = [(e, e, w) for e, w in enumerate(reads.ways) if w >= 0]
    for dst, src in _row_copies(tiers, reads.layer, reads.table, hits, ccfg):
        dst.copy_(src)
    return reads.table


def forward_experts(tiers: ExpertTiers, layer: int, ccfg: CacheConfig
                    ) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """One layer's prefill expert table on its own (a forward reads its
    layers through :class:`ForwardExperts`, one ahead): (w1, w3 [E, D, F],
    w2 [E, F, D]) on the slot buffer's device, and how many of the E
    experts were read from their slots. A resident expert is copied from
    its slot, every other one host->device from the pinned tier; layers
    past the cache's coverage read all E from the host. Residency is
    :func:`~repro_torch.core.cache.lookup` on the state as it stands, not
    landed, so a PENDING reservation (its copy may still be in flight)
    reads from the host. Only reads: the cache state and the slots are
    left as they are."""
    table = _empty_table(tiers, tiers.host_w1.shape[1], tiers.slot_w1.device)
    reads = _read_host(tiers, layer, table, ccfg)
    return _read_slots(tiers, reads, ccfg), sum(w >= 0 for w in reads.ways)


class ForwardExperts:
    """One prefill forward's expert source (one ``backbone`` call; close it
    when the call returns). :meth:`read` hands a MoE layer its table, as
    :func:`forward_experts` reads it, and first queues the next layer's
    host-tier reads on the copy stream, so that layer l+1's misses cross
    PCIe while layer l computes; layer 0's are queued when the source is
    made, before the forward's embedding. Two tables in turn: layer l+1's
    reads go into the one layer l-1 read, and queue after the compute
    stream's work so far, which holds every read of it (a); the compute
    stream waits for a layer's reads before its first read of the table.
    Residency is taken from the state as it stands when a layer's reads
    are queued; a forward neither commits nor lands, so it is the state
    the layer would find. Never carry a source from one forward into the
    next: the warming replay changes the cache in between. On the CPU the
    reads are synchronous (d)."""

    def __init__(self, tiers: ExpertTiers, ccfg: CacheConfig):
        self.tiers, self.ccfg = tiers, ccfg
        self.num_layers = tiers.host_w1.shape[0]
        self._tables: List[Optional[Tuple[torch.Tensor, ...]]] = [None, None]
        self._turn = 0
        self._next: Optional[_Reads] = self._issue(0)

    def _issue(self, layer: int) -> _Reads:
        t = self._turn
        self._turn ^= 1
        tiers = self.tiers
        if self._tables[t] is None:
            self._tables[t] = _empty_table(tiers, tiers.host_w1.shape[1],
                                           tiers.slot_w1.device)
        return _read_host(tiers, layer, self._tables[t], self.ccfg)

    def read(self, layer: int) -> Tuple[Tuple[torch.Tensor, ...], int, int]:
        """``layer``'s table (valid until the layer after next is read),
        how many of its experts came from their slots, and how many of the
        others were queued before this call (all, unless the forward
        skipped a layer). Queues ``layer + 1``'s reads, if there is one."""
        reads, self._next = self._next, None
        ahead = reads is not None and reads.layer == layer
        if not ahead:
            if reads is not None:
                self.tiers.copy.join(reads.done)
            reads = self._issue(layer)
        if layer + 1 < self.num_layers:
            self._next = self._issue(layer + 1)
        table = _read_slots(self.tiers, reads, self.ccfg)
        misses = sum(w < 0 for w in reads.ways)
        return table, len(reads.ways) - misses, misses if ahead else 0

    def close(self) -> None:
        """The compute stream waits for reads of a layer the forward did
        not reach, so the tables go back to the allocator with no copy
        still writing them; then they go."""
        if self._next is not None:
            self.tiers.copy.join(self._next.done)
        self._next = None
        self._tables = [None, None]


def _stage_dispatch(x: torch.Tensor, K: int, pr: ProbeResult,
                    groups: List[int]):
    """The [G, A, D] dispatch buffer of the staged groups. Returns
    (assignment ids [V] of valid picks, their compact group [V] and row
    [V] — all on x's device — and the buffer)."""
    A = pr.flat_e.shape[0]
    compact = torch.full((pr.rep_e.shape[0],), -1, dtype=torch.int64)
    compact[torch.tensor(groups, dtype=torch.int64)] = torch.arange(
        len(groups))
    a_ids = torch.nonzero(pr.valid).reshape(-1)
    cg = compact[pr.gid.long()[a_ids]]
    rows = pr.pos.long()[a_ids]
    a_dev, cg_dev, rows_dev = (t.to(x.device, non_blocking=True)
                               for t in (a_ids, cg, rows))
    xbuf = torch.zeros((len(groups), A, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
    xbuf[cg_dev, rows_dev] = x[a_dev // K]
    return a_dev, cg_dev, rows_dev, xbuf


def _combine(ybuf, a_ids, cg, rows, top_w, T, K, dtype):
    """Weighted sum of each token's K expert outputs, in pick order, with
    the reference's rounding (bf16 products, bf16 running sum)."""
    D = ybuf.shape[-1]
    ya = torch.zeros((T * K, D), dtype=ybuf.dtype, device=ybuf.device)
    scale = top_w.reshape(-1)[a_ids].to(ybuf.dtype)
    ya[a_ids] = ybuf[cg, rows] * scale[:, None]
    ya = ya.reshape(T, K, D)
    y = ya[:, 0]
    for k in range(1, K):
        y = y + ya[:, k]
    return y.to(dtype)


def group_counts(pr: ProbeResult) -> torch.Tensor:
    """[G] int32: valid assignments per group."""
    return torch.bincount(pr.gid.long()[pr.valid],
                          minlength=pr.rep_e.shape[0]).to(torch.int32)


def execute(tiers: ExpertTiers, layer: int, x: torch.Tensor,
            top_w: torch.Tensor, pr: ProbeResult, ccfg: CacheConfig
            ) -> Tuple[torch.Tensor, Optional[Staged]]:
    """Stage 2 — grouped tiered execution through the gmm kernels.
    x [T, D], top_w [T, K] on the device. Returns (y [T, D], the staged
    weights, reused by commit's post-fetch)."""
    return execute_lanes(tiers, layer, x, top_w, pr, ccfg)


def execute_lanes(tiers: ExpertTiers, layer: int, x: torch.Tensor,
                  top_w: torch.Tensor, pr: ProbeResult, ccfg: CacheConfig,
                  to_cpu: Optional[torch.Tensor] = None, executor=None,
                  counts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Staged]]:
    """Stage 2 with a host lane: the groups of ``to_cpu`` [G] bool run on
    ``executor`` (:class:`repro_torch.hostexec.HostExpertExecutor`), the
    rest through the gmm kernels. The host groups' rows of the dispatch
    buffer go device->host into pinned memory (the paper's activation
    round trip) before the device lane is queued, so the thread pool
    computes while the card stages and runs its groups; their outputs come
    back host->device before the combine. ``counts`` [G] valid rows per
    group (default: from the probe). Returns (y [T, D], the device lane's
    staged weights)."""
    T, K = top_w.shape
    live = [g for g in range(pr.rep_e.shape[0]) if int(pr.rep_e[g]) >= 0]
    if not live:
        return torch.zeros_like(x), None
    host = [] if to_cpu is None else [g for g in live if bool(to_cpu[g])]
    dev = [g for g in live if g not in host]
    a_ids, cg, rows, xbuf = _stage_dispatch(x, K, pr, dev + host)
    if host:
        if executor is None:
            raise ValueError("the host lane needs a host executor")
        xh, sent = _to_host(xbuf[len(dev):])
    st, parts = None, []
    if dev:
        st = _stage_group_weights(tiers, layer, pr, ccfg, dev, x.device)
        parts.append(moe_ffn(xbuf[:len(dev)], st.w1, st.w3, st.w2))
    if host:
        if sent is not None:
            sent.synchronize()
        sel = torch.tensor(host, dtype=torch.int64)
        counts = group_counts(pr) if counts is None else counts
        yh = executor.compute_groups(layer, pr.rep_e[sel],
                                     torch.ones(len(host), dtype=torch.bool),
                                     xh, counts[sel])
        if x.device.type == "cuda":
            yh = yh.pin_memory().to(x.device, non_blocking=True)
        parts.append(yh)
    ybuf = parts[0] if len(parts) == 1 else torch.cat(parts)   # [G, A, D]
    y = _combine(ybuf, a_ids, cg, rows, top_w, T, K, x.dtype)
    return y, st


def _to_host(rows: torch.Tensor):
    """A copy of device ``rows`` in pinned host memory, queued on the
    compute stream, and its event (rows already on the host: themselves)."""
    if rows.device.type != "cuda":
        return rows, None
    out = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    out.copy_(rows, non_blocking=True)
    sent = torch.cuda.Event()
    sent.record()
    return out, sent


def commit(tiers: ExpertTiers, layer: int, pr: ProbeResult,
           staged: Optional[Staged], ccfg: CacheConfig
           ) -> Tuple[ExpertTiers, torch.Tensor]:
    """Stage 3 — install the probe's cache state and post-fetch the newly
    inserted experts' weights into their slots. Returns (tiers, fetch [G]
    bool)."""
    fetch = _post_fetch(tiers, layer, pr, staged, ccfg)
    return tiers._replace(state=pr.state), fetch


def _post_fetch(tiers: ExpertTiers, layer: int, pr: ProbeResult,
                staged: Optional[Staged], ccfg: CacheConfig) -> torch.Tensor:
    """Write inserted experts into their slots (in place, on the copy
    stream), once per unique expert. Probes the POST-step state: an expert
    is fetched iff its final (expert -> way) mapping is not already backed
    by the buffer — newly resident, or moved to another way within the
    step. Experts staged from the host this step copy from the staging
    buffer; the rest (a resident expert that moved way, a group the host
    lane ran, or every expert when nothing was staged) from the host
    tier."""
    new_res, new_way = cache_lib.lookup(pr.state, layer, pr.rep_e)
    fetch = new_res & ~(pr.resident & (new_way == pr.res_way))
    staged_at = {g: c for c, g in enumerate(staged.groups)} \
        if staged is not None else {}
    writes = []
    for g in torch.nonzero(fetch).reshape(-1).tolist():
        dst = cache_lib.slot_id(layer, int(new_way[g]), ccfg.num_ways)
        c = staged_at.get(g)
        if c is not None and not bool(pr.resident[g]):
            srcs = (staged.w1[c], staged.w3[c], staged.w2[c])
        else:
            e = int(pr.rep_e[g])
            srcs = tuple(h[layer, e] for h in tiers.host)
        writes += [(slot[dst], src) for slot, src in zip(tiers.slots, srcs)]
    keep = (staged.w1, staged.w3, staged.w2) if staged is not None else ()
    tiers.copy.write(layer, writes, keep)
    return fetch


def prediction_votes(flat_p: torch.Tensor) -> torch.Tensor:
    """Cross-batch vote count per predicted pick: an expert predicted by V
    assignments scores V on each of its picks, masked (-1) picks 0. The
    count is a reservation's retention priority (``reserve``'s age-stamp
    boost), never a claim reorder."""
    valid = flat_p >= 0
    votes = ((flat_p[:, None] == flat_p[None, :])
             & valid[:, None] & valid[None, :]).sum(-1)
    return votes.to(torch.int32)


def prefetch(tiers: ExpertTiers, layer: int, pred_i: torch.Tensor,
             ccfg: CacheConfig, active: Optional[torch.Tensor] = None,
             rank_votes: bool = False
             ) -> Tuple[ExpertTiers, torch.Tensor, torch.Tensor, int]:
    """Stage 4 — speculative cross-layer prefetch into reserved slots.

    pred_i [T, K] predicted picks for ``layer`` and ``active`` [T] bool, on
    the host. Reserves slots with policy-correct eviction
    but no demand accounting (``rank_votes``: stamped with the picks' vote
    counts), then copies each issued expert's host-tier weights into its
    claimed slot on the copy stream, once per unique predicted expert. The
    reservations stay PENDING until the next probe lands them. Returns
    (tiers, rep_p [G] unique predicted expert per group, issued [G] bool —
    groups whose reservation claimed a slot, the number of issued
    picks)."""
    T, K = pred_i.shape
    flat_p = pred_i.reshape(-1).to(torch.int32)
    if active is not None:
        flat_p = torch.where(active.repeat_interleave(K), flat_p,
                             torch.full_like(flat_p, -1))
    priority = prediction_votes(flat_p) if rank_votes else None
    new_state, issued_a, ways_a = cache_lib.reserve(
        tiers.state, layer, flat_p, ccfg.policy, priority=priority)
    gid, _, rep_p = _group_by_expert(flat_p, tiers.host_w1.shape[1])
    # duplicates of one expert reserve at most once: fold picks onto groups
    issued = torch.zeros(rep_p.shape[0], dtype=torch.bool)
    issued[gid.long()[issued_a]] = True
    writes = []
    for a in torch.nonzero(issued_a).reshape(-1).tolist():
        dst = cache_lib.slot_id(layer, int(ways_a[a]), ccfg.num_ways)
        e = int(flat_p[a])
        writes += [(slot[dst], h[layer, e])
                   for slot, h in zip(tiers.slots, tiers.host)]
    tiers.copy.write(layer, writes)
    return (tiers._replace(state=new_state), rep_p, issued,
            int(issued_a.sum()))


def expert_bytes(tiers: ExpertTiers) -> int:
    """Bytes of one expert's ``w1 + w3 + w2``: what one staging or slot
    write copies."""
    return sum(h[0, 0].nbytes for h in tiers.host)


def copy_bytes(pr: ProbeResult, staged: Optional[Staged],
               fetch: torch.Tensor, nbytes: int) -> Dict[str, int]:
    """One layer's weight copies by route, ``nbytes`` an expert: the
    staged groups read from the slot buffer (resident) or the host tier,
    and the fetched groups written from the staging buffer (staged from
    the host this step, as :func:`_post_fetch` picks) or the host tier."""
    resident, fetched = pr.resident.tolist(), fetch.tolist()
    groups = staged.groups if staged is not None else ()
    res = slot_d2d = 0
    for g in groups:
        if resident[g]:
            res += 1
        elif fetched[g]:
            slot_d2d += 1
    return {"stage_d2d_bytes": res * nbytes,
            "stage_h2d_bytes": (len(groups) - res) * nbytes,
            "slot_d2d_bytes": slot_d2d * nbytes,
            "slot_h2d_bytes": (sum(fetched) - slot_d2d) * nbytes}


def _stats(pr: ProbeResult, fetch: torch.Tensor) -> Dict[str, int]:
    return {
        "hits": int(pr.hits.sum()),
        "accesses": int(pr.valid.sum()),
        "host_flops_assignments": int((pr.valid & ~pr.hits).sum()),
        "fetched_experts": int(fetch.sum()),
        "prefetch_hits": int(pr.spec_hits.sum()),
    }


def collaborative_moe(tiers: ExpertTiers, layer: int, x: torch.Tensor,
                      top_i: torch.Tensor, top_w: torch.Tensor,
                      ccfg: CacheConfig,
                      active: Optional[torch.Tensor] = None):
    """probe -> execute -> commit for one layer (``top_i`` read to the host
    here). Returns (y, tiers, stats)."""
    pr = probe(tiers, layer, top_i.cpu(), ccfg, active=active)
    y, staged = execute(tiers, layer, x, top_w, pr, ccfg)
    tiers, fetch = commit(tiers, layer, pr, staged, ccfg)
    return y, tiers, _stats(pr, fetch)


def collaborative_moe_offloaded(tiers: ExpertTiers, layer: int,
                                x: torch.Tensor, top_i: torch.Tensor,
                                top_w: torch.Tensor, ccfg: CacheConfig,
                                executor,
                                active: Optional[torch.Tensor] = None):
    """The paper's workflow with every cache miss computed on the host:
    resident groups run through the gmm kernels on the card, every
    non-resident group on ``executor`` over the pinned host tier (its
    activations cross to the host and back), and the post-fetch of the
    newly inserted experts goes host->device on the copy stream (``top_i``
    read to the host here). Returns (y, tiers, stats)."""
    pr = probe(tiers, layer, top_i.cpu(), ccfg, active=active)
    to_cpu = ~pr.resident & (pr.rep_e >= 0)
    y, staged = execute_lanes(tiers, layer, x, top_w, pr, ccfg, to_cpu,
                              executor)
    tiers, fetch = commit(tiers, layer, pr, staged, ccfg)
    return y, tiers, _stats(pr, fetch)


def _ffn_rows(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert FFN of each row on its own weights: x [A, D],
    w1/w3 [A, D, F], w2 [A, F, D] -> [A, D], each product rounded once to
    x's dtype (the reference's vmapped ``_ffn_one``)."""
    xa = x[:, None]
    h = silu(mm(xa, w1)) * mm(xa, w3)
    return mm(h, w2)[:, 0]


def collaborative_moe_reference(tiers: ExpertTiers, layer: int,
                                x: torch.Tensor, top_i: torch.Tensor,
                                top_w: torch.Tensor, ccfg: CacheConfig
                                ) -> Tuple[torch.Tensor, ExpertTiers,
                                           Dict[str, int]]:
    """The seed per-assignment path (the reference's
    ``collaborative_moe_reference``), kept as the sequential parity oracle
    of probe -> execute -> commit; plain PyTorch, never on a served path.

    :func:`~repro_torch.core.cache.access_scan_reference` services the
    picks; every assignment runs its expert's single-row SwiGLU FFN on
    both tiers (the slot buffer at its way, and the host table's weights
    moved to x's device), ``where(hit, device, host)`` picks one, and the
    top-k weighted outputs add up per token in pick order. Then the
    sequential post-fetch copies each missed, inserted expert from the
    host tier into its slot, in place, in pick order. Known limitation,
    inherited: duplicate picks of a non-resident expert across concurrent
    tokens read the stale slot buffer (the first pick's insert reports
    the second as a hit); the grouped path fixes this. Valid on flag-free
    cache states only. Returns (y [T, D], tiers, stats)."""
    T, K = top_i.shape
    A = T * K
    flat_e = top_i.to("cpu").reshape(-1).to(torch.int32)
    new_state, hits, ways = cache_lib.access_scan_reference(
        tiers.state, layer, flat_e, ccfg.policy)
    slots = torch.where(ways >= 0, cache_lib.slot_id(
        layer, torch.clamp(ways, min=0), ccfg.num_ways), 0).long()
    e_idx = flat_e.long()
    tok = torch.arange(T).repeat_interleave(K)
    xa = x[tok.to(x.device)]
    dev = x.device
    y_dev = _ffn_rows(*(s[slots.to(s.device)].to(dev) for s in tiers.slots),
                      xa)
    y_host = _ffn_rows(*(h[layer][e_idx].to(dev) for h in tiers.host), xa)
    ya = torch.where(hits.to(dev)[:, None], y_dev, y_host)
    ya = ya * top_w.reshape(-1)[:, None].to(ya.dtype)
    ya = ya.reshape(T, K, -1)
    y = torch.zeros_like(x) + ya[:, 0]
    for k in range(1, K):
        y = y + ya[:, k]

    do_fetch = ~hits & (ways >= 0)
    for a in torch.nonzero(do_fetch).reshape(-1).tolist():
        for slot, host in zip(tiers.slots, tiers.host):
            slot[int(slots[a])].copy_(host[layer, int(e_idx[a])])
    stats = {"hits": int(hits.sum()), "accesses": A,
             "host_flops_assignments": int((~hits).sum()),
             "fetched_experts": int(do_fetch.sum())}
    return y, tiers._replace(state=new_state), stats
