"""Two-tier collaborative MoE execution — the paper's workflow (Fig. 4) on
one GPU (counterpart of the reference's ``core/collaborative.py``):

  probe    — land in-flight reservations, service the router's top-k picks
             against the host-side set-associative cache
             (:mod:`repro_torch.core.cache`) and bucket the step's
             assignments by unique expert. The picks cross from the device
             to the host here: the one device->host sync of a MoE layer.
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

Tiers: ``host_*`` [L, E, D, F|F, D] in host memory (pinned on a GPU), the
slot buffers ``slot_*`` [N*M, D, F|F, D] on the compute device, updated IN
PLACE by commit and prefetch; the cache state is replaced functionally.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import CacheConfig
from repro_torch.kernels.moe_gmm import moe_ffn
from . import cache as cache_lib


class CopyStream:
    """The second CUDA stream that slot writes run on, with the event of the
    last copy into each layer's slots (no stream on the CPU)."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._last: Dict[int, torch.cuda.Event] = {}

    def write(self, layer: int, writes: List[Tuple[torch.Tensor,
                                                   torch.Tensor]],
              keep: Tuple[torch.Tensor, ...] = ()) -> None:
        """Copy each (dst, src) pair of ``writes`` into ``layer``'s slots:
        on the copy stream after the compute stream's work so far (a); the
        tensors of ``keep``, which the copies read, stay allocated until
        they end (c). On the CPU, synchronously (d)."""
        if not writes:
            return
        if self.stream is None:
            for dst, src in writes:
                dst.copy_(src)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            for dst, src in writes:
                dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        for t in keep:
            t.record_stream(self.stream)
        self._last[layer] = done

    def wait(self, layer: int) -> None:
        """(b) The compute stream waits for the last copy into ``layer``'s
        slots; later compute work is ordered after it, so it waits once."""
        done = self._last.pop(layer, None)
        if done is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(done)


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
    ``top_i`` [T, K] may lie on the device: it is read to the host here.
    Residency for execution is probed against the landed PRE-access state
    (a slot claimed this step holds its weights from the next step on).
    Landing is where the compute stream waits for the layer's slot copies."""
    T, K = top_i.shape
    flat_e = top_i.to("cpu").reshape(-1).to(torch.int32)
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.bool).to("cpu")
        flat_e = torch.where(act.repeat_interleave(K), flat_e,
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


def _stage_group_weights(tiers: ExpertTiers, layer: int, pr: ProbeResult,
                         ccfg: CacheConfig, groups: List[int],
                         device) -> Staged:
    """Each unique expert's weights once: resident groups from the slot
    buffer, the rest host->device from pinned memory (non-blocking)."""
    G = len(groups)
    out = [torch.empty((G,) + tuple(s.shape[1:]), dtype=s.dtype,
                       device=device) for s in tiers.slots]
    for c, g in enumerate(groups):
        if bool(pr.resident[g]):
            src = cache_lib.slot_id(layer, int(pr.res_way[g]), ccfg.num_ways)
            for buf, slot in zip(out, tiers.slots):
                buf[c].copy_(slot[src])
        else:
            e = int(pr.rep_e[g])
            for buf, host in zip(out, tiers.host):
                buf[c].copy_(host[layer, e], non_blocking=True)
    return Staged(groups, *out)


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

    pred_i [T, K] predicted picks for ``layer`` (may lie on the device: it
    is read to the host here). Reserves slots with policy-correct eviction
    but no demand accounting (``rank_votes``: stamped with the picks' vote
    counts), then copies each issued expert's host-tier weights into its
    claimed slot on the copy stream, once per unique predicted expert. The
    reservations stay PENDING until the next probe lands them. Returns
    (tiers, rep_p [G] unique predicted expert per group, issued [G] bool —
    groups whose reservation claimed a slot, the number of issued
    picks)."""
    T, K = pred_i.shape
    flat_p = pred_i.to("cpu").reshape(-1).to(torch.int32)
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.bool).to("cpu")
        flat_p = torch.where(act.repeat_interleave(K), flat_p,
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
    """probe -> execute -> commit for one layer. Returns (y, tiers, stats)."""
    pr = probe(tiers, layer, top_i, ccfg, active=active)
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
    newly inserted experts goes host->device on the copy stream. Returns
    (y, tiers, stats)."""
    pr = probe(tiers, layer, top_i, ccfg, active=active)
    to_cpu = ~pr.resident & (pr.rep_e >= 0)
    y, staged = execute_lanes(tiers, layer, x, top_w, pr, ccfg, to_cpu,
                              executor)
    tiers, fetch = commit(tiers, layer, pr, staged, ccfg)
    return y, tiers, _stats(pr, fetch)
