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
             staged at all.
  commit   — install the probe's cache state and post-fetch the newly
             inserted experts into their slots, once per unique expert.
             Experts staged from the host this step are copied from the
             staging buffer; an expert that was resident but moved way
             comes from the host tier. The copies run on the current
             stream in this port (the paper's second copy engine is later
             work) and feed only future steps.

Tiers: ``host_*`` [L, E, D, F|F, D] in host memory (pinned on a GPU), the
slot buffers ``slot_*`` [N*M, D, F|F, D] on the compute device, updated IN
PLACE by commit; the cache state is replaced functionally.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import CacheConfig
from repro_torch.kernels.moe_gmm import moe_ffn
from . import cache as cache_lib


class ExpertTiers(NamedTuple):
    """The two memory tiers of one model's expert weights."""
    host_w1: torch.Tensor     # [L, E, D, F], host memory
    host_w3: torch.Tensor
    host_w2: torch.Tensor     # [L, E, F, D]
    slot_w1: torch.Tensor     # [N*M, D, F], device
    slot_w3: torch.Tensor
    slot_w2: torch.Tensor     # [N*M, F, D]
    state: cache_lib.CacheState

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
        state=state)
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
    (a slot claimed this step holds its weights from the next step on)."""
    T, K = top_i.shape
    flat_e = top_i.to("cpu").reshape(-1).to(torch.int32)
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.bool).to("cpu")
        flat_e = torch.where(act.repeat_interleave(K), flat_e,
                             torch.full_like(flat_e, -1))
    valid = flat_e >= 0
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


def execute(tiers: ExpertTiers, layer: int, x: torch.Tensor,
            top_w: torch.Tensor, pr: ProbeResult, ccfg: CacheConfig
            ) -> Tuple[torch.Tensor, Optional[Staged]]:
    """Stage 2 — grouped tiered execution through the gmm kernels.
    x [T, D], top_w [T, K] on the device. Returns (y [T, D], the staged
    weights, reused by commit's post-fetch)."""
    T, K = top_w.shape
    groups = [g for g in range(pr.rep_e.shape[0]) if int(pr.rep_e[g]) >= 0]
    if not groups:
        return torch.zeros_like(x), None
    a_ids, cg, rows, xbuf = _stage_dispatch(x, K, pr, groups)
    st = _stage_group_weights(tiers, layer, pr, ccfg, groups, x.device)
    ybuf = moe_ffn(xbuf, st.w1, st.w3, st.w2)              # [G, A, D]
    y = _combine(ybuf, a_ids, cg, rows, top_w, T, K, x.dtype)
    return y, st


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
    """Write inserted experts into their slots (in place), once per unique
    expert. Probes the POST-step state: an expert is fetched iff its final
    (expert -> way) mapping is not already backed by the buffer — newly
    resident, or moved to another way within the step. Experts staged from
    the host this step copy from the staging buffer; the rest (a resident
    expert that moved way, or every expert when nothing was staged) from
    the host tier."""
    new_res, new_way = cache_lib.lookup(pr.state, layer, pr.rep_e)
    fetch = new_res & ~(pr.resident & (new_way == pr.res_way))
    staged_at = {g: c for c, g in enumerate(staged.groups)} \
        if staged is not None else {}
    for g in torch.nonzero(fetch).reshape(-1).tolist():
        dst = cache_lib.slot_id(layer, int(new_way[g]), ccfg.num_ways)
        c = staged_at.get(g)
        if c is not None and not bool(pr.resident[g]):
            srcs = (staged.w1[c], staged.w3[c], staged.w2[c])
        else:
            e = int(pr.rep_e[g])
            srcs = tuple(h[layer, e] for h in tiers.host)
        for slot, src in zip(tiers.slots, srcs):
            slot[dst].copy_(src, non_blocking=True)
    return fetch


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
