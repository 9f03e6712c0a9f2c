"""Collaborative serving engine (counterpart of the reference's
``serving/engine.py``).

Serves a homogeneous MoE LM with the expert weights split across the two
tiers of :mod:`repro_torch.core.collaborative`: attention, router and norm
weights plus the N-index M-way expert cache's slot buffer on the GPU; the
full expert table in pinned host memory. Every decode step runs, per
layer: rmsnorm, decode attention (the flash-decode kernel over the dense
cache, or the paged kernel over the page pool), the router, then probe
(host-side cache check + grouping) -> execute (grouped gmm kernels over
weights staged once per unique expert) -> commit (post-fetch into the
slots, on the tiers' copy stream).

With ``EngineConfig.prefetch`` the layer loop is the reference's software
pipeline: after layer l's MoE, layer l+1's router runs on layer l's output
and its predicted picks reserve slots and stream their weights in on the
copy stream (:func:`repro_torch.core.collaborative.prefetch`); the next
probe lands them. Each layer scores the prediction made for it.
With ``EngineConfig.host_compute`` the execute stage is the hybrid
dispatcher (:mod:`repro_torch.hostexec`): the cost model sends small miss
groups to a host thread pool over the pinned tier, the rest run on the
card.

Prefill is request-shaped and resumable, as in the reference:
:meth:`start_prefill` runs the one prefill forward (the backbone's prefill
mode, emitting the routing trace) and returns a :class:`PrefillTicket`;
:meth:`advance_prefill` replays the prompt's routing trace chunk by chunk
through probe -> commit so the prompt's own routing warms the shared
cache before decode. Like the reference, whose FFN output in the replay
has no consumer and is pruned by XLA, the replay runs no FFN: what is
left is the probe and the post-fetch's weight copies.

The static-batch path of the reference is here too, for dense KV only:
:meth:`prefill` (the bypass forward, tiers untouched), :meth:`prefill_request`
(one request through the ticket primitives) and :meth:`generate` (B prompts
decoded together with one shared SamplingParams); under ``kv_paged`` all
three refuse.

With ``EngineConfig.prefill_segment`` the admission forward itself goes
incremental: :meth:`start_prefill` only tokenizes (and, paged, allocates
pages), and each :meth:`advance_prefill_state` call forwards ONE
C-token segment through the backbone's segment mode (offset causal mask,
the segment's KV appended to the ticket's dense cache or straight into
the pool pages) and warms the cache from that segment's routing. The
first-token logits come with the last segment.

With ``EngineConfig.kv_paged`` one global ``[num_pages, page_size, Hk,
hd]`` pool per layer replaces the per-slot cache; requests hold
refcounted pages through the host-side :class:`KVPagePool`, a prompt that
opens with another request's full pages shares them (its forward and warm
skip the shared span under segment prefill), and a partial last page that
two tables share is copied on write before an append.

With a recorder (``recorder=``, a :class:`repro_torch.obs.TraceRecorder`)
the engine emits the reference's spans, counters and instants, all from
its drain helpers (:meth:`_obs_decode`, :meth:`_obs_prefill`,
:meth:`_obs_prefill_forward`): a ``decode_step`` span with the step's
lane split, its ``plan`` / ``dispatch`` / ``commit`` / ``execute+drain``
phases, the ``lane:*`` counters, prefetch and host-lane events, the page
pool's gauge and deltas, and one ``segment_stream`` or ``warm_replay``
span per prefill advance. The reference's ``dispatch`` phase is the
asynchronous launch of its jitted step; the port's layer loop syncs
inside every layer (the engine reads each layer's routing on the host
before the probe), so here ``dispatch`` covers almost the whole step and
``execute+drain`` the rest.

The port opens ``dispatch`` up, which the reference's jitted step has no
host phases for: each layer's clock readings land in a preallocated
buffer and the drain emits them as spans that tile the layer, in order
``attn_route`` (norms, attention, router and top-k), ``picks`` (the
blocking device->host read of the layer's top-k), ``probe``, ``execute``
(args: the staged weight bytes, ``d2d_bytes`` / ``h2d_bytes``),
``post_fetch`` (commit and the layer's stats; args: its slot writes'
bytes) and, with prefetch, ``prefetch``. The copy bytes accumulate in
:class:`EngineStats` (``stage_*_bytes``, ``slot_*_bytes``). Each padded
admission forward gets a ``prefill_forward`` span (args: ``tokens``, the
expert reads ``resident_experts`` of ``experts`` and their bytes,
``d2d_bytes`` from the slots and ``h2d_bytes`` from the host tier, and
``ahead_experts``).

Every prefill forward (the padded one, each streamed segment, the static
batch's) reads its MoE layers' expert tables through the tiers, with a
source of its own (:class:`repro_torch.core.collaborative.ForwardExperts`):
each expert resident in the cache is copied from its HBM slot, and only
the others cross PCIe from the pinned host tier, on the tiers' copy
stream, queued one layer ahead (layer l+1's while layer l computes; layer
0's before the embedding). It only reads the cache and the slots.
``EngineStats.prefill_forward_resident`` / ``prefill_forward_experts`` /
``prefill_forward_ahead`` count those reads.

Differences from the reference, all in how, never in what: the cache
state, its bookkeeping and the page tables live on the host; KV caches,
pools and slot buffers are updated in place; the layer loop is a Python
loop; the host lane is the thread pool (the reference's ``"callback"``
backend; its in-graph ``"jax"`` backend has no PyTorch meaning and
raises).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import CacheConfig, ModelConfig
from repro_torch import hostexec
from repro_torch.core import collaborative as collab
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.layers import rmsnorm
from repro_torch.models.moe import route
from repro_torch.obs.trace import NULL_RECORDER, now_ns
from .kv_pool import KVPagePool, PageTable
from .sampling import (GREEDY, SamplingParams, batch_arrays, sample_tokens,
                       step_seed)
from .stats import EngineStats

Params = Dict[str, Any]

# a decode layer's host phases, in order (prefetch only with
# EngineConfig.prefetch): each spans two of the layer's clock readings
PHASES = ("attn_route", "picks", "probe", "execute", "post_fetch",
          "prefetch")
# the reference's per-layer stats key that EngineStats names otherwise;
# every other key is the name of the counter it adds to
RENAMED = {"host_flops_assignments": "host_assignments"}


@dataclass(frozen=True)
class EngineConfig:
    """Engine geometry and pipeline toggles (sampling is per request)."""
    cache: CacheConfig
    max_batch: int = 1            # concurrent request slots (T)
    capacity: int = 512           # KV capacity
    prefill_chunk: int = 8        # cache-warming prefill chunk (0 = bypass)
    # overlapped admission: advance a newly admitted request's warming
    # replay (or segment stream) by at most this many chunks per scheduler
    # tick (0 = all at once on the admission tick)
    admit_chunks_per_tick: int = 0
    prefetch: bool = False        # cross-layer speculative expert prefetch
    prefetch_min_prob: float = 0.0  # confidence gate on reservations
    # stamp reservations with their cross-batch vote counts (retention)
    prefetch_rank_votes: bool = True
    # segment-streamed prefill: forward the prompt in segments of this
    # many tokens, one advance each, each warming the cache from its own
    # routing (0 = one-shot forward; prefill_chunk is then an on/off
    # warming toggle)
    prefill_segment: int = 0
    # the CPU miss lane (repro_torch.hostexec): run cache-miss experts on a
    # host thread pool when the cost model favors it over the fetch
    host_compute: bool = False
    host_threads: int = 8         # executor pool / cost-model thread count
    host_backend: str = "callback"  # the thread pool ("jax" has no port)
    # batch small same-step CPU-miss groups (<= this many valid tokens)
    # into one stacked matmul instead of one pool task each
    host_fuse_small: int = 4
    # paged KV: one global [num_pages, page_size, ...] pool per layer
    # instead of the dense [max_batch, capacity, ...] cache, with prefix
    # sharing and copy-on-write
    kv_paged: bool = False
    page_size: int = 16           # tokens per KV page
    kv_pages: Optional[int] = None  # pool size (None = dense-equivalent)
    # paged KV: park up to this many zero-reference prefix pages for a
    # later prompt with the same prefix (0 = free eagerly)
    prefix_keep_pages: int = 0

    def __post_init__(self):
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.admit_chunks_per_tick < 0:
            raise ValueError(
                f"admit_chunks_per_tick must be >= 0, got "
                f"{self.admit_chunks_per_tick}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.prefill_segment < 0:
            raise ValueError(
                f"prefill_segment must be >= 0, got {self.prefill_segment}")
        if self.prefix_keep_pages < 0:
            raise ValueError(
                f"prefix_keep_pages must be >= 0, got "
                f"{self.prefix_keep_pages}")
        if self.prefix_keep_pages > 0 and not self.kv_paged:
            raise ValueError(
                "prefix_keep_pages retains pool pages: it requires kv_paged")
        if not 0.0 <= self.prefetch_min_prob < 1.0:
            raise ValueError(
                f"prefetch_min_prob must be in [0, 1), got "
                f"{self.prefetch_min_prob}")
        if self.host_threads < 1:
            raise ValueError(
                f"host_threads must be >= 1, got {self.host_threads}")
        if self.host_backend == "jax":
            raise NotImplementedError(
                "EngineConfig.host_backend='jax' has no PyTorch meaning: the "
                "reference's in-graph lane is host_compute=False with the "
                "dispatch counters; the port's host lane is 'callback'")
        if self.host_backend != "callback":
            raise ValueError(
                f"host_backend must be 'callback', got "
                f"{self.host_backend!r}")
        if self.host_fuse_small < 0:
            raise ValueError(
                f"host_fuse_small must be >= 0, got {self.host_fuse_small}")
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.kv_paged:
            if self.capacity % self.page_size != 0:
                raise ValueError(
                    f"paged KV needs capacity ({self.capacity}) divisible "
                    f"by page_size ({self.page_size})")
            min_pages = self.capacity // self.page_size
            if self.kv_pages is not None and self.kv_pages < min_pages:
                raise ValueError(
                    f"kv_pages ({self.kv_pages}) < capacity/page_size "
                    f"({min_pages}): one full-capacity request could "
                    f"never hold its pages")


@dataclass(eq=False)
class PrefillTicket:
    """Resumable prefill for ONE request.

    Trace replay (``seg == 0``): the prefill forward already ran, so
    ``logits`` and ``state`` are final; the ticket holds the prompt's
    routing picks padded to whole chunks (``top_i`` [L, n_chunks*chunk,
    K], on the host) and the replay cursor. Segment stream (``seg > 0``):
    no forward has run yet, ``logits`` stays None until the last segment
    and the cursor counts forwarded segments."""
    prompt_len: int
    chunk: int                    # warm-chunk token count (0 = bypass)
    n_chunks: int
    logits: Optional[torch.Tensor] = None   # [1, 1, V]
    state: Optional[Params] = None          # decode state, pos = prompt_len
    top_i: Optional[torch.Tensor] = None
    cursor: int = 0
    # segment stream: segment size, the first position forwarded (past a
    # shared prefix), the prompt padded to whole segments, the page ids
    # the KV streams into (paged: [max_pages], num_pages-padded), and
    # whether each segment warms the cache
    seg: int = 0
    fwd_start: int = 0
    tokens: Optional[np.ndarray] = None
    page_ids: Optional[np.ndarray] = None
    kv_streamed: bool = False
    warm: bool = True
    # paged KV: the request's page table (allocated at start_prefill), its
    # prompt (for the prefix index) and the tokens a prefix hit shares
    table: Optional[PageTable] = None
    prompt: Optional[np.ndarray] = None
    shared_tokens: int = 0

    @property
    def done(self) -> bool:
        return self.cursor >= self.n_chunks

    @property
    def remaining(self) -> int:
        return self.n_chunks - self.cursor


def _score(pred_prev: torch.Tensor, rep_prev: torch.Tensor,
           issued_prev: torch.Tensor, flat_e: torch.Tensor,
           top_i: torch.Tensor, act: torch.Tensor) -> Dict[str, int]:
    """Score the prediction made for this layer against its routing:
    predicted picks of active rows, those the row's actual top-k holds,
    and issued groups whose expert this layer never demanded."""
    pred_valid = (pred_prev >= 0) & act[:, None]
    pred_ok = (pred_prev[:, :, None] == top_i[:, None, :]).any(-1)
    demanded = (rep_prev[:, None] == flat_e[None, :]).any(-1)
    return {"predicted": int(pred_valid.sum()),
            "predicted_correct": int((pred_ok & pred_valid).sum()),
            "prefetch_wasted": int((issued_prev & ~demanded).sum())}


def _seed_of(seed: Union[None, int, torch.Generator]) -> Optional[int]:
    """A sampling seed from an int, or drawn from a ``torch.Generator``."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (), generator=seed))
    return None if seed is None else int(seed)


def _host_tokens(tokens) -> np.ndarray:
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return np.asarray(tokens, np.int32)


def _one_prompt(prompt) -> np.ndarray:
    """Normalize a single request's prompt to [1, P]; reject batches."""
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim == 2 and prompt.shape[0] == 1:
        prompt = prompt[0]
    if prompt.ndim != 1:
        raise ValueError(
            f"per-request prefill serves ONE prompt: expected shape [P] or "
            f"[1, P], got {prompt.shape}")
    return prompt.reshape(1, -1)


class CollaborativeEngine:
    """Single-GPU engine (the paper's consumer scenario, batched).

    ``params`` follows :func:`repro_torch.models.init_params`' layout; the
    engine runs on the device of ``params["embed"]`` and uses the expert
    tables (host memory) as its host tier. ``seed`` seeds the static-random
    cache placement."""

    def __init__(self, cfg: ModelConfig, params: Params, ecfg: EngineConfig,
                 seed: int = 0, recorder=None):
        self.slot = transformer.homogeneous_slot(cfg)
        self.cfg, self.ecfg, self.params = cfg, ecfg, params
        self.device = params["embed"].device
        # trace recorder (repro_torch.obs): the no-op twin when tracing is
        # off, so the instrumented path is identical either way; all
        # emission happens in the _obs_* drain helpers
        self.obs = recorder if recorder is not None else NULL_RECORDER
        # last-seen cumulative pool counters, so the drain helpers can
        # emit per-step deltas as instants
        self._obs_prev: Dict[str, int] = {}
        moe_p = params["scan"]["s0"]["moe"]
        self.tiers = collab.init_tiers(
            moe_p["w1"], moe_p["w3"], moe_p["w2"], ecfg.cache,
            num_experts=cfg.moe.num_experts,
            generator=torch.Generator().manual_seed(seed),
            device=self.device)
        # the host lane: the cost model's split table, and the thread pool
        # over the pinned host tier only when the table sends some group
        # to the CPU (an all-False table never dispatches)
        self.host_executor: Optional[hostexec.HostExpertExecutor] = None
        self.dispatch_policy: Optional[hostexec.HostDispatchPolicy] = None
        self._cpu_table = None
        if ecfg.host_compute:
            self.dispatch_policy = hostexec.HostDispatchPolicy(
                hostexec.timings_for(cfg.name), ecfg.host_threads)
            self._cpu_table = torch.from_numpy(
                self.dispatch_policy.decision_table(
                    ecfg.max_batch * cfg.moe.top_k))
            if bool(self._cpu_table.any()):
                self.host_executor = hostexec.HostExpertExecutor(
                    *self.tiers.host, threads=ecfg.host_threads,
                    fuse_small=ecfg.host_fuse_small)
        # paged KV: the pool and the per-slot page tables are host-side
        # bookkeeping made by init_slots; the device pool rides the state
        # where the dense cache did
        self.max_pages = ecfg.capacity // ecfg.page_size
        self.num_pages = (ecfg.kv_pages if ecfg.kv_pages is not None
                          else ecfg.max_batch * self.max_pages)
        self.kv_pool: Optional[KVPagePool] = None
        self._slot_tables: List[Optional[PageTable]] = [None] * ecfg.max_batch
        self._slot_pages: Optional[np.ndarray] = None
        L = cfg.num_layers
        # the counter record: every integer field of EngineStats
        self._counters = {f.name: 0 for f in fields(EngineStats)
                          if isinstance(f.default, int)}
        self._per_layer_hits = np.zeros(L, np.int64)
        self._per_layer_accesses = np.zeros(L, np.int64)
        self._expert_bytes = collab.expert_bytes(self.tiers)
        # each decode layer's phase boundaries (now_ns), read in the layer
        # loop and emitted by _obs_decode
        self._phases = PHASES if ecfg.prefetch else PHASES[:-1]
        self._phase_ns = [[0] * (len(self._phases) + 1) for _ in range(L)]

    @property
    def stats(self) -> EngineStats:
        """Immutable snapshot of the engine counters; the paged-KV channel
        reads the pool (``kv_pages_in_use`` and ``prefix_pages_retained``
        are gauges), the executor-census channel the host executor."""
        c = dict(self._counters)
        ex = self.host_executor
        if ex is not None:
            c.update(census_calls=ex.census_calls,
                     census_threads=ex.census_threads,
                     affinity_hits=ex.affinity_hits,
                     host_busy_us=ex.busy_ns // 1000,
                     host_queue_peak=ex.queue_peak)
        if self.kv_pool is not None:
            c["kv_pages_in_use"] = self.kv_pool.pages_in_use
            c["prefix_hits"] = self.kv_pool.prefix_hits
            c["cow_forks"] = self.kv_pool.cow_forks
            c["prefix_pages_retained"] = self.kv_pool.prefix_pages_retained
        return EngineStats(
            per_layer_hits=tuple(int(x) for x in self._per_layer_hits),
            per_layer_accesses=tuple(int(x) for x in self._per_layer_accesses),
            **c)

    # -- one decode step with the staged collaborative pipeline -----------
    def _decode_step(self, tokens: torch.Tensor, state: Params,
                     active: np.ndarray,
                     pages: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, List[Dict[str, int]]]:
        """tokens [T, 1] on the device; state['pos'] [T] per-slot
        positions; active [T] bool (host) — inactive slots neither touch
        the shared cache nor the stats (paged: nor the pool); pages
        [T, max_pages] per-slot page ids on the device (paged KV only).
        Updates ``state`` in place and returns (logits [T, 1, V],
        per-layer stats).

        With prefetch the layer loop is a software pipeline: after layer
        l's MoE, layer l+1's router on layer l's output predicts layer
        l+1's picks and reserves them; the prediction and its issued
        groups are scored against the next layer's actual routing.

        Each layer reads the clock at its phases' boundaries (``PHASES``)
        into ``self._phase_ns[layer]``, for the drain's phase spans; the
        per-layer stats carry its copy bytes by route."""
        cfg, ccfg, ecfg = self.cfg, self.ecfg.cache, self.ecfg
        K = cfg.moe.top_k
        x = transformer._embed_inputs(self.params, tokens, cfg)
        pos = state["pos"]
        kv = state["scan"]["s0"]
        lp_all = self.params["scan"]["s0"]
        act = torch.from_numpy(np.asarray(active, bool))
        T = act.shape[0]
        NG = min(T * K, cfg.moe.num_experts + 1)    # dispatch groups
        pred_prev = torch.full((T, K), -1, dtype=torch.int32)
        rep_prev = torch.full((NG,), -1, dtype=torch.int32)
        issued_prev = torch.zeros((NG,), dtype=torch.bool)
        stats = []
        for layer in range(cfg.num_layers):
            ts = self._phase_ns[layer]
            ts[0] = now_ns()
            lp = transformer.layer_params(lp_all, layer)
            h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            st = {"k": kv["k"][layer], "v": kv["v"][layer]}
            if ecfg.kv_paged:
                o, _ = attn.decode_attention_paged(
                    lp["attn"], h, st, pos, pages, cfg, self.slot.window,
                    active=act)
            else:
                o, _ = attn.decode_attention(lp["attn"], h, st, pos, cfg,
                                             self.slot.window)
            x = x + o
            h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
            _, top_i, top_w = route(lp["moe"]["router"], h2[:, 0].float(), K)
            ts[1] = now_ns()
            top_i = top_i.to("cpu")         # waits for the device's queue
            ts[2] = now_ns()
            pr = collab.probe(self.tiers, layer, top_i, ccfg, active=act)
            ts[3] = now_ns()
            if ecfg.host_compute:
                y, staged, dstats = hostexec.dispatch_execute(
                    self.tiers, layer, h2[:, 0], top_w, pr, ccfg,
                    self._cpu_table, self.host_executor,
                    ecfg.host_fuse_small)
            else:
                y, staged = collab.execute(self.tiers, layer, h2[:, 0],
                                           top_w, pr, ccfg)
                dstats = {}
            ts[4] = now_ns()
            self.tiers, fetch = collab.commit(self.tiers, layer, pr, staged,
                                              ccfg)
            x = x + y[:, None].to(x.dtype)
            lstats = {**collab._stats(pr, fetch), **dstats,
                      **collab.copy_bytes(pr, staged, fetch,
                                          self._expert_bytes)}
            ts[5] = now_ns()
            if ecfg.prefetch:
                pred_i = self._predict(x, layer, act)
                lstats.update(_score(pred_prev, rep_prev, issued_prev,
                                     pr.flat_e, top_i, act))
                self.tiers, rep_prev, issued_prev, n_issued = \
                    collab.prefetch(self.tiers, layer + 1, pred_i, ccfg,
                                    active=act,
                                    rank_votes=ecfg.prefetch_rank_votes)
                lstats["prefetch_issued"] = n_issued
                pred_prev = pred_i
                ts[6] = now_ns()
            stats.append(lstats)
        x = rmsnorm(self.params["final_norm"], x, cfg.norm_eps)
        logits = transformer.lm_logits(self.params, x, cfg)
        state["pos"] = pos + act.to(device=pos.device, dtype=pos.dtype)
        return logits, stats

    def _predict(self, x: torch.Tensor, layer: int,
                 act: torch.Tensor) -> torch.Tensor:
        """Layer l+1's predicted picks [T, K] (host, -1 = none): its ln2
        and router on layer l's output, masked to active rows and, with
        ``prefetch_min_prob``, to picks whose router probability clears
        it. The last layer predicts nothing (the next token's layer-0
        input is not known before sampling)."""
        cfg = self.cfg
        T, K = act.shape[0], cfg.moe.top_k
        if layer + 1 >= cfg.num_layers:
            return torch.full((T, K), -1, dtype=torch.int32)
        lp = transformer.layer_params(self.params["scan"]["s0"], layer + 1)
        h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        probs, pred_i, _ = route(lp["moe"]["router"], h[:, 0].float(), K)
        gate = act[:, None].expand(T, K)
        if self.ecfg.prefetch_min_prob > 0.0:
            p_pick = torch.gather(probs, 1, pred_i).cpu()
            gate = gate & (p_pick >= self.ecfg.prefetch_min_prob)
        return torch.where(gate, pred_i.cpu().to(torch.int32),
                           torch.full((T, K), -1, dtype=torch.int32))

    # -- batch-state primitives for the scheduler -------------------------
    def init_slots(self) -> Params:
        """Empty decode state for max_batch request slots. Paged KV: the
        per-layer KV leaves are the global pool ``[num_pages, page_size,
        Hk, hd]`` and a fresh :class:`KVPagePool` takes over the page
        bookkeeping (tables bound before are dropped with the old one)."""
        if self.ecfg.kv_paged:
            state = transformer.init_state(self.cfg, self.num_pages,
                                           self.ecfg.page_size, self.device)
            self.kv_pool = KVPagePool(
                self.num_pages, self.ecfg.page_size,
                prefix_keep_pages=self.ecfg.prefix_keep_pages)
            self._slot_tables = [None] * self.ecfg.max_batch
            self._slot_pages = np.full(
                (self.ecfg.max_batch, self.max_pages), self.num_pages,
                np.int32)
        else:
            state = transformer.init_state(self.cfg, self.ecfg.max_batch,
                                           self.ecfg.capacity, self.device)
        state["pos"] = torch.zeros((self.ecfg.max_batch,), dtype=torch.int32,
                                   device=self.device)
        return state

    def write_slot(self, batch_state: Params, one_state: Params,
                   slot: int) -> Params:
        """Copy a single prefilled request's state (B=1) into batch slot
        ``slot``, in place."""
        for name, full in batch_state["scan"]["s0"].items():
            full[:, slot].copy_(one_state["scan"]["s0"][name][:, 0])
        batch_state["pos"][slot] = int(one_state["pos"])
        return batch_state

    def _write_slot_paged(self, batch_state: Params, one_state: Params,
                          page_ids: np.ndarray, write_mask: np.ndarray,
                          slot: int) -> Params:
        """Copy one prefilled request's dense [L, 1, capacity, ...] KV into
        its pool pages, in place: page i of the request lands in physical
        page ``page_ids[i]`` where ``write_mask[i]`` (padding and shared
        prefix pages, which the prefix's first request already wrote and
        others may be reading, are skipped)."""
        sel = np.nonzero(write_mask)[0]
        if sel.size:
            dst = torch.from_numpy(page_ids[sel].astype(np.int64)).to(
                self.device)
            src = torch.from_numpy(sel).to(self.device)
            ps = self.ecfg.page_size
            for name, pool in batch_state["scan"]["s0"].items():
                one = one_state["scan"]["s0"][name][:, 0]
                chunks = one.reshape((one.shape[0], self.max_pages, ps)
                                     + tuple(one.shape[2:]))
                pool[:, dst] = chunks[:, src]
        batch_state["pos"][slot] = int(one_state["pos"])
        return batch_state

    @staticmethod
    def _copy_page(batch_state: Params, src: int, dst: int) -> Params:
        """Copy-on-write: physical page ``src`` into ``dst`` across every
        layer's K and V pools, in place."""
        for pool in batch_state["scan"]["s0"].values():
            pool[:, dst].copy_(pool[:, src])
        return batch_state

    # -- slot lifecycle (scheduler-facing) ---------------------------------
    def can_admit(self, prompt, max_new_tokens: int) -> bool:
        """Page-pool admission gate: True iff the pool can commit pages for
        the prompt plus ``max_new_tokens`` appends right now (shared prefix
        pages excluded). Dense KV has per-slot storage: always True."""
        if not self.ecfg.kv_paged or self.kv_pool is None:
            return True
        p = _one_prompt(prompt)[0]
        return self.kv_pool.can_admit(p, p.shape[0] + int(max_new_tokens))

    def bind_slot(self, batch_state: Params, ticket: PrefillTicket,
                  slot: int) -> Params:
        """Bind a finished prefill to batch slot ``slot``. Paged KV: copy
        the ticket's KV into the table's unshared pages (a segment stream
        already wrote them) and register the prompt's full pages in the
        prefix index, after the write, so the index maps only written
        pages."""
        if not self.ecfg.kv_paged:
            return self.write_slot(batch_state, ticket.state, slot)
        table = ticket.table
        if table is None or ticket.prompt is None:
            raise RuntimeError("paged ticket lost its page table "
                               "(start_prefill not paged?)")
        if ticket.kv_streamed:
            if ticket.logits is None:
                raise RuntimeError(
                    "segment-streamed ticket not drained: advance_prefill "
                    "to done before bind_slot")
            self._slot_tables[slot] = table
            self._slot_pages[slot] = ticket.page_ids
            batch_state["pos"][slot] = ticket.prompt_len
            self.kv_pool.register(ticket.prompt, table)
            return batch_state
        n = len(table.pages)
        ids = np.full((self.max_pages,), self.num_pages, np.int32)
        ids[:n] = table.pages
        mask = np.zeros((self.max_pages,), bool)
        mask[ticket.shared_tokens // self.ecfg.page_size:n] = True
        self._slot_tables[slot] = table
        self._slot_pages[slot] = ids
        state = self._write_slot_paged(batch_state, ticket.state, ids, mask,
                                       slot)
        self.kv_pool.register(ticket.prompt, table)
        return state

    def claim_slot(self, ticket: PrefillTicket, slot: int) -> None:
        """Bind a segment-streamed ticket's page table to its slot before
        the stream drains, so a cancel mid-stream releases the pages
        through :meth:`release_slot` (decode never reads a PREFILLING
        slot: inactive rows' writes drop). Dense KV: nothing to claim."""
        if not self.ecfg.kv_paged or ticket.table is None:
            return
        self._slot_tables[slot] = ticket.table
        self._slot_pages[slot] = ticket.page_ids

    def release_slot(self, slot: int) -> None:
        """Return a retired or cancelled slot's pages to the pool (pages a
        prefix-sharing peer still holds stay). Dense KV: no-op, the slot's
        rows are overwritten on reuse."""
        if not self.ecfg.kv_paged:
            return
        table = self._slot_tables[slot]
        if table is not None:
            self.kv_pool.free(table)
            self._slot_tables[slot] = None
            self._slot_pages[slot] = self.num_pages

    def abort_ticket(self, ticket: PrefillTicket) -> None:
        """Release an open ticket's page table after a failed admission.
        Idempotent: the table is taken once, a slot that already claimed
        it is unbound first; dense tickets are a no-op."""
        table, ticket.table = ticket.table, None
        if table is None or self.kv_pool is None:
            return
        for i, t in enumerate(self._slot_tables):
            if t is table:
                self._slot_tables[i] = None
                self._slot_pages[i] = self.num_pages
        self.kv_pool.free(table)

    def fork_slot(self, batch_state: Params, src: int, dst: int,
                  total_tokens: int) -> Params:
        """Clone slot ``src``'s sequence into free slot ``dst`` sharing ALL
        its KV pages (nothing is copied now; the partial last page is
        copied on write by whichever side appends first). total_tokens
        bounds the child's final length for page commitment."""
        if not self.ecfg.kv_paged:
            raise RuntimeError("fork_slot requires EngineConfig.kv_paged")
        parent = self._slot_tables[src]
        if parent is None:
            raise ValueError(f"slot {src} holds no page table")
        child = self.kv_pool.fork(parent, int(total_tokens))
        self._slot_tables[dst] = child
        ids = np.full((self.max_pages,), self.num_pages, np.int32)
        ids[:len(child.pages)] = child.pages
        self._slot_pages[dst] = ids
        batch_state["pos"][dst] = batch_state["pos"][src]
        return batch_state

    # -- prefill -------------------------------------------------------------
    def _require_dense(self, what: str) -> None:
        """The synchronous convenience paths make dense-shaped states with
        no page bookkeeping: under kv_paged they refuse."""
        if self.ecfg.kv_paged:
            raise RuntimeError(
                f"{what}() is a dense-KV path; under EngineConfig.kv_paged "
                f"use the scheduler primitives (start_prefill / bind_slot "
                f"/ decode_batch / release_slot)")

    def prefill(self, tokens) -> Tuple[torch.Tensor, Params]:
        """Bypass prefill (the tiers untouched: the cache stays cold until
        decode). tokens [B, P] -> (last-real-position logits [B, 1, V],
        decode state with pos = P)."""
        self._require_dense("prefill")
        logits, state, _ = self._padded_prefill(_host_tokens(tokens))
        return logits, state

    def _prefill_trace(self, tokens: torch.Tensor, plen: int,
                       want_trace: bool = False):
        """Full-prompt forward over tokens [B, capacity] (prompt
        left-aligned, zero-padded). Returns (logits at position plen-1
        [B, 1, V], decode state with pos = plen, trace | None)."""
        x, state, trace = self._forward(tokens, "prefill",
                                        want_trace=want_trace)
        logits = transformer.lm_logits(self.params, x[:, plen - 1:plen],
                                       self.cfg)
        state = {"scan": state["scan"],
                 "pos": torch.tensor(plen, dtype=torch.int32)}
        return logits, state, (trace["scan"]["s0"] if want_trace else None)

    def _forward(self, tokens: torch.Tensor, mode: str, **kw):
        """One prefill forward (``transformer.backbone`` in ``mode``) with
        an expert source of its own (:class:`collab.ForwardExperts`), made
        before the call and closed when it returns: each layer's table
        with each resident expert read from its slot, the rest from the
        host tier, queued a layer ahead; counts the reads."""
        reads = collab.ForwardExperts(self.tiers, self.ecfg.cache)
        c = self._counters

        def source(layer: int):
            table, resident, ahead = reads.read(layer)
            c["prefill_forward_resident"] += resident
            c["prefill_forward_experts"] += table[0].shape[0]
            c["prefill_forward_ahead"] += ahead
            return table

        try:
            return transformer.backbone(self.params, tokens, self.cfg, mode,
                                        expert_source=source, **kw)
        finally:
            reads.close()

    def _check_prompt_len(self, P: int) -> None:
        cap = self.ecfg.capacity
        if not 1 <= P < cap:
            raise ValueError(
                f"prompt length {P} outside [1, capacity={cap}) — decode "
                f"needs at least one free KV slot")

    def _padded_prefill(self, tokens: np.ndarray, want_trace: bool = False):
        B, P = tokens.shape
        self._check_prompt_len(P)
        padded = np.zeros((B, self.ecfg.capacity), np.int64)
        padded[:, :P] = tokens
        return self._prefill_trace(torch.from_numpy(padded).to(self.device),
                                   P, want_trace=want_trace)

    def _warm_chunk(self, top_i: torch.Tensor, active: torch.Tensor
                    ) -> List[Dict[str, int]]:
        """Route one prompt chunk's picks (top_i [L, C, K], host; active
        [C]) through probe -> commit: the demand accesses and the
        post-fetch warm the shared tiers exactly as a decode step would.
        No FFN runs (its output would have no consumer)."""
        ccfg = self.ecfg.cache
        stats = []
        for layer in range(self.cfg.num_layers):
            pr = collab.probe(self.tiers, layer, top_i[layer], ccfg,
                              active=active)
            self.tiers, fetch = collab.commit(self.tiers, layer, pr, None,
                                              ccfg)
            stats.append(collab._stats(pr, fetch))
        return stats

    def _segment_step(self, tokens: torch.Tensor, scan_state: Params,
                      pos0: int, plen: int, pages: Optional[torch.Tensor],
                      wmin: Optional[int], warm: bool = True):
        """One C-token prompt segment, forward and warm fused: the
        backbone's segment mode appends the segment's KV (into the
        ticket's dense cache, or with ``pages`` into the pool, writes
        masked to ``[wmin, plen)`` so shared prefix pages stay as they
        are) and (``warm``) its routing goes through probe -> commit.
        Returns (logits at ``plen - 1`` clamped into the segment, scan
        state, new pos clamped to plen, warm stats | None)."""
        C = tokens.shape[1]
        x, new_state, trace = self._forward(
            tokens, "segment", want_trace=warm,
            state={"scan": scan_state, "pos": pos0}, pages=pages,
            kv_write_min=wmin, kv_write_max=plen)
        rel = min(max(plen - 1 - pos0, 0), C - 1)
        logits = transformer.lm_logits(self.params, x[:, rel:rel + 1],
                                       self.cfg)
        wstats = None
        if warm:
            top_i = trace["scan"]["s0"]["top_i"][:, 0].cpu()    # [L, C, K]
            active = (pos0 + torch.arange(C)) < plen
            wstats = self._warm_chunk(top_i, active)
        return logits, new_state["scan"], min(pos0 + C, plen), wstats

    def start_prefill(self, prompt, chunk: Optional[int] = None,
                      max_total_tokens: Optional[int] = None
                      ) -> PrefillTicket:
        """Open a prefill ticket (``chunk == 0``: bypass, no warming).

        Trace replay: the prefill forward runs here and the ticket carries
        its logits, state and routing. Segment stream
        (``prefill_segment``): no forward runs here; the ticket comes back
        with ``logits is None`` and :meth:`advance_prefill_state` streams
        the prompt. Paged KV: the pool allocates the request's pages here,
        committed up to ``max_total_tokens`` (default: capacity); a
        prefix-index hit shares the matching full pages, and their
        warming (and, streamed, their forward) is skipped. Raises
        :class:`~repro_torch.serving.kv_pool.PoolExhausted` when the pool
        cannot commit (gate with :meth:`can_admit`); any error after the
        allocation frees the pages before it propagates."""
        chunk = self.ecfg.prefill_chunk if chunk is None else int(chunk)
        if chunk < 0:
            raise ValueError(f"chunk must be >= 0, got {chunk}")
        prompt = _one_prompt(prompt)
        table, shared = None, 0
        if self.ecfg.kv_paged:
            if self.kv_pool is None:
                raise RuntimeError(
                    "paged KV: call init_slots() before start_prefill()")
            total = (self.ecfg.capacity if max_total_tokens is None
                     else int(max_total_tokens))
            table, shared = self.kv_pool.alloc_prompt(prompt[0], total)
        try:
            return self._open_ticket(prompt, chunk, table, shared)
        except BaseException:
            if table is not None:
                self.kv_pool.free(table)
            raise

    def _open_ticket(self, prompt: np.ndarray, chunk: int,
                     table: Optional[PageTable], shared: int
                     ) -> PrefillTicket:
        P = prompt.shape[1]
        if self.ecfg.prefill_segment > 0:
            return self._start_segmented(prompt, table, shared,
                                         warm=chunk != 0)
        t0, snap = now_ns(), dict(self._counters)
        if chunk == 0:
            logits, state, _ = self._padded_prefill(prompt)
            self._obs_prefill_forward(t0, now_ns(), P, snap)
            return PrefillTicket(prompt_len=P, chunk=0, n_chunks=0,
                                 logits=logits, state=state, table=table,
                                 prompt=prompt[0], shared_tokens=shared)
        logits, state, trace = self._padded_prefill(prompt, want_trace=True)
        n_chunks = -(-P // chunk)
        pad_to = n_chunks * chunk
        top_i = trace["top_i"][:, 0].cpu()                   # [L, S, K]
        self._obs_prefill_forward(t0, now_ns(), P, snap)
        if pad_to > top_i.shape[1]:
            top_i = torch.nn.functional.pad(
                top_i, (0, 0, 0, pad_to - top_i.shape[1]))
        return PrefillTicket(prompt_len=P, chunk=chunk, n_chunks=n_chunks,
                             logits=logits, state=state,
                             top_i=top_i[:, :pad_to],
                             cursor=min(shared // chunk, n_chunks),
                             table=table, prompt=prompt[0],
                             shared_tokens=shared)

    def _start_segmented(self, prompt: np.ndarray,
                         table: Optional[PageTable], shared: int,
                         warm: bool) -> PrefillTicket:
        """A segment-streamed ticket: tokens and cursor, no forward. A
        prefix hit starts the stream past the shared span, at
        ``min(shared, P - 1)``: the last prompt token is always forwarded
        (reading the shared pages, its write masked) for the first-token
        logits."""
        P = prompt.shape[1]
        self._check_prompt_len(P)
        seg = self.ecfg.prefill_segment
        fwd_start = min(shared, P - 1)
        n_seg = -(-(P - fwd_start) // seg)
        tok = np.zeros((1, fwd_start + n_seg * seg), np.int64)
        tok[:, :P] = prompt
        self._counters["prefix_tokens_skipped"] += fwd_start
        ticket = PrefillTicket(
            prompt_len=P, chunk=seg, n_chunks=n_seg, seg=seg,
            fwd_start=fwd_start, tokens=tok, warm=warm, table=table,
            prompt=prompt[0], shared_tokens=shared)
        if self.ecfg.kv_paged:
            ids = np.full((self.max_pages,), self.num_pages, np.int32)
            ids[:len(table.pages)] = table.pages
            ticket.page_ids = ids
            ticket.kv_streamed = True
        else:
            state = transformer.init_state(self.cfg, 1, self.ecfg.capacity,
                                           self.device)
            ticket.state = {"scan": state["scan"], "pos": fwd_start}
        return ticket

    def advance_prefill(self, ticket: PrefillTicket,
                        max_chunks: int = 1) -> bool:
        """Advance a ticket by up to ``max_chunks`` units (warm chunks, or
        dense prompt segments). Returns True when drained."""
        _, done = self.advance_prefill_state(ticket, None, max_chunks)
        return done

    def advance_prefill_state(self, ticket: PrefillTicket,
                              batch_state: Optional[Params],
                              max_chunks: int = 1
                              ) -> Tuple[Optional[Params], bool]:
        """Scheduler-facing twin of :meth:`advance_prefill`: a paged
        segment stream appends its KV into the batch pool, so the batch
        state rides through (other modes leave it untouched). Returns
        (batch_state, done)."""
        t0 = now_ns()
        if ticket.seg > 0:
            n = self._advance_segments(ticket, batch_state, max_chunks)
            self._counters["prefill_segments"] += n
        else:
            n = self._advance_warm(ticket, max_chunks)
        self._obs_prefill(t0, n, ticket)
        return batch_state, ticket.done

    def _advance_warm(self, ticket: PrefillTicket, max_chunks: int) -> int:
        chunk, P = ticket.chunk, ticket.prompt_len
        n = 0
        while ticket.cursor < ticket.n_chunks and n < max_chunks:
            s = ticket.cursor * chunk
            active = torch.arange(s, s + chunk) < P
            stats = self._warm_chunk(ticket.top_i[:, s:s + chunk], active)
            self._accumulate_prefill(stats, min(chunk, P - s))
            ticket.cursor += 1
            n += 1
        self._counters["prefill_chunks"] += n
        return n

    def _advance_segments(self, ticket: PrefillTicket,
                          batch_state: Optional[Params],
                          max_chunks: int) -> int:
        P, seg = ticket.prompt_len, ticket.seg
        if ticket.kv_streamed and batch_state is None:
            raise RuntimeError(
                "paged segment stream appends into the batch pool: use "
                "advance_prefill_state(ticket, batch_state)")
        n = 0
        while ticket.cursor < ticket.n_chunks and n < max_chunks:
            s = ticket.fwd_start + ticket.cursor * seg
            tok = torch.from_numpy(ticket.tokens[:, s:s + seg]).to(
                self.device)
            if ticket.kv_streamed:
                pages = torch.from_numpy(ticket.page_ids[None]).to(
                    self.device)
                logits, _, _, wstats = self._segment_step(
                    tok, batch_state["scan"], s, P, pages,
                    ticket.shared_tokens, ticket.warm)
            else:
                logits, scan, pos, wstats = self._segment_step(
                    tok, ticket.state["scan"], s, P, None, None,
                    ticket.warm)
                ticket.state = {"scan": scan, "pos": pos}
            ticket.logits = logits
            if ticket.warm:
                self._accumulate_prefill(wstats, max(0, min(seg, P - s)))
                self._counters["prefill_chunks"] += 1
            ticket.cursor += 1
            n += 1
        return n

    def prefill_chunked(self, prompt, chunk: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Params]:
        """Prefill forward plus the whole warming replay, synchronously
        (dense KV)."""
        self._require_dense("prefill_chunked")
        chunk = self.ecfg.prefill_chunk if chunk is None else int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        ticket = self.start_prefill(prompt, chunk)
        try:
            self.advance_prefill(ticket, ticket.n_chunks)
        except BaseException:
            self.abort_ticket(ticket)
            raise
        return ticket.logits, ticket.state

    def sample_first(self, ticket: PrefillTicket,
                     sampling: SamplingParams = GREEDY,
                     seed: Optional[int] = None) -> int:
        """A request's first token from its prefill logits (``seed``: the
        request's first-step seed; required for non-greedy sampling)."""
        if ticket.logits is None:
            raise RuntimeError(
                "segment-streamed ticket has no logits yet: drain "
                "advance_prefill to done before sample_first")
        seeds = None if seed is None else [seed]
        tok = int(self.select_tokens(ticket.logits[:, 0], [sampling],
                                     seeds)[0])
        self._counters["first_tokens"] += 1
        return tok

    def prefill_request(self, prompt, sampling: SamplingParams = GREEDY,
                        seed: Union[None, int, torch.Generator] = None
                        ) -> Tuple[int, Params]:
        """Prefill one request synchronously; returns (first token, decode
        state with pos = len(prompt), B = 1). Warms the cache chunk by
        chunk when ``EngineConfig.prefill_chunk > 0``, bypasses it
        otherwise: the first token is the same either way. ``seed`` is
        the request's first-step seed (an int, or drawn from a
        ``torch.Generator``), needed only for non-greedy sampling. The
        scheduler uses the ticket primitives instead."""
        self._require_dense("prefill_request")
        seed = _seed_of(seed)
        ticket = self.start_prefill(prompt)
        try:
            self.advance_prefill(ticket, ticket.n_chunks)
            tok = self.sample_first(ticket, sampling, seed)
        except BaseException:
            self.abort_ticket(ticket)
            raise
        return tok, ticket.state

    # -- vectorized per-slot sampling --------------------------------------
    def select_tokens(self, logits: torch.Tensor,
                      sampling: Union[None, SamplingParams,
                                      Sequence[SamplingParams]] = None,
                      seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Next tokens from step logits [T, V], one SamplingParams per row
        (None = all greedy); ``seeds`` [T] per-row step seeds, needed as
        soon as any row samples. Returns [T] int32 on the host."""
        T = logits.shape[0]
        if sampling is None:
            sampling = [GREEDY] * T
        elif isinstance(sampling, SamplingParams):
            sampling = [sampling] * T
        if len(sampling) != T:
            raise ValueError(f"params batch {len(sampling)} != rows {T}")
        greedy, temp, top_k, top_p = batch_arrays(sampling)
        if greedy.all():
            return logits.float().argmax(-1).cpu().to(torch.int32)
        if seeds is None:
            raise ValueError("non-greedy sampling needs per-row seeds")
        return sample_tokens(logits, greedy, temp, top_k, top_p, seeds)

    def decode_batch(self, tokens, state: Params, active
                     ) -> Tuple[torch.Tensor, Params]:
        """One padded decode step for the whole slot batch. tokens [T, 1];
        active [T] bool. Updates the shared tiers, the state (in place)
        and the counters (inactive rows excluded); returns (logits,
        state).

        Paged KV: before the step every active slot plans this token's
        append (a fresh page on a page boundary, a copy-on-write of a
        partial last page another table shares) and the page-id rows go
        to the device; after the step the appends commit."""
        t0 = now_ns()
        active_np = np.asarray(active, bool)
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        pages = None
        act = np.nonzero(active_np)[0]
        if self.ecfg.kv_paged:
            for t in act:
                table = self._slot_tables[int(t)]
                if table is None:
                    raise RuntimeError(
                        f"active slot {t} has no bound page table — "
                        f"admit requests via bind_slot under kv_paged")
                plan = self.kv_pool.prepare_append(table)
                if plan.cow_src is not None:
                    state = self._copy_page(state, plan.cow_src, plan.page)
                self._slot_pages[int(t), len(table.pages) - 1] = plan.page
            pages = torch.from_numpy(self._slot_pages).to(self.device)
        t_plan = now_ns()
        # the host lane runs inside the step here (in the reference,
        # after its asynchronous dispatch returned): read its busy time
        # before the step, and time the step's work from here on
        busy0 = (self.host_executor.mark()
                 if self.host_executor is not None else 0)
        logits, stats = self._decode_step(tok.to(self.device), state,
                                          active_np, pages)
        t_disp = now_ns()
        if self.ecfg.kv_paged:
            for t in act:
                self.kv_pool.commit_append(self._slot_tables[int(t)])
        t_commit = now_ns()
        snap = dict(self._counters)
        n_active = int(active_np.sum())
        self._accumulate(stats, n_active)
        self._obs_decode(t0, t_plan, t_disp, t_commit, snap, busy0,
                         n_active, stats)
        return logits, state

    def _accumulate(self, stats: List[Dict[str, int]], n_active: int) -> None:
        c = self._counters
        for layer, s in enumerate(stats):
            for k, v in s.items():
                c[RENAMED.get(k, k)] += v
            self._per_layer_hits[layer] += s["hits"]
            self._per_layer_accesses[layer] += s["accesses"]
        c["tokens"] += n_active
        c["steps"] += 1

    # -- static-batch convenience path -------------------------------------
    def generate(self, prompt, steps: int,
                 sampling: SamplingParams = GREEDY,
                 seed: Union[None, int, torch.Generator] = None
                 ) -> Tuple[np.ndarray, EngineStats]:
        """Static-batch generation: all prompt rows [B, P] start and stop
        together with one shared SamplingParams (the scheduler interleaves
        requests with per-request sampling instead), through the bypass
        prefill (warming is per request). Returns (tokens [B, steps], the
        engine's stats): the B prefill-sampled tokens count in
        ``first_tokens``, each decode step's in ``tokens``.

        Seeded sampling: row r's draw at step i uses the seed
        ``step_seed(step_seed(base, i), r)``, ``base`` being
        ``sampling.seed``, else ``seed`` (an int, or drawn from a
        ``torch.Generator``), else 0. Same base, same tokens; rows draw
        independently. Greedy needs no seed."""
        self._require_dense("generate")
        prompt = _host_tokens(prompt)
        B, P = prompt.shape
        base = sampling.seed if sampling.seed is not None else \
            (_seed_of(seed) or 0)

        def step_seeds(i: int) -> Optional[List[int]]:
            if sampling.greedy:
                return None
            s = step_seed(base, i)
            return [step_seed(s, r) for r in range(B)]

        logits, state = self.prefill(prompt)
        state["pos"] = torch.full((B,), P, dtype=torch.int32,
                                  device=self.device)
        tok = self.select_tokens(logits[:, 0], sampling, step_seeds(0))
        self._counters["first_tokens"] += B
        active = np.ones(B, bool)
        out = [tok.numpy()]
        for i in range(steps - 1):
            logits, stats = self._decode_step(
                tok[:, None].to(self.device, torch.int64), state, active)
            tok = self.select_tokens(logits[:, 0], sampling,
                                     step_seeds(i + 1))
            out.append(tok.numpy())
            self._accumulate(stats, B)
        return np.stack(out, 1), self.stats

    def _accumulate_prefill(self, stats: List[Dict[str, int]],
                            n_tokens: int) -> None:
        """Fold one warm chunk's per-layer stats into the prefill channel."""
        c = self._counters
        c["prefill_hits"] += sum(s["hits"] for s in stats)
        c["prefill_accesses"] += sum(s["accesses"] for s in stats)
        c["prefill_fetched"] += sum(s["fetched_experts"] for s in stats)
        c["prefill_tokens"] += n_tokens

    # -- trace drain helpers (the ONLY emission sites) ---------------------
    def _since(self, snap: Dict[str, int], name: str) -> int:
        """The change of counter ``name`` since ``snap``, a copy of the
        counter record."""
        return self._counters[name] - snap[name]

    def _obs_decode(self, t0: int, t_plan: int, t_disp: int, t_commit: int,
                    snap: Dict[str, int], busy0: int, n_active: int,
                    stats: List[Dict[str, int]]) -> None:
        """Drain point: emit the decode step's phase spans and lane
        attribution AFTER ``_accumulate`` drained the step's stats. The
        layer loop syncs inside every layer (the picks read of each layer's
        routing), so ``dispatch`` covers almost the whole step and
        ``execute+drain`` only what is left after it; inside ``dispatch``,
        each layer's host phases from the layer loop's clock readings.
        ``snap``: the counter record before the step's stats drained."""
        t1 = now_ns()
        obs = self.obs
        hit = self._since(snap, "hits")
        fetch = self._since(snap, "fetched_experts")
        cpu = self._since(snap, "cpu_expert_calls")
        obs.complete("engine", "decode_step", t0, t1,
                     {"tokens": n_active, "hit_experts": hit,
                      "fetched_experts": fetch, "cpu_expert_calls": cpu})
        if self.ecfg.kv_paged:
            obs.complete("engine", "plan", t0, t_plan)
        obs.complete("engine", "dispatch", t_plan, t_disp)
        if self.ecfg.kv_paged:
            obs.complete("engine", "commit", t_disp, t_commit)
        obs.complete("engine", "execute+drain", t_commit, t1)
        if obs.enabled:
            # a span a phase a layer (125 a Mixtral step): skipped outright
            # when tracing is off
            self._obs_layers(stats)
        # per-step lane attribution: the gpu-hit vs fetch vs cpu-miss
        # split of this step's assignments
        obs.counter("lane:gpu", "hit_experts", hit, ts_ns=t1)
        obs.counter("lane:fetch", "fetched_experts", fetch, ts_ns=t1)
        obs.counter("lane:cpu", "cpu_expert_calls", cpu, ts_ns=t1)
        issued = self._since(snap, "prefetch_issued")
        if issued:
            obs.instant("lane:fetch", "prefetch_reserve", {"issued": issued},
                        ts_ns=t1)
        landed = self._since(snap, "prefetch_hits")
        if landed:
            obs.instant("lane:gpu", "prefetch_land", {"hits": landed},
                        ts_ns=t1)
        ex = self.host_executor
        if ex is not None and ex.busy_ns > busy0:
            # where the host pool ran this step: its first piece of work's
            # start to its last one's end
            obs.complete("lane:cpu", "host_execute", ex.first_ns,
                         ex.last_ns, {"queue_peak": ex.queue_peak})
        if self.kv_pool is not None:
            pool = self.kv_pool
            obs.counter("engine", "kv_pages_in_use", pool.pages_in_use,
                        ts_ns=t1)
            for name, cur in (("prefix_hits", pool.prefix_hits),
                              ("cow_forks", pool.cow_forks),
                              ("retention_evictions",
                               pool.retention_evictions)):
                prev = self._obs_prev.get(name, 0)
                if cur > prev:
                    obs.instant("engine", name, {"count": cur - prev},
                                ts_ns=t1)
                    self._obs_prev[name] = cur

    def _obs_layers(self, stats: List[Dict[str, int]]) -> None:
        """The decode step's per-layer phase spans, tiling each layer from
        its clock readings: ``execute`` carries the layer's staged weight
        bytes, ``post_fetch`` its slot writes' bytes."""
        obs, names = self.obs, self._phases
        for layer, (row, s) in enumerate(zip(self._phase_ns, stats)):
            for i, name in enumerate(names):
                args = {"layer": layer}
                if name == "execute":
                    args.update(d2d_bytes=s["stage_d2d_bytes"],
                                h2d_bytes=s["stage_h2d_bytes"])
                elif name == "post_fetch":
                    args.update(d2d_bytes=s["slot_d2d_bytes"],
                                h2d_bytes=s["slot_h2d_bytes"])
                obs.complete("engine", name, row[i], row[i + 1], args)

    def _obs_prefill_forward(self, t0: int, t1: int, tokens: int,
                             snap: Dict[str, int]) -> None:
        """Drain point: the admission's padded prefill forward, from
        before its launch to its routing reaching the host. On the bypass
        path (``chunk == 0``) no routing is read, and the span times the
        launches only. ``snap``: the counter record before it. Args:
        the expert tables' reads, ``resident_experts`` of ``experts``, the
        bytes they copied, ``d2d_bytes`` from the slots and ``h2d_bytes``
        from the host tier, and ``ahead_experts``, the host reads queued
        before their layer asked for its table."""
        resident = self._since(snap, "prefill_forward_resident")
        total = self._since(snap, "prefill_forward_experts")
        ahead = self._since(snap, "prefill_forward_ahead")
        nbytes = self._expert_bytes
        self.obs.complete("engine", "prefill_forward", t0, t1,
                          {"tokens": tokens,
                           "h2d_bytes": (total - resident) * nbytes,
                           "d2d_bytes": resident * nbytes,
                           "resident_experts": resident, "experts": total,
                           "ahead_experts": ahead})

    def _obs_prefill(self, t0: int, n_units: int,
                     ticket: PrefillTicket) -> None:
        """Drain point: one span per :meth:`advance_prefill_state` call
        (its per-unit stats already reached the host), covering the
        segments or warm chunks it advanced."""
        if n_units == 0:
            return
        self.obs.complete(
            "engine",
            "segment_stream" if ticket.seg > 0 else "warm_replay",
            t0, now_ns(),
            {"units": n_units, "cursor": ticket.cursor,
             "of": ticket.n_chunks})
