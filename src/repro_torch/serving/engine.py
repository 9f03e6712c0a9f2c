"""Collaborative serving engine, dense KV path (counterpart of the
reference's ``serving/engine.py``).

Serves a homogeneous MoE LM with the expert weights split across the two
tiers of :mod:`repro_torch.core.collaborative`: attention, router and norm
weights plus the N-index M-way expert cache's slot buffer on the GPU; the
full expert table in pinned host memory. Every decode step runs, per
layer: rmsnorm, dense decode attention, the router, then probe (host-side
cache check + grouping) -> execute (grouped gmm kernels over weights
staged once per unique expert) -> commit (post-fetch into the slots).

Prefill is request-shaped and resumable, as in the reference:
:meth:`start_prefill` runs the one prefill forward (the backbone's prefill
mode, emitting the routing trace) and returns a :class:`PrefillTicket`;
:meth:`advance_prefill` replays the prompt's routing trace chunk by chunk
through probe -> commit so the prompt's own routing warms the shared
cache before decode. Like the reference, whose FFN output in the replay
has no consumer and is pruned by XLA, the replay runs no FFN: what is
left is the probe and the post-fetch's weight copies.

Differences from the reference, all in how, never in what: the cache
state and its bookkeeping live on the host; KV caches and slot buffers are
updated in place; the layer loop is a Python loop. Not ported yet (each
raises in :class:`EngineConfig`): prefetch, host compute, paged KV,
segment prefill, prefix retention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import CacheConfig, ModelConfig
from repro_torch.core import collaborative as collab
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.layers import rmsnorm
from repro_torch.models.moe import route
from repro_torch.obs.trace import NULL_RECORDER, now_ns
from .sampling import GREEDY, SamplingParams, batch_arrays, sample_tokens
from .stats import EngineStats

Params = Dict[str, Any]

# options of the reference's EngineConfig that this port does not run yet,
# with the value that means "off"
UNPORTED = {"prefetch": False, "host_compute": False, "kv_paged": False,
            "prefill_segment": 0, "prefix_keep_pages": 0}


@dataclass(frozen=True)
class EngineConfig:
    """Engine geometry and pipeline toggles (sampling is per request)."""
    cache: CacheConfig
    max_batch: int = 1            # concurrent request slots (T)
    capacity: int = 512           # KV capacity
    prefill_chunk: int = 8        # cache-warming prefill chunk (0 = bypass)
    # overlapped admission: advance a newly admitted request's warming
    # replay by at most this many chunks per scheduler tick (0 = all at
    # once on the admission tick)
    admit_chunks_per_tick: int = 0
    prefetch: bool = False
    prefill_segment: int = 0
    host_compute: bool = False
    kv_paged: bool = False
    prefix_keep_pages: int = 0

    def __post_init__(self):
        for name, off in UNPORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported to repro_torch yet")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.admit_chunks_per_tick < 0:
            raise ValueError(
                f"admit_chunks_per_tick must be >= 0, got "
                f"{self.admit_chunks_per_tick}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")


@dataclass(eq=False)
class PrefillTicket:
    """Resumable cache-warming prefill for ONE request. The prefill forward
    already ran, so ``logits`` and ``state`` are final; the ticket holds
    the prompt's routing picks padded to whole chunks (``top_i``
    [L, n_chunks*chunk, K], on the host) and the replay cursor."""
    prompt_len: int
    chunk: int                    # warm-chunk token count (0 = bypass)
    n_chunks: int
    logits: Optional[torch.Tensor] = None   # [1, 1, V]
    state: Optional[Params] = None          # decode state, pos = prompt_len
    top_i: Optional[torch.Tensor] = None
    cursor: int = 0
    prompt: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return self.cursor >= self.n_chunks

    @property
    def remaining(self) -> int:
        return self.n_chunks - self.cursor


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
        self.obs = recorder if recorder is not None else NULL_RECORDER
        moe_p = params["scan"]["s0"]["moe"]
        self.tiers = collab.init_tiers(
            moe_p["w1"], moe_p["w3"], moe_p["w2"], ecfg.cache,
            num_experts=cfg.moe.num_experts,
            generator=torch.Generator().manual_seed(seed),
            device=self.device)
        L = cfg.num_layers
        self._counters = {
            "hits": 0, "accesses": 0, "host_assignments": 0,
            "fetched_experts": 0, "tokens": 0, "steps": 0,
            "prefetch_hits": 0, "prefill_hits": 0, "prefill_accesses": 0,
            "prefill_fetched": 0, "prefill_tokens": 0, "prefill_chunks": 0,
            "first_tokens": 0}
        self._per_layer_hits = np.zeros(L, np.int64)
        self._per_layer_accesses = np.zeros(L, np.int64)

    @property
    def stats(self) -> EngineStats:
        """Immutable snapshot of the engine counters."""
        return EngineStats(
            per_layer_hits=tuple(int(x) for x in self._per_layer_hits),
            per_layer_accesses=tuple(int(x) for x in self._per_layer_accesses),
            **self._counters)

    # -- one decode step with the staged collaborative pipeline -----------
    def _decode_step(self, tokens: torch.Tensor, state: Params,
                     active: np.ndarray
                     ) -> Tuple[torch.Tensor, List[Dict[str, int]]]:
        """tokens [T, 1] on the device; state['pos'] [T] per-slot
        positions; active [T] bool (host) — inactive slots neither touch
        the shared cache nor the stats. Updates ``state`` in place and
        returns (logits [T, 1, V], per-layer stats)."""
        cfg, ccfg = self.cfg, self.ecfg.cache
        K = cfg.moe.top_k
        x = transformer._embed_inputs(self.params, tokens, cfg)
        pos = state["pos"]
        kv = state["scan"]["s0"]
        lp_all = self.params["scan"]["s0"]
        act = torch.from_numpy(np.asarray(active, bool))
        stats = []
        for layer in range(cfg.num_layers):
            lp = transformer.layer_params(lp_all, layer)
            h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            o, _ = attn.decode_attention(
                lp["attn"], h, {"k": kv["k"][layer], "v": kv["v"][layer]},
                pos, cfg, self.slot.window)
            x = x + o
            h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
            _, top_i, top_w = route(lp["moe"]["router"], h2[:, 0].float(), K)
            pr = collab.probe(self.tiers, layer, top_i, ccfg, active=act)
            y, staged = collab.execute(self.tiers, layer, h2[:, 0], top_w,
                                       pr, ccfg)
            self.tiers, fetch = collab.commit(self.tiers, layer, pr, staged,
                                              ccfg)
            x = x + y[:, None].to(x.dtype)
            stats.append(collab._stats(pr, fetch))
        x = rmsnorm(self.params["final_norm"], x, cfg.norm_eps)
        logits = transformer.lm_logits(self.params, x, cfg)
        state["pos"] = pos + act.to(device=pos.device, dtype=pos.dtype)
        return logits, stats

    # -- batch-state primitives for the scheduler -------------------------
    def init_slots(self) -> Params:
        """Empty decode state for max_batch request slots."""
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

    def can_admit(self, prompt, max_new_tokens: int) -> bool:
        """Dense KV has per-slot storage by construction: always True."""
        return True

    def bind_slot(self, batch_state: Params, ticket: PrefillTicket,
                  slot: int) -> Params:
        """Bind a finished prefill to batch slot ``slot``."""
        return self.write_slot(batch_state, ticket.state, slot)

    def claim_slot(self, ticket: PrefillTicket, slot: int) -> None:
        """Dense KV: nothing to claim before binding."""

    def release_slot(self, slot: int) -> None:
        """Dense KV: the slot's rows are overwritten on reuse."""

    def abort_ticket(self, ticket: PrefillTicket) -> None:
        """Dense KV: an open ticket holds no pool pages to release."""

    # -- prefill -------------------------------------------------------------
    def _prefill_trace(self, tokens: torch.Tensor, plen: int,
                       want_trace: bool = False):
        """Full-prompt forward over tokens [B, capacity] (prompt
        left-aligned, zero-padded). Returns (logits at position plen-1
        [B, 1, V], decode state with pos = plen, trace | None)."""
        x, state, trace = transformer.backbone(
            self.params, tokens, self.cfg, "prefill", want_trace=want_trace)
        logits = transformer.lm_logits(self.params, x[:, plen - 1:plen],
                                       self.cfg)
        state = {"scan": state["scan"],
                 "pos": torch.tensor(plen, dtype=torch.int32)}
        return logits, state, (trace["scan"]["s0"] if want_trace else None)

    def _padded_prefill(self, tokens: np.ndarray, want_trace: bool = False):
        B, P = tokens.shape
        cap = self.ecfg.capacity
        if not 1 <= P < cap:
            raise ValueError(
                f"prompt length {P} outside [1, capacity={cap}) — decode "
                f"needs at least one free KV slot")
        padded = np.zeros((B, cap), np.int64)
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

    def start_prefill(self, prompt, chunk: Optional[int] = None,
                      max_total_tokens: Optional[int] = None
                      ) -> PrefillTicket:
        """Run the prefill forward once and open a cache-warming ticket
        (``chunk == 0``: bypass, the ticket is born done).
        ``max_total_tokens`` is accepted for the scheduler's paged-KV
        signature and unused with dense KV."""
        chunk = self.ecfg.prefill_chunk if chunk is None else int(chunk)
        if chunk < 0:
            raise ValueError(f"chunk must be >= 0, got {chunk}")
        return self._open_ticket(_one_prompt(prompt), chunk)

    def _open_ticket(self, prompt: np.ndarray, chunk: int) -> PrefillTicket:
        P = prompt.shape[1]
        if chunk == 0:
            logits, state, _ = self._padded_prefill(prompt)
            return PrefillTicket(prompt_len=P, chunk=0, n_chunks=0,
                                 logits=logits, state=state, prompt=prompt[0])
        logits, state, trace = self._padded_prefill(prompt, want_trace=True)
        n_chunks = -(-P // chunk)
        pad_to = n_chunks * chunk
        top_i = trace["top_i"][:, 0].cpu()                   # [L, S, K]
        if pad_to > top_i.shape[1]:
            top_i = torch.nn.functional.pad(
                top_i, (0, 0, 0, pad_to - top_i.shape[1]))
        return PrefillTicket(prompt_len=P, chunk=chunk, n_chunks=n_chunks,
                             logits=logits, state=state,
                             top_i=top_i[:, :pad_to], prompt=prompt[0])

    def advance_prefill(self, ticket: PrefillTicket,
                        max_chunks: int = 1) -> bool:
        """Warm up to ``max_chunks`` chunks of the ticket, in prompt order.
        Returns True when drained."""
        _, done = self.advance_prefill_state(ticket, None, max_chunks)
        return done

    def advance_prefill_state(self, ticket: PrefillTicket,
                              batch_state: Optional[Params],
                              max_chunks: int = 1
                              ) -> Tuple[Optional[Params], bool]:
        """Scheduler-facing twin of :meth:`advance_prefill` (the batch
        state rides through untouched with dense KV)."""
        chunk, P = ticket.chunk, ticket.prompt_len
        t0 = now_ns()
        n = 0
        while ticket.cursor < ticket.n_chunks and n < max_chunks:
            s = ticket.cursor * chunk
            active = torch.arange(s, s + chunk) < P
            stats = self._warm_chunk(ticket.top_i[:, s:s + chunk], active)
            self._accumulate_prefill(stats, min(chunk, P - s))
            ticket.cursor += 1
            n += 1
        self._counters["prefill_chunks"] += n
        if n:
            self.obs.complete("engine", "warm_replay", t0, now_ns(),
                              {"units": n, "cursor": ticket.cursor,
                               "of": ticket.n_chunks})
        return batch_state, ticket.done

    def prefill_chunked(self, prompt, chunk: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Params]:
        """Prefill forward plus the whole warming replay, synchronously."""
        chunk = self.ecfg.prefill_chunk if chunk is None else int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        ticket = self.start_prefill(prompt, chunk)
        self.advance_prefill(ticket, ticket.n_chunks)
        return ticket.logits, ticket.state

    def sample_first(self, ticket: PrefillTicket,
                     sampling: SamplingParams = GREEDY,
                     seed: Optional[int] = None) -> int:
        """A request's first token from its prefill logits (``seed``: the
        request's first-step seed; required for non-greedy sampling)."""
        seeds = None if seed is None else [seed]
        tok = int(self.select_tokens(ticket.logits[:, 0], [sampling],
                                     seeds)[0])
        self._counters["first_tokens"] += 1
        return tok

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
        state)."""
        t0 = now_ns()
        active_np = np.asarray(active, bool)
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        logits, stats = self._decode_step(tok.to(self.device), state,
                                          active_np)
        n_active = int(active_np.sum())
        self._accumulate(stats, n_active)
        self.obs.complete("engine", "decode_step", t0, now_ns(),
                          {"tokens": n_active})
        return logits, state

    def _accumulate(self, stats: List[Dict[str, int]], n_active: int) -> None:
        c = self._counters
        for layer, s in enumerate(stats):
            for k in ("hits", "accesses", "fetched_experts", "prefetch_hits"):
                c[k] += s[k]
            c["host_assignments"] += s["host_flops_assignments"]
            self._per_layer_hits[layer] += s["hits"]
            self._per_layer_accesses[layer] += s["accesses"]
        c["tokens"] += n_active
        c["steps"] += 1

    def _accumulate_prefill(self, stats: List[Dict[str, int]],
                            n_tokens: int) -> None:
        """Fold one warm chunk's per-layer stats into the prefill channel."""
        c = self._counters
        c["prefill_hits"] += sum(s["hits"] for s in stats)
        c["prefill_accesses"] += sum(s["accesses"] for s in stats)
        c["prefill_fetched"] += sum(s["fetched_experts"] for s in stats)
        c["prefill_tokens"] += n_tokens
