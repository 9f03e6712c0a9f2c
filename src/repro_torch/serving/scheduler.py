"""Continuous-batching request scheduler over the collaborative engine
(counterpart of the reference's ``serving/scheduler.py``).

T = ``EngineConfig.max_batch`` concurrent slots share ONE expert cache:

  * admission    — a queued request claims a free slot: the prefill
                   forward runs once (first token sampled at once, KV
                   copied into the slot's rows or pages), then the slot
                   sits in the PREFILLING phase while its cache-warming
                   replay drains (all at once, or ``admit_chunks_per_tick``
                   chunks per tick between decode steps). Under
                   ``prefill_segment`` no forward runs on the admission
                   tick: each tick streams (at most
                   ``admit_chunks_per_tick``) prompt segments, and the
                   first token is sampled on the tick whose segment ends
                   the prompt. Under ``kv_paged`` a request whose pages the
                   pool cannot commit holds the FIFO head until
                   retirements free pages.
  * decode tick  — one padded decode step over the warmed slots, each at
                   its own KV position; next tokens come from the engine's
                   per-slot sampler, each row under its own request's
                   SamplingParams and seed chain.
  * retirement   — on ``max_new_tokens``, ``eos_id`` or a stop sequence;
                   the slot frees and the next request is admitted on the
                   same tick.
  * cancellation — :meth:`cancel` retires a queued or in-flight request
                   with a terminal ``(rid, -1, done=True)`` event.
  * backpressure — ``max_queue`` bounds the waiting line;
                   :meth:`pause_admission` / :meth:`resume_admission` hold
                   and reopen admissions (in-flight slots keep decoding).
  * fork         — :meth:`fork` clones a live request into a free slot
                   sharing all its KV pages (paged KV).

Tracing: with a recorder every tick emits ``tick`` (and ``admission`` /
``decode+drain``) on the ``sched`` track, and every retired or cancelled
request its ``queued`` / ``prefill`` / ``decode`` spans and ``done`` or
``cancelled`` instant on ``req:N`` and its ``occupied`` span on
``slot:N``, all from the ``_obs_*`` drain helpers, as the reference does.

Seeds: the scheduler's own CPU ``torch.Generator`` (seeded by ``seed``)
draws the base seed of every request whose SamplingParams carries none; a
request's i-th token draws with ``step_seed(base, i)``. With
``REPRO_DEBUG_INVARIANTS=1`` every tick ends with the page pool's
invariant audit.
"""
from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import LogHistogram
from repro_torch.obs.trace import now_ns

from .engine import CollaborativeEngine, PrefillTicket, _one_prompt
from .sampling import GREEDY, SamplingParams, step_seed
from .stats import RunStats

__all__ = ["Request", "ContinuousBatchingScheduler", "StreamEvent",
           "QueueFull"]

StreamEvent = Tuple[int, int, bool]          # (rid, token, done)


class QueueFull(RuntimeError):
    """``submit(..., block=False)`` on a queue at ``max_queue``."""


@dataclass(eq=False)
class Request:
    """One generation request (identity semantics: ``rid`` is the key)."""
    rid: int
    prompt: np.ndarray                  # [P] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    sampling: SamplingParams = GREEDY
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    on_token: Optional[Callable[[int, bool], None]] = None
    generated: List[int] = field(default_factory=list)
    cancelled: bool = False
    # lifecycle stamps (perf_counter_ns; 0 = phase not reached) written as
    # the request moves submit -> admit -> first token -> done: plain
    # clock reads, emitted as spans at the _obs_retire drain point
    t_submit: int = 0
    t_admit: int = 0
    t_first: int = 0
    t_last: int = 0
    t_done: int = 0
    slot: int = -1

    @property
    def done(self) -> bool:
        if self.cancelled:
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        if not self.generated:
            return False
        if self.eos_id is not None and self.generated[-1] == self.eos_id:
            return True
        for seq in self.stop_sequences:
            n = len(seq)
            if n and len(self.generated) >= n \
                    and tuple(self.generated[-n:]) == tuple(seq):
                return True
        return False

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.generated, np.int32)


class ContinuousBatchingScheduler:
    """Slot-based continuous batching for :class:`CollaborativeEngine`."""

    def __init__(self, engine: CollaborativeEngine, seed: int = 0,
                 max_queue: Optional[int] = None, recorder=None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.engine = engine
        # trace recorder (repro_torch.obs.TraceRecorder, or the no-op twin
        # when tracing is off); a recorder passed here also becomes the
        # engine's, so one argument wires the whole stack. Emission happens
        # only in the _obs_* drain helpers
        self.obs = recorder if recorder is not None else engine.obs
        if recorder is not None:
            engine.obs = recorder
        self._h_ttft = LogHistogram()
        self._h_tpot = LogHistogram()
        self._h_stall = LogHistogram()
        self.num_slots = engine.ecfg.max_batch
        self.max_queue = max_queue
        self.state = engine.init_slots()
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self._tickets: List[Optional[PrefillTicket]] = [None] * self.num_slots
        self.queue: Deque[Request] = deque()
        self._next = np.zeros((self.num_slots, 1), np.int64)
        self._rid = 0
        self._gen = torch.Generator().manual_seed(seed)
        self._bases = [0] * self.num_slots
        self.finished: List[Request] = []
        self._submitted = 0
        self._paused = False
        self._admission_stalls = 0
        self._queue_rejected = 0
        self._pending_events: List[StreamEvent] = []
        self._pending_done: List[Request] = []
        # audit the page pool's refcounts, free list and prefix index after
        # every tick (tests set it; the audit walks the whole pool)
        self._debug_invariants = \
            os.environ.get("REPRO_DEBUG_INVARIANTS") == "1"

    def _split(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               stop_sequences: Sequence[Sequence[int]] = (),
               on_token: Optional[Callable[[int, bool], None]] = None,
               block: bool = True) -> Request:
        """Queue one request, validated against the engine geometry here.
        With ``max_queue`` at capacity, ``block=True`` drives ticks until
        space frees and ``block=False`` raises :class:`QueueFull`; with
        admission paused a full queue raises in both modes."""
        prompt = _one_prompt(prompt)[0]
        plen, cap = prompt.shape[0], self.engine.ecfg.capacity
        if plen < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if plen + max_new_tokens > cap:
            raise ValueError(
                f"prompt length {plen} + max_new_tokens {max_new_tokens} "
                f"exceeds engine KV capacity {cap}; shorten the prompt or "
                f"raise EngineConfig.capacity")
        while self.max_queue is not None \
                and len(self.queue) >= self.max_queue:
            if not block or self._paused:
                self._queue_rejected += 1
                raise QueueFull(
                    f"scheduler queue is at max_queue={self.max_queue}"
                    + (" and admission is paused" if self._paused else
                       "; retry later or submit(block=True)"))
            finished, events = self._tick()
            self._pending_events.extend(events)
            self._pending_done.extend(finished)
        req = Request(self._rid, prompt, int(max_new_tokens), eos_id,
                      sampling if sampling is not None else GREEDY,
                      tuple(tuple(int(t) for t in s)
                            for s in stop_sequences),
                      on_token, t_submit=now_ns())
        self._rid += 1
        self._submitted += 1
        self.queue.append(req)
        return req

    def pause_admission(self) -> None:
        """Hold new admissions: queued requests wait while in-flight slots
        decode and PREFILLING slots keep warming; ``stream()``/``run()``
        drain only the in-flight work."""
        self._paused = True

    def resume_admission(self) -> None:
        """Reopen admission from the next tick."""
        self._paused = False

    @property
    def admission_paused(self) -> bool:
        return self._paused

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request; its slot frees at once.
        Returns True if the request was found live."""
        req = None
        for r in self.queue:
            if r.rid == rid:
                req = r
                self.queue.remove(r)
                break
        if req is None:
            for t, r in enumerate(self.slots):
                if r is not None and r.rid == rid:
                    if r.done:
                        return False
                    req = r
                    self.slots[t] = None
                    self._tickets[t] = None
                    self.engine.release_slot(t)
                    break
        if req is None:
            return False
        req.cancelled = True
        req.t_done = now_ns()
        self.finished.append(req)
        self._pending_done.append(req)
        self._pending_events.append((req.rid, -1, True))
        if req.on_token is not None:
            req.on_token(-1, True)
        self._obs_retire([req])
        return True

    def fork(self, rid: int, max_new_tokens: Optional[int] = None,
             sampling: Optional[SamplingParams] = None) -> Request:
        """Fork a live, warmed request into a free slot (paged KV only).

        The child shares ALL the parent's KV pages (nothing is copied now;
        the partial last page is copied on write when either side next
        appends) and continues from the parent's pending next token under
        its own sampling seed chain (``sampling``; the parent's by
        default) and budget (``max_new_tokens``; the parent's by default).
        Raises :class:`~repro_torch.serving.kv_pool.PoolExhausted` when the
        pool cannot commit the child's decode pages."""
        if not self.engine.ecfg.kv_paged:
            raise RuntimeError("fork requires EngineConfig.kv_paged")
        src = next((t for t, r in enumerate(self.slots)
                    if r is not None and r.rid == rid), None)
        if src is None or self.slots[src].done:
            raise ValueError(f"request {rid} is not in a live slot")
        if self._tickets[src] is not None:
            raise ValueError(
                f"request {rid} is still PREFILLING; fork after warmup")
        dst = next((t for t in range(self.num_slots)
                    if self.slots[t] is None), None)
        if dst is None:
            raise RuntimeError("no free slot to fork into")
        parent = self.slots[src]
        new_max = parent.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        plen, cap = parent.prompt.shape[0], self.engine.ecfg.capacity
        if new_max <= len(parent.generated):
            raise ValueError(
                f"max_new_tokens {new_max} <= tokens already generated "
                f"({len(parent.generated)}): the child would be born done")
        if plen + new_max > cap:
            raise ValueError(
                f"prompt length {plen} + max_new_tokens {new_max} exceeds "
                f"engine KV capacity {cap}")
        child = Request(self._rid, parent.prompt, new_max, parent.eos_id,
                        sampling if sampling is not None else parent.sampling,
                        parent.stop_sequences,
                        generated=list(parent.generated))
        child.t_submit = child.t_admit = child.t_first = child.t_last \
            = now_ns()
        child.slot = dst
        self._rid += 1
        self._submitted += 1
        self.state = self.engine.fork_slot(self.state, src, dst,
                                           plen + new_max)
        self._next[dst, 0] = self._next[src, 0]
        sp = child.sampling
        self._bases[dst] = sp.seed if sp.seed is not None else self._split()
        self.slots[dst] = child
        self._tickets[dst] = None
        return child

    # -- slot bookkeeping --------------------------------------------------
    @property
    def active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], bool)

    @property
    def decode_mask(self) -> np.ndarray:
        return np.array([s is not None and tk is None
                         for s, tk in zip(self.slots, self._tickets)], bool)

    @property
    def num_active(self) -> int:
        return int(self.active_mask.sum())

    @property
    def prefill_pending(self) -> int:
        return sum(tk is not None for tk in self._tickets)

    def _retire(self) -> List[Request]:
        out = []
        for t, req in enumerate(self.slots):
            if req is not None and req.done:
                self.slots[t] = None
                self._tickets[t] = None
                self.engine.release_slot(t)
                out.append(req)
        self.finished.extend(out)
        if out:
            self._obs_retire(out)
        return out

    def _append(self, req: Request, tok: int,
                events: List[StreamEvent]) -> None:
        t = now_ns()
        req.generated.append(tok)
        if req.t_first == 0:
            req.t_first = t
            self._h_ttft.observe((t - req.t_submit) / 1e6)
        else:
            self._h_tpot.observe((t - req.t_last) / 1e6)
        req.t_last = t
        done = req.done
        if done:
            req.t_done = t
        events.append((req.rid, tok, done))
        if req.on_token is not None:
            req.on_token(tok, done)

    def _admit(self, events: List[StreamEvent]) -> int:
        if self._paused:
            return 0
        admitted = 0
        for t in range(self.num_slots):
            if self.slots[t] is None and self.queue:
                req = self.queue[0]
                if not self.engine.can_admit(req.prompt,
                                             req.max_new_tokens):
                    # paged KV backpressure: the FIFO head cannot commit
                    # its pages yet; skipping ahead would starve it
                    break
                self.queue.popleft()
                req.t_admit = now_ns()
                req.slot = t
                admitted += 1
                sp = req.sampling
                base = sp.seed if sp.seed is not None else self._split()
                self._bases[t] = base
                ticket = self.engine.start_prefill(
                    req.prompt,
                    max_total_tokens=req.prompt.shape[0] + req.max_new_tokens)
                if ticket.logits is None:
                    # segment stream: no forward ran; the slot goes
                    # straight into PREFILLING, its pages claimed so a
                    # cancel mid-stream releases them
                    self.engine.claim_slot(ticket, t)
                    self.slots[t] = req
                    self._tickets[t] = ticket
                    continue
                try:
                    first_tok = self.engine.sample_first(
                        ticket, sp, seed=step_seed(base, 0))
                    self.state = self.engine.bind_slot(self.state, ticket, t)
                except BaseException:
                    self.engine.abort_ticket(ticket)
                    raise
                self._next[t, 0] = first_tok
                self.slots[t] = req
                self._tickets[t] = None if ticket.done else ticket
                self._append(req, first_tok, events)
        return admitted

    def _advance_prefills(self, events: List[StreamEvent]) -> None:
        """Drive every PREFILLING slot's warming replay or segment stream:
        all of it when ``admit_chunks_per_tick == 0``, at most that many
        chunks otherwise. A drained ticket's slot decodes on this tick; a
        drained segment stream first owes its request the first token,
        sampled, bound and streamed here."""
        per_tick = self.engine.ecfg.admit_chunks_per_tick
        for t, ticket in enumerate(self._tickets):
            if ticket is None or self.slots[t] is None:
                continue
            budget = ticket.remaining if per_tick == 0 \
                else min(per_tick, ticket.remaining)
            self.state, done = self.engine.advance_prefill_state(
                ticket, self.state, budget)
            if done:
                self._tickets[t] = None
                if ticket.seg > 0:
                    req = self.slots[t]
                    first_tok = self.engine.sample_first(
                        ticket, req.sampling,
                        seed=step_seed(self._bases[t], 0))
                    self.state = self.engine.bind_slot(self.state, ticket, t)
                    self._next[t, 0] = first_tok
                    self._append(req, first_tok, events)

    # -- the decode loop ---------------------------------------------------
    def _tick(self) -> Tuple[List[Request], List[StreamEvent]]:
        """retire -> admit -> advance warming -> one padded decode step."""
        events: List[StreamEvent] = []
        finished: List[Request] = []
        t0 = now_ns()
        if self._pending_events or self._pending_done:
            events.extend(self._pending_events)
            self._pending_events.clear()
            finished.extend(self._pending_done)
            self._pending_done.clear()
        finished += self._retire()
        t_adm0 = now_ns()
        warming = self.prefill_pending
        admitted = self._admit(events)
        finished += self._retire()
        if self.queue:
            self._admission_stalls += 1
        self._advance_prefills(events)
        # a deferred first token may have finished a one-token request:
        # retire it before the decode step
        finished += self._retire()
        t_adm1 = now_ns()
        if admitted or warming:
            self._h_stall.observe((t_adm1 - t_adm0) / 1e6)
        decoded = 0
        active = self.decode_mask
        if active.any():
            decoded = int(active.sum())
            logits, self.state = self.engine.decode_batch(
                self._next, self.state, active)
            params = [r.sampling if r is not None and tk is None else GREEDY
                      for r, tk in zip(self.slots, self._tickets)]
            seeds = None
            if not all(p.greedy for p in params):
                seeds = [step_seed(self._bases[t], len(r.generated))
                         if r is not None else 0
                         for t, r in enumerate(self.slots)]
            # the tick's one sync point: the tokens reach the host
            toks = self.engine.select_tokens(logits[:, 0], params,
                                             seeds).numpy()
            for t, req in enumerate(self.slots):
                if req is None or not active[t]:
                    continue
                self._append(req, int(toks[t]), events)
                self._next[t, 0] = toks[t]
        self._obs_tick(t0, t_adm0, t_adm1, admitted, warming, decoded)
        if self._debug_invariants and self.engine.kv_pool is not None:
            self.engine.kv_pool.check_invariants()
        return finished, events

    # -- trace drain helpers (the ONLY emission sites) ---------------------
    def _obs_tick(self, t0: int, t_adm0: int, t_adm1: int, admitted: int,
                  warming: int, decoded: int) -> None:
        """Drain point: the tick's phase spans, emitted after the tick's
        token drain from the clock readings the tick collected."""
        t1 = now_ns()
        self.obs.complete("sched", "tick", t0, t1,
                          {"admitted": admitted, "warming": warming,
                           "decoded": decoded,
                           "queued": len(self.queue)})
        if admitted or warming:
            self.obs.complete("sched", "admission", t_adm0, t_adm1)
        if decoded:
            self.obs.complete("sched", "decode+drain", t_adm1, t1)

    def _obs_retire(self, reqs: Sequence[Request]) -> None:
        """Drain point: each retired (or cancelled) request's lifecycle
        spans, emitted retroactively from its timing stamps — the queued /
        prefill / decode phases, the terminal instant, and the
        slot-occupancy span on the slot's own track."""
        for req in reqs:
            track = f"req:{req.rid}"
            end = req.t_done if req.t_done else now_ns()
            if req.t_admit:
                self.obs.complete(track, "queued", req.t_submit,
                                  req.t_admit)
                first = req.t_first if req.t_first else end
                self.obs.complete(
                    track, "prefill", req.t_admit, first,
                    {"prompt_tokens": int(req.prompt.shape[0])})
                if req.t_first:
                    self.obs.complete(
                        track, "decode", req.t_first, end,
                        {"tokens": len(req.generated),
                         "ttft_ms": (req.t_first - req.t_submit) / 1e6})
            else:
                # cancelled while still queued: its whole life was the
                # queue, with no prefill or decode phase to cover
                self.obs.complete(track, "queued", req.t_submit, end)
            self.obs.instant(
                track, "cancelled" if req.cancelled else "done",
                {"generated": len(req.generated)}, ts_ns=end)
            if req.slot >= 0 and req.t_admit:
                self.obs.complete(f"slot:{req.slot}", "occupied",
                                  req.t_admit, end, {"rid": req.rid})

    def step(self) -> List[Request]:
        """One tick; returns the requests that finished on it."""
        finished, _ = self._tick()
        return finished

    def stream(self) -> Iterator[StreamEvent]:
        """Drain queue + slots, yielding ``(rid, token, done)`` as each
        token is decoded. While admission is paused only the in-flight work
        drains."""
        while (self.queue and not self._paused) or self._pending_events \
                or any(s is not None for s in self.slots):
            _, events = self._tick()
            for ev in events:
                yield ev
        self._retire()

    def run(self) -> Dict[int, np.ndarray]:
        """Drain queue + slots to completion; returns {rid: output}."""
        for _ in self.stream():
            pass
        return {r.rid: r.output for r in self.finished}

    @property
    def stats(self) -> RunStats:
        ttft, tpot, stall = self._h_ttft, self._h_tpot, self._h_stall
        return RunStats(engine=self.engine.stats,
                        requests_submitted=self._submitted,
                        requests_finished=len(self.finished),
                        requests_active=self.num_active,
                        requests_queued=len(self.queue),
                        prefill_pending=self.prefill_pending,
                        admission_stalls=self._admission_stalls,
                        queue_rejected=self._queue_rejected,
                        ttft_ms_p50=ttft.percentile(50.0),
                        ttft_ms_p95=ttft.percentile(95.0),
                        ttft_ms_p99=ttft.percentile(99.0),
                        tpot_ms_p50=tpot.percentile(50.0),
                        tpot_ms_p95=tpot.percentile(95.0),
                        tpot_ms_p99=tpot.percentile(99.0),
                        stall_ms_p50=stall.percentile(50.0),
                        stall_ms_p95=stall.percentile(95.0),
                        stall_ms_p99=stall.percentile(99.0))
