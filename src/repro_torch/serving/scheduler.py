"""Continuous-batching request scheduler over the collaborative engine
(counterpart of the reference's ``serving/scheduler.py``).

T = ``EngineConfig.max_batch`` concurrent slots share ONE expert cache:

  * admission    — a queued request claims a free slot: the prefill
                   forward runs once (first token sampled at once, KV
                   copied into the slot's rows), then the slot sits in the
                   PREFILLING phase while its cache-warming replay drains
                   (all at once, or ``admit_chunks_per_tick`` chunks per
                   tick between decode steps).
  * decode tick  — one padded decode step over the warmed slots, each at
                   its own KV position; next tokens come from the engine's
                   per-slot sampler, each row under its own request's
                   SamplingParams and seed chain.
  * retirement   — on ``max_new_tokens``, ``eos_id`` or a stop sequence;
                   the slot frees and the next request is admitted on the
                   same tick.
  * cancellation — :meth:`cancel` retires a queued or in-flight request
                   with a terminal ``(rid, -1, done=True)`` event.
  * backpressure — ``max_queue`` bounds the waiting line.

Seeds: the scheduler's own CPU ``torch.Generator`` (seeded by ``seed``)
draws the base seed of every request whose SamplingParams carries none; a
request's i-th token draws with ``step_seed(base, i)``. Not ported yet:
``fork`` and pausing admission.
"""
from __future__ import annotations

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
        self._admission_stalls = 0
        self._queue_rejected = 0
        self._pending_events: List[StreamEvent] = []
        self._pending_done: List[Request] = []

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
        space frees and ``block=False`` raises :class:`QueueFull`."""
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
            if not block:
                self._queue_rejected += 1
                raise QueueFull(
                    f"scheduler queue is at max_queue={self.max_queue}; "
                    f"retry later or submit(block=True)")
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
        return True

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
        admitted = 0
        for t in range(self.num_slots):
            if self.slots[t] is None and self.queue:
                req = self.queue[0]
                if not self.engine.can_admit(req.prompt,
                                             req.max_new_tokens):
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

    def _advance_prefills(self) -> None:
        """Drive every PREFILLING slot's warming replay: all of it when
        ``admit_chunks_per_tick == 0``, at most that many chunks
        otherwise. A drained ticket's slot decodes on this tick."""
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
        self._advance_prefills()
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
        self.obs.complete("sched", "tick", t0, now_ns(),
                          {"admitted": admitted, "warming": warming,
                           "decoded": decoded, "queued": len(self.queue)})
        return finished, events

    def step(self) -> List[Request]:
        """One tick; returns the requests that finished on it."""
        finished, _ = self._tick()
        return finished

    def stream(self) -> Iterator[StreamEvent]:
        """Drain queue + slots, yielding ``(rid, token, done)`` as each
        token is decoded."""
        while self.queue or self._pending_events \
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
