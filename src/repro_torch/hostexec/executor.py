"""Multithreaded host-side expert FFN executor (the port's counterpart of
the reference's ``hostexec/executor.py``).

The paper's CPU lane: cache-miss experts' SwiGLU FFNs run here, on a
thread pool over the pinned bf16 host tier, while the card keeps the hit
experts. Only the activation rows of the ``[G, A, D]`` dispatch buffer
cross the boundary (device->host into pinned memory and back, the paper's
0.11 ms round trip); weights never move. Group tasks write disjoint rows
of the output, and torch's CPU matmuls release the GIL, so the workers
run in parallel.

The math is float32, cast back to the activation dtype, as in the
reference. Unlike the reference, which converts the whole table to
float32 once, the table is read in place: each group's weights are upcast
``chunk`` columns of d_ff at a time (the FFN over a column block of d_ff
is that block's share of the output), so a worker's temporaries stay at
three ``[D, chunk]`` float32 blocks per group.
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import torch

__all__ = ["HostExpertExecutor", "host_expert_ffn"]

# d_ff columns upcast at a time: a worker's temporaries are three
# [D, 512] fp32 blocks, 8 MB each at Mixtral's D = 4096
CHUNK = 512


def host_expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert FFN, float32: x [..., C, D] with w1/w3 [..., D, F]
    and w2 [..., F, D] -> [..., C, D]."""
    h1 = x @ w1
    h = (h1 / (1.0 + torch.exp(-h1))) * (x @ w3)    # silu(x@w1) * (x@w3)
    return h @ w2


def _upcast(table: torch.Tensor, layer: int, experts: Sequence[int],
            index) -> torch.Tensor:
    """float32 ``table[layer, e][index]`` stacked over ``experts``."""
    blocks = [table[layer, e][index] for e in experts]
    out = torch.empty((len(blocks),) + tuple(blocks[0].shape),
                      dtype=torch.float32)
    for o, b in zip(out, blocks):
        o.copy_(b)
    return out


class HostExpertExecutor:
    """Thread-pool expert FFN over the host expert table.

    w1/w3: [L, E, D, F]; w2: [L, E, F, D], any float dtype (the pinned
    bf16 tier on a GPU), read in place. ``threads`` sizes the pool; 1 runs
    inline. ``fuse_small`` batches the step's small miss groups (valid
    token count <= fuse_small) into ONE stacked matmul per FFN stage
    instead of one pool task each (0 disables fusion). Worker fan-out
    follows the step's miss-group census (:meth:`_effective_threads`),
    groups are bucketed one bucket per effective worker, and a repeat
    expert is pinned to the bucket that ran it last. All of it is schedule
    only: every group computes the same rows into disjoint output rows.
    """

    def __init__(self, w1, w3, w2, threads: int = 8, fuse_small: int = 0,
                 chunk: int = CHUNK):
        self.w1, self.w3, self.w2 = w1, w3, w2
        self.threads = max(1, int(threads))
        self.fuse_small = max(0, int(fuse_small))
        self.chunk = max(1, int(chunk))
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=self.threads,
                               thread_name_prefix="hostexec")
            if self.threads > 1 else None)
        self._affinity: dict = {}       # expert -> bucket it last ran on
        self._lock = threading.Lock()   # guards busy_ns across workers
        # telemetry: dispatches, groups run, groups the fusion lane ran;
        # censused dispatches, their summed effective workers, groups that
        # landed on their pinned bucket; summed per-worker ns inside expert
        # FFN compute and the most bucket tasks one dispatch submitted
        self.calls = 0
        self.groups = 0
        self.fused = 0
        self.census_calls = 0
        self.census_threads = 0
        self.affinity_hits = 0
        self.busy_ns = 0
        self.queue_peak = 0

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()

    def _effective_threads(self, census: int) -> int:
        """Workers for this step's miss-group census: linear to 8, then
        sublinear (sqrt growth past the bandwidth knee), capped by the pool
        size."""
        if census <= 0:
            return 1
        eff = census if census <= 8 else 8 + math.isqrt(census - 8)
        return max(1, min(self.threads, eff))

    def _ffn(self, layer: int, experts: List[int],
             x: torch.Tensor) -> torch.Tensor:
        """FFN of the groups stacked on x [g, C, D] (float32) with
        ``experts`` [g], the weights upcast one d_ff chunk at a time."""
        out = torch.zeros(x.shape, dtype=torch.float32)
        F = self.w1.shape[-1]
        for f0 in range(0, F, self.chunk):
            cols = slice(f0, min(F, f0 + self.chunk))
            out += host_expert_ffn(
                x, _upcast(self.w1, layer, experts, (slice(None), cols)),
                _upcast(self.w3, layer, experts, (slice(None), cols)),
                _upcast(self.w2, layer, experts, (cols,)))
        return out

    def _add_busy(self, t0: int) -> None:
        with self._lock:
            self.busy_ns += time.perf_counter_ns() - t0

    def compute_groups(self, layer, rep_e, run, xbuf: torch.Tensor,
                       counts=None) -> torch.Tensor:
        """One step's host lane: the FFNs of the groups ``run`` marks.

        rep_e [G] expert per group; run [G] bool; xbuf [G, A, D] host
        activations (rows past a group's count are zero); counts [G] valid
        rows per group (optional: enables the fusion lane and computes only
        the valid rows). Returns [G, A, D] in xbuf's dtype, zeros for the
        groups ``run`` skips."""
        layer = int(layer)
        rep_e = torch.as_tensor(rep_e).tolist()
        todo = torch.nonzero(torch.as_tensor(run)).reshape(-1).tolist()
        A = xbuf.shape[1]
        n = ([A] * len(rep_e) if counts is None
             else [int(c) for c in torch.as_tensor(counts).tolist()])
        out = torch.zeros(xbuf.shape, dtype=torch.float32)
        if todo:
            x32 = xbuf.float()
            small = [g for g in todo if counts is not None
                     and 0 < self.fuse_small and n[g] <= self.fuse_small]
            big = [g for g in todo if g not in small]
            if small:
                t0 = time.perf_counter_ns()
                r = max(n[g] for g in small)
                idx = torch.tensor(small)
                out[idx, :r] = self._ffn(layer, [rep_e[g] for g in small],
                                         x32[idx, :r])
                self.fused += len(small)
                self._add_busy(t0)

            def one(g: int) -> None:
                out[g, :n[g]] = self._ffn(layer, [rep_e[g]],
                                          x32[g:g + 1, :n[g]])[0]

            def run_bucket(groups) -> None:
                t0 = time.perf_counter_ns()
                for g in groups:
                    one(g)
                self._add_busy(t0)

            if self._pool is not None and len(big) > 1:
                eff = self._effective_threads(len(big))
                self.census_calls += 1
                self.census_threads += eff
                buckets: list = [[] for _ in range(eff)]
                for g in big:
                    e = rep_e[g]
                    b = self._affinity.get(e, -1)
                    if 0 <= b < eff:
                        self.affinity_hits += 1
                    else:
                        b = min(range(eff), key=lambda i: len(buckets[i]))
                        self._affinity[e] = b
                    buckets[b].append(g)
                if eff > 1:
                    live = [bk for bk in buckets if bk]
                    self.queue_peak = max(self.queue_peak, len(live))
                    list(self._pool.map(run_bucket, live))
                else:
                    run_bucket(buckets[0])
            else:
                run_bucket(big)
        self.calls += 1
        self.groups += len(todo)
        return out.to(xbuf.dtype)
