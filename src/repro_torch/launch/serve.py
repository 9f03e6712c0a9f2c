"""Serving entry point: the collaborative two-tier MoE engine with continuous
batching, on the GPU (counterpart of the reference's ``launch/serve.py``,
collaborative path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --tokens 32 [--ways 2 --indexes 1 --policy lru] \
        [--concurrency 4 --requests 8] [--temperature 0.8 --top-p 0.95] \
        [--device cpu]

Same flags and defaults as the reference (reduced config, seeded random
weights, requests drawn from ``numpy.random.default_rng(--seed)``). Flags
of options the port does not run yet are accepted and raise when set.
Prints tokens/s and the paper's cache counters.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.serving import SamplingParams, build

# flags of unported options: (argparse dest, value that means "off")
UNPORTED_FLAGS = {
    "prefill_segment": 0, "prefix_keep_pages": 0, "prefetch": False,
    "prefetch_min_prob": 0.0, "host_compute": False, "host_threads": 8,
    "host_fuse_small": 4, "prefetch_rank_votes": True,
    "host_backend": "callback", "kv_paged": False, "page_size": 16,
    "kv_pages": None, "trace_out": None, "batch": 1,
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1,
                    help="generic (non-MoE) path only; not ported")
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--indexes", type=int, default=None)
    ap.add_argument("--ways", type=int, default=2)
    ap.add_argument("--policy", default="lru",
                    choices=["lru", "fifo", "random"])
    ap.add_argument("--concurrency", type=int, default=4,
                    help="scheduler slots (padded decode batch T)")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to serve (default: concurrency*2)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="cache-warming chunked-prefill chunk "
                         "(0 = bypass prefill, cold cache)")
    ap.add_argument("--prefill-segment", type=int, default=0)
    ap.add_argument("--prefix-keep-pages", type=int, default=0)
    ap.add_argument("--admit-chunks-per-tick", type=int, default=0,
                    help="overlapped admission: warm a newly admitted "
                         "request by at most this many chunks per tick "
                         "(0 = synchronous admission)")
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--prefetch", action="store_true")
    ap.add_argument("--prefetch-min-prob", type=float, default=0.0)
    ap.add_argument("--host-compute", action="store_true")
    ap.add_argument("--host-threads", type=int, default=8)
    ap.add_argument("--host-fuse-small", type=int, default=4)
    ap.add_argument("--no-prefetch-rank-votes", action="store_false",
                    dest="prefetch_rank_votes")
    ap.add_argument("--host-backend", default="callback",
                    choices=["callback", "jax"])
    ap.add_argument("--kv-paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-pages", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="print a latency summary every N scheduler ticks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for dest, off in UNPORTED_FLAGS.items():
        if getattr(args, dest) != off:
            ap.error(f"--{dest.replace('_', '-')} is not ported to "
                     f"repro_torch yet")
    if not 0.0 < args.top_p <= 1.0:
        ap.error(f"--top-p must be in (0, 1], got {args.top_p}")
    if args.top_k < 0:
        ap.error(f"--top-k must be >= 0, got {args.top_k}")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = reduced(get_config(args.arch))
    sample_on = args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0
    temp = args.temperature if args.temperature > 0 else 1.0
    n = args.indexes if args.indexes is not None else cfg.num_layers // 2
    R = args.requests or args.concurrency * 2
    capacity = args.prompt + args.tokens + 1
    print(f"[serve] collaborative engine: {cfg.name} cache=(N={n}, "
          f"M={args.ways}, {args.policy}) slots={args.concurrency} "
          f"requests={R} device={args.device} "
          f"sampling={f'T={temp}' if sample_on else 'greedy'}"
          + (f" overlap_admit({args.admit_chunks_per_tick} chunks/tick)"
             if args.admit_chunks_per_tick else ""))
    _, sched = build(
        cfg, cache=dict(num_indexes=n, num_ways=args.ways,
                        policy=args.policy),
        serving=dict(max_batch=args.concurrency, capacity=capacity,
                     prefill_chunk=args.prefill_chunk,
                     admit_chunks_per_tick=args.admit_chunks_per_tick),
        seed=args.seed, max_queue=args.max_queue, device=args.device)
    rng = np.random.default_rng(args.seed)
    for r in range(R):
        plen = int(rng.integers(max(args.prompt // 2, 1), args.prompt + 1))
        sp = SamplingParams(greedy=False, temperature=temp,
                            top_k=args.top_k, top_p=args.top_p,
                            seed=args.seed + r) if sample_on \
            else SamplingParams()
        sched.submit(rng.integers(0, cfg.vocab_size, plen),
                     max_new_tokens=args.tokens, sampling=sp)
    t0 = time.time()
    done, tick = 0, 0
    while done < R:
        done += len(sched.step())
        tick += 1
        if args.metrics_every > 0 and tick % args.metrics_every == 0:
            s = sched.stats
            print(f"  [metrics] tick={tick} finished={s.requests_finished} "
                  f"active={s.requests_active} queued={s.requests_queued} | "
                  f"ttft_ms {s.ttft_ms_p50:.1f}/{s.ttft_ms_p99:.1f} "
                  f"tpot_ms {s.tpot_ms_p50:.2f}/{s.tpot_ms_p99:.2f} "
                  f"(p50/p99)")
    if args.device != "cpu":
        torch.cuda.synchronize()
    dt = time.time() - t0
    stats = sched.stats
    total = sum(len(r.generated) for r in sched.finished)
    if total != stats.generated_tokens:
        raise RuntimeError(f"token count mismatch: {total} streamed vs "
                           f"{stats.generated_tokens} counted")
    print(f"  served {stats.requests_finished} requests / {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s wall, {stats.steps} decode "
          f"steps, {stats.admission_stalls} admission stalls)")
    print(f"  cache hit rate: {stats.hit_rate:.3f} (hits={stats.hits} "
          f"accesses={stats.accesses} fetches={stats.fetched_experts})")
    if stats.prefill_accesses:
        print(f"  prefill warming: {stats.prefill_tokens} tokens / "
              f"{stats.prefill_chunks} chunks, hit rate "
              f"{stats.prefill_hit_rate:.3f} ({stats.prefill_fetched} "
              f"fetches)")
    print(f"  latency: ttft_ms p50={stats.ttft_ms_p50:.1f} "
          f"p99={stats.ttft_ms_p99:.1f}, tpot_ms p50={stats.tpot_ms_p50:.2f} "
          f"p99={stats.tpot_ms_p99:.2f}")


if __name__ == "__main__":
    main()
