"""Serving entry point, on the GPU (counterpart of the reference's
``launch/serve.py``): the collaborative two-tier MoE engine with continuous
batching for a homogeneous MoE stack (mixtral-8x7b, phi35-moe,
qwen3-moe-30b-a3b), the generic prefill + greedy decode loop for any other
(the dense-FFN attention stacks smollm-360m, mistral-nemo-12b, qwen2-72b
and gemma3-4b with its 5:1 sliding windows, the attention-free Mamba2
stack, the jamba-v0.1-52b hybrid, llama4-maverick-400b-a17b's
interleaved MoE with a shared expert, qwen2-vl-7b's multimodal RoPE and
the seamless-m4t-large-v2 encoder-decoder with its stub audio front end).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --tokens 32 [--ways 2 --indexes 1 --policy lru] \
        [--concurrency 4 --requests 8] [--temperature 0.8 --top-p 0.95] \
        [--kv-paged --page-size 16 --prefill-segment 32] \
        [--prefetch --prefetch-min-prob 0.2] \
        [--host-compute --host-threads 8 --host-fuse-small 4] \
        [--trace-out TRACE.json] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --batch 2 --prompt 40 --tokens 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 2 --prompt 40 --tokens 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --batch 2 --prompt 40 --tokens 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
        --batch 2 --prompt 40 --tokens 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --batch 2 --prompt 40 --tokens 8 \
        [--device cpu]

Same flags and defaults as the reference (reduced config, seeded random
weights; requests, and the generic path's prompt batch, drawn from
``numpy.random.default_rng(--seed)``, since torch cannot reproduce
``jax.random``). ``--prefetch`` (or ``--prefetch-min-prob`` > 0) turns on
cross-layer speculative prefetch, ``--host-compute`` the CPU miss lane
(``--host-threads``, ``--host-fuse-small``). ``--host-backend jax`` (the
reference's in-graph lane) has no PyTorch meaning and is an error.
``--trace-out PATH`` records the engine run with a
:class:`repro_torch.obs.TraceRecorder` and writes it as Chrome trace-event
JSON (check it with ``python -m repro_torch.obs.export PATH
--require-lifecycle``; collaborative path only, as in the reference).
Prints tokens/s and, on the engine, the paper's cache, prefetch and
host-lane counters.

The generic path's decode state holds ``--prompt + --tokens`` KV
positions in every attention layer (``prefill(..., capacity=)``; an
encoder-decoder's self-attention, never its memory K/V); the
reference's keeps the prompt's length, so its decode steps past the
prompt overwrite the last cache slot (a sliding-window layer refuses
that in the port).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config, reduced
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.obs import TraceRecorder, write_chrome_trace
from repro_torch.serving import SamplingParams, build


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1,
                    help="generic (non-MoE) path only: prompts per batch")
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
    ap.add_argument("--prefill-segment", type=int, default=0,
                    help="segment-streamed prefill: forward the prompt in "
                         "segments of this many tokens, one per tick "
                         "with --admit-chunks-per-tick (0 = one-shot)")
    ap.add_argument("--prefix-keep-pages", type=int, default=0,
                    help="paged KV: park up to this many zero-reference "
                         "prefix pages for later prompts")
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
    ap.add_argument("--kv-paged", action="store_true",
                    help="paged KV pool with prefix sharing")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV tokens per page (with --kv-paged)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page pool size (default: dense-equivalent "
                         "slots*capacity/page_size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(request lifecycles, step phases, lane "
                         "counters; collaborative path only)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="print a latency summary every N scheduler ticks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.host_backend == "jax":
        ap.error("--host-backend jax has no PyTorch meaning: the reference's "
                 "in-graph lane is --host-compute off with the dispatch "
                 "counters; the port's host lane is callback")
    if not 0.0 < args.top_p <= 1.0:
        ap.error(f"--top-p must be in (0, 1], got {args.top_p}")
    if args.top_k < 0:
        ap.error(f"--top-k must be >= 0, got {args.top_k}")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    return args


def serve_generic(cfg, args) -> None:
    """The reference's generic path: one ``[batch, prompt]`` batch, prefill,
    then greedy argmax for ``--tokens - 1`` decode steps. The audio family
    also gets ``frames [batch, prompt, frontend_embed_dim]`` bf16, a seeded
    normal draw, as the reference feeds its stub front end."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve --device cuda: no CUDA device available; "
                           "pass --device cpu to run on the CPU")
    print(f"[serve] generic path: {cfg.name} device={args.device}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt))
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (args.batch, args.prompt, cfg.frontend_embed_dim),
            generator=torch.Generator(device=dev).manual_seed(args.seed),
            device=dev).to(torch.bfloat16)
    logits, state = prefill(params, batch, cfg,
                            capacity=args.prompt + args.tokens)
    tok = logits[:, -1].argmax(-1)[:, None]
    outs = [tok]
    t0 = time.time()
    for _ in range(args.tokens - 1):
        logits, state = decode_step(params, state, {"tokens": tok}, cfg)
        tok = logits[:, 0].argmax(-1)[:, None]
        outs.append(tok)
    generated = torch.cat(outs, dim=1).cpu()      # waits for the device
    dt = time.time() - t0
    print(f"  generated {tuple(generated.shape)} in {dt:.2f}s "
          f"({(args.tokens - 1) * args.batch / max(dt, 1e-9):.1f} tok/s "
          f"wall)")


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = reduced(get_config(args.arch))
    if cfg.moe is None or cfg.moe_every != 1 or cfg.is_encdec:
        serve_generic(cfg, args)
        return
    sample_on = args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0
    temp = args.temperature if args.temperature > 0 else 1.0
    n = args.indexes if args.indexes is not None else cfg.num_layers // 2
    R = args.requests or args.concurrency * 2
    prefetch = args.prefetch or args.prefetch_min_prob > 0
    capacity = args.prompt + args.tokens + 1
    if args.kv_paged:
        # paged KV slices the per-request capacity into whole pages
        capacity = -(-capacity // args.page_size) * args.page_size
    print(f"[serve] collaborative engine: {cfg.name} cache=(N={n}, "
          f"M={args.ways}, {args.policy}) slots={args.concurrency} "
          f"requests={R} device={args.device} "
          f"sampling={f'T={temp}' if sample_on else 'greedy'}"
          + (f" prefetch(min_prob={args.prefetch_min_prob})"
             if prefetch else "")
          + (f" host_compute({args.host_backend}, {args.host_threads}t)"
             if args.host_compute else "")
          + (f" overlap_admit({args.admit_chunks_per_tick} chunks/tick)"
             if args.admit_chunks_per_tick else "")
          + (f" segmented_prefill({args.prefill_segment} tok/seg)"
             if args.prefill_segment else "")
          + (f" kv_paged(page_size={args.page_size})"
             if args.kv_paged else ""))
    recorder = TraceRecorder() if args.trace_out else None
    _, sched = build(
        cfg, cache=dict(num_indexes=n, num_ways=args.ways,
                        policy=args.policy),
        serving=dict(max_batch=args.concurrency, capacity=capacity,
                     prefill_chunk=args.prefill_chunk,
                     prefill_segment=args.prefill_segment,
                     admit_chunks_per_tick=args.admit_chunks_per_tick,
                     prefetch=prefetch,
                     prefetch_min_prob=args.prefetch_min_prob,
                     prefetch_rank_votes=args.prefetch_rank_votes,
                     host_compute=args.host_compute,
                     host_threads=args.host_threads,
                     host_backend=args.host_backend,
                     host_fuse_small=args.host_fuse_small,
                     kv_paged=args.kv_paged, page_size=args.page_size,
                     kv_pages=args.kv_pages,
                     prefix_keep_pages=args.prefix_keep_pages),
        seed=args.seed, max_queue=args.max_queue, device=args.device,
        recorder=recorder)
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
    if prefetch:
        print(f"  prefetch: issued={stats.prefetch_issued} "
              f"spec_hits={stats.prefetch_hits} "
              f"wasted={stats.prefetch_wasted} "
              f"pred_acc={stats.prediction_accuracy:.3f}")
    if args.host_compute:
        print(f"  host execution: {stats.cpu_expert_calls} expert "
              f"groups / {stats.cpu_tokens} assignments on CPU "
              f"({stats.fused_groups} fused, offload rate "
              f"{stats.cpu_offload_rate:.3f}, "
              f"backend={args.host_backend})")
    if args.prefill_segment:
        print(f"  segmented prefill: {stats.prefill_segments} segments "
              f"({args.prefill_segment} tok/seg), "
              f"{stats.prefix_tokens_skipped} prefix tokens skipped")
    if args.kv_paged:
        print(f"  paged KV: page_size={args.page_size} "
              f"pages_in_use={stats.kv_pages_in_use} "
              f"prefix_hits={stats.prefix_hits} "
              f"cow_forks={stats.cow_forks} "
              f"prefix_pages_retained={stats.prefix_pages_retained}")
    print(f"  latency: ttft_ms p50={stats.ttft_ms_p50:.1f} "
          f"p99={stats.ttft_ms_p99:.1f}, tpot_ms p50={stats.tpot_ms_p50:.2f} "
          f"p99={stats.tpot_ms_p99:.2f}")
    if args.trace_out:
        write_chrome_trace(recorder, args.trace_out)
        print(f"  trace: {len(recorder)} events ({recorder.dropped} "
              f"dropped) -> {args.trace_out}")


if __name__ == "__main__":
    main()
