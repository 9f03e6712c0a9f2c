#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py                # from the root of a checkout; one GPU

Phases, in order; any failure exits non-zero:
  1. the card (``nvidia-smi`` name and power limit) and the versions;
  2. build every kernel source from ``src/repro_torch/**/csrc`` (one
     ``nvcc`` per source, all started together) into ``build/``;
  3. each kernel of ``repro_torch.kernels.ALL`` against its plain PyTorch
     version at the shapes of its ``cases`` (the served shape, a long
     context at Mixtral's max_seq_len of 32768 for the attention kernels
     and of 65536 tokens for the SSD scan, ragged shapes), with the
     tolerance printed, and against a second launch on the same inputs
     (bitwise); at the served, long and other models' shapes
     (``model:<arch>``) the times of the
     kernel (events around the wrapper call, and the profiler's device
     time alone), the plain version and the library yardstick (if any;
     its wall and device time likewise), beside the bound its inputs give;
  4. serve 6 greedy requests through ``repro_torch.build`` at
     Mixtral-8x7B's published widths (d_model 4096, 32/8 heads of 128,
     8 experts top-2 of d_ff 14336, vocab 32000), dense KV. The one cut: 4
     layers of 32, so the pinned host tier holds 32 experts (11.3 GB).
     Cache N = 2, M = 2, lru (4 slots, 1.41 GB of HBM): layers 2-3 are
     uncached, so both tiers carry traffic. Weights are random, seeded;
  5. the served MoE layer against a dense plain reference on the card,
     for a cached and an uncached layer;
  6. where a dense decode step's time goes (``torch.profiler``), with the
     host->device copies on the compute stream and on the copy stream
     (post-fetch) kept apart;
  7. the same model, weights and requests with cross-layer prefetch on:
     tokens bitwise equal to phase 4's; then prefetch and the CPU miss
     lane on (8 host threads, fusion of groups up to 4 tokens), the
     paper's full configuration: the host lane carries traffic, its served
     MoE layer against the dense plain reference; a profiled decode step
     of each (copies by stream, activation copies, host-lane wall);
  8. the same model, weights and requests served untraced and then with
     a ``repro_torch.obs.TraceRecorder``: tokens bitwise equal to phase
     4's; the trace (``chiprun_out/trace_mixtral.json``) must validate with
     every request's lifecycle; traced and untraced tok/s, event and
     dropped counts, the mean of each engine and scheduler span;
  9. serve 7 requests of 40-96 tokens (3 opening with one 64-token
     prefix) plus one fork on the paged-KV + segment-streamed path (page
     size 16, 32-token segments, one per tick, prefix retention 8), same
     model and weights; checks tokens, counters, prefix hits, copy-on-
     write, the fork child against its parent and the page accounting;
 10. the attention layer functions on the card: paged decode against
     dense decode over the same KV in permuted pages, paged segment
     (kernel) against the dense segment (plain flash scan);
 11. where a paged decode step's time goes;
 12. where a segment-streamed prefill's time goes;
 12b. the static-batch path and the paper's tooling on phase 4's weights
     and pinned host tier (``build(params=...)``): ``generate`` of 4
     prompts of 32 tokens, 16 greedy tokens, through three engines (a full
     cache, N = 4, M = 8: all 32 experts in HBM; phase 4's N = 2, M = 2;
     N = 1, M = 1) whose tokens must be bitwise equal, with the stats
     identities, ms a decode step, tok/s and hit rates; each prompt's
     first token through ``prefill_request`` with and without warming;
     the sequential oracle ``collaborative_moe_reference`` against probe
     -> execute -> commit on a cached and an uncached layer; a router
     trace captured over 256 teacher-forced tokens, replayed through the
     torch cache and ``NumpyCache`` (equal hits), and the simulator on it
     and on a synthetic 32-layer trace (the paper testbed's cost model,
     not this card); a reduced smollm train step under the host mesh,
     bitwise equal to the step without one. Only ``swiglu_gmm``, ``gmm``
     and ``flash_decode`` may launch in ``generate``;
 13. phi35-moe (16 experts top-2, d_ff 6400) and qwen3-moe-30b-a3b (128
     experts top-8, d_model 2048, d_ff 768) on the collaborative engine at
     their published widths, 4 layers each (host tiers of 10.1 and 4.8
     GB), phase 4's requests, seeded random weights: tok/s, hit rate,
     fetches, each model's MoE layer against the dense plain reference;
     each host tier is released before the next model;
 14. serve mistral-nemo-12b on the generic path at its full published
     size (12.2 B parameters, 24.5 GB of bf16 weights on the card), seeded
     random weights: 4 prompts of 1024 tokens, 32 greedy tokens through
     the flash-decode kernel, 4 more profiled; prefill of S+1 against
     prefill of S and a decode step;
 15. serve mamba2-370m on the generic path (``repro_torch.models.prefill``
     and ``decode_step``, greedy) at its published widths and all 48
     layers, seeded random weights: 4 prompts of 2048 tokens with 64
     generated tokens, then 1 prompt of 1000 (a ragged chunk) with 16;
     every prefill runs the ``ssd_scan`` kernel once per layer;
 16. one Mamba layer on the card: through the kernel against through the
     plain scan; prefill of S+1 tokens against prefill of S and a decode
     step, for the layer and for the 48-layer model;
 17. where a Mamba prefill's and a decode step's time goes;
 18. serve gemma3-4b on the generic path at its full published size (34
     layers: 5 groups of its 6-layer period of five 1024-key windows and a
     global layer, then 4 remainder layers; 3.88 B parameters, 7.8 GB of
     bf16 on the card), seeded random weights: 4 prompts of 2048 tokens
     (twice the window; the flash scan, as the reference's, takes whole
     1024-key chunks past 1024 keys), 32 greedy tokens through the
     head-dim-256 flash-decode build; prefill of S+1 against S and a
     decode step (S streamed as one segment: 2047 keys are no whole
     chunk);
 19. serve jamba-v0.1-52b at its published widths with ``num_layers`` cut
     32 -> 8 (one period: 7 Mamba layers and 1 attention layer, the MoE on
     layers 1, 3, 5 and 7; 13.3 B parameters, 26.6 GB on the card): 2
     prompts of 1024 tokens (prefill through the d_state-16 ``ssd_scan``
     build), 16 greedy tokens; prefill against decode likewise;
 20. serve llama4-maverick-400b-a17b at its published widths with
     ``num_layers`` cut 48 -> 2 (one period: a dense-FFN layer and a
     128-expert top-1 MoE layer with its shared expert; 18.6 B
     parameters, 37.3 GB on the card): 4 prompts of 256 tokens, 16 greedy
     tokens; its MoE layer against a dense plain reference; prefill
     against decode likewise. Each of phases 18-20 frees its weights
     before the next;
 21. serve qwen2-vl-7b on the generic path at its full published size
     (28 layers, 7.62 B parameters, 15.2 GB on the card), seeded random
     weights: 4 prompts of 1024 tokens whose first 64 are seeded patch
     embeddings through the front end's projection, on an 8 x 8 grid of
     M-RoPE positions (the text after them at t = h = w = its index), 32
     greedy tokens through ``flash_decode`` (GQA group 7); prefill of 513
     tokens against 512 and a decode step; one patch's grid position and
     the patches themselves must move the logits;
 22. serve seamless-m4t-large-v2 on the generic path at its full published
     size (24 encoder and 24 decoder layers, 1.77 B parameters), seeded
     random weights: 4 requests of 1024 frames and 1024 decoder tokens,
     32 greedy tokens, each decoder layer's self- and cross-attention
     through ``flash_decode`` (GQA group 1); prefill of 513 decoder tokens
     against 512 and a decode step, the frames held fixed. Phases 21-22
     print the weight-read bound of a decode step and where two more
     steps' time goes, and free their weights;
 23. training, with the kernels' launch counts set to 0 before and read
     after (they must stay 0: train mode reaches no kernel): (a)
     ``repro_torch.launch.train``'s code path at smollm-360m's full size
     (32 layers, tied embeddings, seeded random weights), 20 steps of
     8 x 256 synthetic tokens with checkpoints every 5 steps (under
     ``build/train_ckpt``) and a failure injected at step 7, every step's
     loss and grad norm printed; then the same run uninterrupted, and the
     two final losses held together; step time, tok/s, peak HBM and
     restarts of each; (b) Mixtral-8x7B at its published widths with
     ``num_layers`` cut 32 -> 2 (3.16 B parameters, every expert table on
     the card), 4 steps of 2 x 256 tokens: loss, aux, grad norm, step
     time, peak HBM; where a step's time goes for (a) and (b) (the
     profiler); (c) ``loss_fn`` and every gradient of one reduced
     config a family (dense, MoE, Mamba, gemma3's mixed period, vlm,
     audio) on the card against the CPU, same weights and batch;
 24. the ``kernels`` line (launch counts from the serve, static-batch
     (``static``) and train phases, by phase and summed; times at the
     served, long and other models' shapes) and the result line.
Prints nothing of the result when no GPU is present.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                         # dense bf16 tensor-core peak
LAYERS = 4
SERVE = dict(requests=6, prompt=(16, 32), new_tokens=16, slots=4)
# phase 12b: the static batch on phase 4's weights: (batch, prompt, greedy
# tokens), the three cache geometries (label, N, M, prefill_chunk: the full
# cache, all 32 experts in HBM; phase 4's; the smallest), and the
# teacher-forced tokens of the captured router trace
STATIC = dict(batch=4, prompt=32, steps=16,
              caches=(("full", 4, 8, 0), ("phase 4", 2, 2, 8),
                      ("minimal", 1, 1, 8)),
              trace_tokens=256)
# phase 7: prefetch, then prefetch and the CPU miss lane (the paper's full
# configuration: 8 host threads, small-group fusion up to 4 tokens)
HOST = dict(host_threads=8, host_fuse_small=4)
# phase 9: the paged-KV + segment-streamed path. Prompts of 40-96 tokens,
# three of them opening with one 64-token prefix (4 full pages of 16)
PAGED = dict(page_size=16, segment=32, keep_pages=8, slots=4, prompt=(40, 96),
             new_tokens=16, prefix=64, requests=7, shared=(0, 4, 5))
# phase 15: mamba2-370m's generic path, (batch, prompt, generated tokens):
# the served batch, and one prompt with a 232-token ragged chunk
MAMBA = dict(batches=((4, 2048, 64), (1, 1000, 16)))
# phase 13: the other MoE models on the collaborative engine at their
# published widths, 4 layers each (phase 4's requests); the cache covers
# layers 0-1 with a quarter of each layer's experts, as Mixtral's 2 of 8:
# 4 of phi35-moe's 16, 32 of qwen3-moe's 128 (also the most experts 4
# slots x top-8 picks can reach in a step)
MOE_MODELS = (("phi35-moe", 4), ("qwen3-moe-30b-a3b", 32))
# phase 14: mistral-nemo-12b on the generic path at its full published
# size, no cut: (batch, prompt, generated tokens), then profiled steps
DENSE = dict(arch="mistral-nemo-12b", batch=4, prompt=1024, new_tokens=32,
             profiled=4)
# phases 18-20: the reference's mixed layer periods on the generic path:
# (arch, num_layers kept (None: the published depth), batch, prompt,
# generated tokens, prompt length of the prefill-against-decode check).
# The check's prompt keeps the MoE dispatch dropless (the reference's
# serve capacity factor of 8 holds up to 256 picks a row): 128 tokens of
# jamba's top-2, 256 of llama4's top-1; gemma3's is twice its window
MIXED = (("gemma3-4b", None, 4, 2048, 32, 2048),
         ("jamba-v0.1-52b", 8, 2, 1024, 16, 128),
         ("llama4-maverick-400b-a17b", 2, 4, 256, 16, 256))
# phase 21: qwen2-vl-7b at its full published size: (batch, prompt of which
# the first `patches` tokens are patch embeddings on a grid x grid layout,
# generated tokens, prompt length of the prefill-against-decode check: no
# more than one 1024-key chunk)
VLM = dict(arch="qwen2-vl-7b", batch=4, prompt=1024, patches=64, grid=8,
           new_tokens=32, check_len=513)
# phase 22: seamless-m4t-large-v2 at its full published size: (batch,
# encoder frames, decoder prompt, generated tokens, the check's decoder
# prompt; its frames stay the phase's 1024)
ENCDEC = dict(arch="seamless-m4t-large-v2", batch=4, frames=1024,
              prompt=1024, new_tokens=32, check_len=513)
# phase 23: training. smollm-360m at its full size through the trainer
# (checkpoints every 5 steps, a failure injected at step 7); Mixtral-8x7B
# at its published widths with 2 of its 32 layers (its 3.16 B parameters'
# weights, gradients, fp32 master and moments take about 51 GB); one
# reduced config a family against the CPU
TRAIN = dict(arch="smollm-360m", steps=20, batch=8, seq=256, ckpt_every=5,
             failure=7)
MIXTRAL_TRAIN = dict(layers=2, batch=2, seq=256, steps=4)
TRAIN_CHECK = ("smollm-360m", "mixtral-8x7b", "mamba2-370m", "gemma3-4b",
               "qwen2-vl-7b", "seamless-m4t-large-v2")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Device time of one call, from ``torch.profiler``: the kernels and
    copies the calls ran, without the host time between them (which the
    event timing of a small launch mostly is). None if the profiler saw
    no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_ms(e) for e in prof.key_averages())
    return total / iters if total > 0 else None


def bound(nbytes: int, ops: int):
    """Least time for the work: its bytes over HBM, its operations over
    the bf16 peak, whichever is longer. Returns (ms, by)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _compare(got, want):
    """(max abs error, tolerance) of a kernel output against its plain
    version. Both form the same products and sum in another fp32 order:
    a bf16 output within one bf16 rounding of its largest value, 2^-7
    max|want|; an fp32 output (never rounded: the SSD state) within 2^-13
    max|want|, sums of up to a chunk times d_state terms reordered. The
    tiny floor only for all-zero outputs."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    rel = 2 ** -7 if got.dtype == torch.bfloat16 else 2 ** -13
    return err, rel * want.float().abs().max().item() + 1e-5


def check_kernels(kernels):
    """Each kernel against its plain version at every shape of its
    ``cases`` (``repro_torch.kernels.cases``), timed at the served and
    long ones. Returns {name: {label: measurements}}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for k in kernels:
        name, wrapper, plain = k["name"], k["wrapper"], k["plain"]
        for label, spec in k["cases"]:
            args = k["inputs"](spec, gen)
            got = wrapper(*args)
            again = wrapper(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       zip(_outputs(got), _outputs(again))):
                raise SystemExit(f"{name} is not bitwise equal from launch "
                                 f"to launch at {spec}")
            del again
            want = plain(*args)
            err = 0.0
            for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
                e, tol = _compare(g, w)
                ok = bool(torch.isfinite(g.float()).all()) and e <= tol
                print(f"[kernel] {name} {label} {spec} output {i} "
                      f"({str(g.dtype)[6:]}): max_abs_err={e:.6g} "
                      f"tol={tol:.6g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version at {spec}")
                err = max(err, e)
            if label in ("served", "long") or label.startswith("model:"):
                ms = time_ms(lambda: wrapper(*args))
                # a profile that saw no device time is taken once more
                dev_ms = device_ms(lambda: wrapper(*args)) \
                    or device_ms(lambda: wrapper(*args))
                plain_ms = time_ms(lambda: plain(*args), iters=3)
                lib = k["library"](args) if k["library"] else None
                lib_ms = time_ms(lib) if lib is not None else None
                lib_dev_ms = device_ms(lib) if lib is not None else None
                bound_ms, by = bound(*k["work"](args, got))
                results.setdefault(name, {})[label] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms)
                print(f"[kernel] {name} {label}: {ms:.4f} ms, device "
                      f"{dev_ms} ms (plain "
                      f"{plain_ms:.4f} ms, library {lib_ms} ms, device "
                      f"{lib_dev_ms} ms, bound "
                      f"{bound_ms:.4f} ms by {by}: "
                      f"{100 * bound_ms / ms:.1f}% of roofline)")
            del args, got, want
        torch.cuda.empty_cache()
    return results


def h2d_rate_gbps(nbytes: int = 1 << 30) -> float:
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), iters=5)
    return nbytes / (ms * 1e-3) / 1e9


def _serve_requests(sched, vocab: int):
    """Phase 4's request stream (seed 0: ``SERVE``'s count, prompt lengths
    and budget) through ``sched``, timed from a synchronized card to the
    last token, the kernels' launch counts reset first. Returns (outputs
    by request, seconds, launch counts)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    lo, hi = SERVE["prompt"]
    rng = np.random.default_rng(0)
    for _ in range(SERVE["requests"]):
        plen = int(rng.integers(lo, hi + 1))
        sched.submit(rng.integers(0, vocab, plen),
                     max_new_tokens=SERVE["new_tokens"])
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = sched.run()
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, kernels.launches()


def serve():
    """Phase 4: the port's main path at Mixtral's full widths."""
    import torch
    from repro_torch import build
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS)
    print(f"[serve] {cfg.name} at published widths, num_layers cut 32 -> "
          f"{LAYERS}: d_model={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads}x{cfg.head_dim} experts={cfg.moe.num_experts} "
          f"top{cfg.moe.top_k} d_ff={cfg.moe.d_ff} vocab={cfg.vocab_size}")
    hi = SERVE["prompt"][1]
    t0 = time.perf_counter()
    engine, sched = build(
        cfg, cache=dict(num_indexes=2, num_ways=2, policy="lru"),
        serving=dict(max_batch=SERVE["slots"],
                     capacity=hi + SERVE["new_tokens"] + 1, prefill_chunk=8),
        seed=0, device="cuda")
    torch.cuda.synchronize()
    host_gb = sum(t.numel() * t.element_size() for t in engine.tiers.host) / 1e9
    slot_gb = sum(t.numel() * t.element_size()
                  for t in engine.tiers.slots) / 1e9
    print(f"[serve] built in {time.perf_counter() - t0:.1f} s: host tier "
          f"{host_gb:.2f} GB pinned={engine.tiers.host_w1.is_pinned()}, "
          f"slot buffer {slot_gb:.2f} GB on {engine.tiers.slot_w1.device}")
    torch.cuda.reset_peak_memory_stats()
    outs, dt, launches = _serve_requests(sched, cfg.vocab_size)
    st = sched.stats
    total = sum(len(o) for o in outs.values())
    print(f"[serve] served {st.requests_finished} requests / {total} tokens "
          f"in {dt:.3f} s ({total / dt:.3f} tok/s wall, {st.steps} decode "
          f"steps, peak HBM {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB)")
    print(f"[serve] cache hit rate {st.hit_rate:.4f} (hits={st.hits} "
          f"accesses={st.accesses} fetches={st.fetched_experts}); prefill "
          f"warming {st.prefill_tokens} tokens, hits={st.prefill_hits} "
          f"accesses={st.prefill_accesses} fetches={st.prefill_fetched}; "
          f"per-layer hits {st.per_layer_hits} of {st.per_layer_accesses}")
    print(f"[serve] latency ttft_ms p50={st.ttft_ms_p50:.1f} "
          f"p99={st.ttft_ms_p99:.1f} tpot_ms p50={st.tpot_ms_p50:.1f} "
          f"p99={st.tpot_ms_p99:.1f}; launches {launches}")
    # what came out: every request finished with its budget of valid tokens
    if st.requests_finished != SERVE["requests"]:
        raise SystemExit("not every request finished")
    for rid, o in outs.items():
        if len(o) != SERVE["new_tokens"] or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            raise SystemExit(f"request {rid}: bad output {o.tolist()}")
    if st.accesses != st.tokens * cfg.moe.top_k * cfg.num_layers:
        raise SystemExit("accesses do not count every decoded pick")
    if st.hits == 0 or st.fetched_experts == 0:
        raise SystemExit("one of the two tiers carried no traffic")
    for name in ("swiglu_gmm", "gmm", "flash_decode"):
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} was never launched while "
                             f"serving the dense path")
    return engine, launches, dict(tok_s=total / dt, seconds=dt, outs=outs,
                                  hit_rate=st.hit_rate,
                                  tpot_ms=st.tpot_ms_p50)


def check_layer(engine):
    """Phase 5: one served MoE layer (tiers + kernels) against a dense
    plain reference with the host-tier weights, cached and uncached."""
    import torch
    from repro_torch.core import collaborative as collab
    from repro_torch.models.moe import route
    cfg, ccfg = engine.cfg, engine.ecfg.cache
    gen = torch.Generator(device="cuda").manual_seed(1)
    T, K = SERVE["slots"], cfg.moe.top_k
    for layer in (0, LAYERS - 1):
        x = torch.randn((T, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        router = engine.params["scan"]["s0"]["moe"]["router"][layer]
        _, top_i, top_w = route(router, x.float(), K)
        # the returned tiers keep the cache state and the slots in step
        y, engine.tiers, stats = collab.collaborative_moe(
            engine.tiers, layer, x, top_i, top_w, ccfg)
        want = _dense_moe(engine, layer, x, top_i, top_w)
        err = (y.float() - want).abs().max().item()
        tol = 2 ** -6 * want.abs().max().item()
        tier = "cached" if layer < ccfg.num_indexes else "uncached"
        print(f"[check] layer {layer} ({tier}): hits={stats['hits']} "
              f"max_abs_err={err:.6g} tol={tol:.6g}")
        if not (torch.isfinite(y).all() and err <= tol):
            raise SystemExit(f"served MoE layer {layer} disagrees with the "
                             f"dense reference")


def _device_ms(ev) -> float:
    """Device time of a profiler row, in ms, for rows that ARE device work
    (kernels and copies); host-side ops' rows, which repeat the device
    time of what they launched, give 0."""
    from torch.autograd import DeviceType
    if getattr(ev, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name)) / 1e3
    return 0.0


def profile_decode(engine, label: str, steps: int = 4):
    """Phases 6, 7 and 11: where a decode step's time goes. Four requests
    decode together (no admission in the window); ``torch.profiler`` sums
    the device time by kernel and copy, against the window's wall time,
    and splits the copies by stream. With a host lane, its wall (the
    executor's calls, timed on the host) a step and a layer. A fresh
    scheduler re-initializes the engine's slots (and page pool). Returns
    {"step_ms", "idle", "streams", "host_ms"}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(engine, seed=7)
    rng = np.random.default_rng(1)
    for _ in range(SERVE["slots"]):
        sched.submit(rng.integers(0, engine.cfg.vocab_size, 24),
                     max_new_tokens=steps + 2)
    sched.step()                          # admission + the first decode
    torch.cuda.synchronize()
    ex, lane = engine.host_executor, [0, 0]
    if ex is not None:
        compute = ex.compute_groups

        def timed(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return compute(*a, **k)
            finally:
                lane[0] += time.perf_counter_ns() - t0
                lane[1] += 1
        ex.compute_groups = timed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if ex is not None:
        del ex.compute_groups
    print(f"[profile] {label}: {steps} decode steps at {SERVE['slots']} "
          f"slots:")
    busy = _report(prof, wall_ms, steps, label, "step")
    streams = _by_stream(prof, steps, label)
    host_ms = lane[0] / 1e6 / steps
    if ex is not None:
        print(f"[profile]   {label} host lane: {lane[1]} executor calls, "
              f"{host_ms:.3f} ms/step wall, "
              f"{lane[0] / 1e6 / max(lane[1], 1):.3f} ms a call (a layer "
              f"with CPU groups)")
    return dict(step_ms=wall_ms / steps, idle=1 - busy / wall_ms,
                streams=streams, host_ms=host_ms)


def _by_stream(prof, units: int, label: str):
    """Copy time of a profiled window by stream and direction, from its
    Chrome trace: the compute stream is the one the grouped kernels ran
    on, any other is a copy stream. Returns {(stream, kind): ms/unit}."""
    path = ROOT / "build" / f"profile_{label.replace(' ', '_')}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    compute, ms = None, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel",
                                                       "gpu_memcpy"):
            continue
        stream = e.get("args", {}).get("stream", e.get("tid"))
        name = e.get("name", "")
        if e["cat"] == "kernel":
            if "gmm_tma_kernel" in name:
                compute = stream
            continue
        kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in name),
                    "other")
        ms[(stream, kind)] = ms.get((stream, kind), 0.0) + e["dur"] / 1e3
    out = {}
    for (stream, kind), t in sorted(ms.items(), key=lambda kv: str(kv[0])):
        where = "compute" if stream == compute else "copy"
        key = f"{kind} {where} stream"
        out[key] = out.get(key, 0.0) + t / units
    for key, t in out.items():
        print(f"[profile]   {label} {key}: {t:.3f} ms/step")
    if compute is None:
        print(f"[profile]   {label} streams: not measured (no grouped "
              f"kernel in the trace)")
    path.unlink()
    return out


def serve_prefetch(params, base):
    """Phase 7: phase 4's model, weights and requests with prefetch on,
    then with prefetch and the host lane on. Prefetch moves residency,
    never logits, and the kernels are bitwise repeatable, so every token
    must equal phase 4's: a slot read before its copy on the copy stream
    landed would show here. Returns (launches by run, profiles)."""
    import numpy as np
    import torch
    from repro_torch import build
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS)
    hi = SERVE["prompt"][1]
    launches, profiles = {}, {}
    for run, extra in (("prefetch", {}), ("host", dict(host_compute=True,
                                                       **HOST))):
        engine, sched = build(
            cfg, cache=dict(num_indexes=2, num_ways=2, policy="lru"),
            serving=dict(max_batch=SERVE["slots"],
                         capacity=hi + SERVE["new_tokens"] + 1,
                         prefill_chunk=8, prefetch=True, **extra),
            seed=0, params=params, device="cuda")
        outs, dt, launches[run] = _serve_requests(sched, cfg.vocab_size)
        st = sched.stats
        total = sum(len(o) for o in outs.values())
        same = sum(int(np.sum(outs[r] == base["outs"][r])) for r in outs)
        print(f"[{run}] served {st.requests_finished} requests / {total} "
              f"tokens in {dt:.3f} s ({total / dt:.3f} tok/s wall, "
              f"{st.steps} decode steps); tokens equal to phase 4's: "
              f"{same}/{total}")
        print(f"[{run}] cache hit rate {st.hit_rate:.4f} (phase 4: "
              f"{base['hit_rate']:.4f}; hits={st.hits} accesses="
              f"{st.accesses} fetches={st.fetched_experts}); prefetch "
              f"issued={st.prefetch_issued} hits={st.prefetch_hits} "
              f"wasted={st.prefetch_wasted} predicted_correct/predicted="
              f"{st.predicted_correct}/{st.predicted}; tpot_ms p50="
              f"{st.tpot_ms_p50:.1f} p99={st.tpot_ms_p99:.1f}; launches "
              f"{launches[run]}")
        if st.requests_finished != SERVE["requests"] \
                or st.prefetch_issued <= 0:
            raise SystemExit(f"{run}: not every request finished, or no "
                             f"prefetch was issued")
        for name in ("swiglu_gmm", "gmm", "flash_decode"):
            if launches[run][name] <= 0:
                raise SystemExit(f"kernel {name} was never launched in the "
                                 f"{run} run")
        if run == "prefetch" and same != total:
            raise SystemExit("prefetch changed the tokens of phase 4")
        if run == "host":
            ex = engine.host_executor
            print(f"[host] host lane: cpu_expert_calls={st.cpu_expert_calls} "
                  f"cpu_tokens={st.cpu_tokens} fused_groups="
                  f"{st.fused_groups} miss_expert_groups="
                  f"{st.miss_expert_groups} offload rate "
                  f"{st.cpu_offload_rate:.4f}; executor calls={ex.calls} "
                  f"groups={ex.groups} fused={ex.fused} census_calls="
                  f"{ex.census_calls} census_threads={ex.census_threads} "
                  f"affinity_hits={ex.affinity_hits} busy "
                  f"{ex.busy_ns / 1e6:.1f} ms queue_peak={ex.queue_peak}; "
                  f"peak host RSS {_peak_rss_gb():.2f} GB")
            if st.cpu_expert_calls <= 0 or ex.groups != st.cpu_expert_calls:
                raise SystemExit("the host lane carried no traffic, or the "
                                 "executor ran other groups than counted")
            for o in outs.values():
                if len(o) != SERVE["new_tokens"] or o.min() < 0 \
                        or o.max() >= cfg.vocab_size:
                    raise SystemExit(f"host run: bad output {o.tolist()}")
            check_host_layer(engine)
        profiles[run] = profile_decode(engine, run)
        if engine.host_executor is not None:
            engine.host_executor.close()
        del engine, sched
        torch.cuda.empty_cache()
    return launches, profiles


def _peak_rss_gb() -> float:
    """The process's peak resident host memory (Linux: ru_maxrss in KB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _rss_gb() -> float:
    """The process's resident host memory now (Linux: /proc/self/statm)."""
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * resource.getpagesize() / 1e9


def _release_host_tier() -> None:
    """Return freed pinned host blocks to the system: PyTorch's caching
    host allocator keeps them for reuse otherwise."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def check_host_layer(engine):
    """Phase 7: the served MoE layer with the host lane (probe ->
    ``hostexec.dispatch_execute`` with the engine's decision table and
    executor -> commit) against the dense plain reference with the
    host-tier weights, for a cached and an uncached layer. The host lane
    computes in fp32 and rounds once to bf16, the card's lane rounds its
    [G, A, F] intermediate too: within 2^-6 of the largest output, as
    phase 5."""
    import torch
    from repro_torch import hostexec
    from repro_torch.core import collaborative as collab
    from repro_torch.models.moe import route
    cfg, ccfg = engine.cfg, engine.ecfg.cache
    gen = torch.Generator(device="cuda").manual_seed(2)
    T, K = SERVE["slots"], cfg.moe.top_k
    cpu_groups = 0
    for layer in (0, LAYERS - 1):
        x = torch.randn((T, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        router = engine.params["scan"]["s0"]["moe"]["router"][layer]
        _, top_i, top_w = route(router, x.float(), K)
        pr = collab.probe(engine.tiers, layer, top_i.cpu(), ccfg)
        y, staged, dstats = hostexec.dispatch_execute(
            engine.tiers, layer, x, top_w, pr, ccfg, engine._cpu_table,
            engine.host_executor, engine.ecfg.host_fuse_small)
        engine.tiers, _ = collab.commit(engine.tiers, layer, pr, staged,
                                        ccfg)
        cpu_groups += dstats["cpu_expert_calls"]
        want = _dense_moe(engine, layer, x, top_i, top_w)
        err = (y.float() - want).abs().max().item()
        tol = 2 ** -6 * want.abs().max().item()
        print(f"[check] host lane, layer {layer}: {dstats} "
              f"max_abs_err={err:.6g} tol={tol:.6g}")
        if not (torch.isfinite(y).all() and err <= tol):
            raise SystemExit(f"the host-lane MoE layer {layer} disagrees "
                             f"with the dense reference")
    if cpu_groups <= 0:
        raise SystemExit("the host-lane layer check sent no group to the CPU")


def _dense_moe(engine, layer, x, top_i, top_w):
    """The dense plain reference of one MoE layer on the card: every pick
    through the plain grouped FFN with the host-tier weights, fp32 sum."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm_plain, swiglu_gmm_plain
    T, K = top_i.shape
    want = torch.zeros((T, x.shape[-1]), device="cuda")
    for t in range(T):
        for k in range(K):
            e = int(top_i[t, k])
            w1, w3, w2 = (h[layer, e].to("cuda")[None]
                          for h in engine.tiers.host)
            h = swiglu_gmm_plain(x[t][None, None], w1, w3)
            want[t] += top_w[t, k] * gmm_plain(h, w2)[0, 0].float()
    return want


def _report(prof, wall_ms: float, units: int, label: str, unit: str):
    """Device time of a profiled window by kind, against its wall time."""
    rows = [(e.key, _device_ms(e), e.count)
            for e in prof.key_averages() if _device_ms(e) > 0]
    busy = sum(ms for _, ms, _ in rows)
    groups = {"host->device copy": ("HtoD",), "device->host copy": ("DtoH",),
              "device copy": ("DtoD",), "grouped expert kernels":
              ("gmm_tma_kernel", "gmm_scalar_kernel"),
              "attention kernels": ("decode_split_kernel",
                                    "prefill_split_kernel",
                                    "combine_kernel"),
              "ssd scan kernel": ("chunk_state_kernel", "state_pass_kernel",
                                  "chunk_output_kernel"),
              "gemm (projections, router, logits)":
              ("gemm", "gemv", "nvjet", "xmma", "cutlass")}
    by = {g: 0.0 for g in groups}
    for key, ms, _ in rows:
        for g, marks in groups.items():
            if any(m in key for m in marks):
                by[g] += ms
                break
    by["other"] = busy - sum(by.values())
    print(f"[profile] {label}: wall {wall_ms:.3f} ms ({wall_ms / units:.3f} "
          f"ms/{unit}), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.4f}")
    for g, ms in by.items():
        print(f"[profile]   {label} {g}: {ms:.3f} ms ({ms / units:.3f} "
              f"ms/{unit}, {100 * ms / wall_ms:.1f}% of wall)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"[profile]   {label} top: {ms:.3f} ms in {n} calls: "
              f"{key[:90]}")
    if busy <= 0:
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
    return busy


def profile_segment(engine, segments: int = 2):
    """Phase 12: where a segment-streamed prefill's time goes. One
    request's prompt streams ``segments`` 32-token segments through the
    paged engine (forward with the paged-prefill kernel, KV into the pool,
    warm) under ``torch.profiler``; the prefill MoE stages each layer's
    whole expert table on the device for every segment."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = engine.init_slots()
    seg = engine.ecfg.prefill_segment
    prompt = np.random.default_rng(4).integers(0, engine.cfg.vocab_size,
                                               segments * seg)
    ticket = engine.start_prefill(prompt, max_total_tokens=len(prompt) + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, done = engine.advance_prefill_state(ticket, state, segments)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not done:
        raise SystemExit("segment profile: the stream did not drain")
    engine.abort_ticket(ticket)
    moe = engine.params["scan"]["s0"]["moe"]
    table_gb = sum(moe[n][0].numel() * moe[n][0].element_size()
                   for n in ("w1", "w3", "w2")) / 1e9
    print(f"[profile] segment prefill: {segments} segments of {seg} tokens, "
          f"expert table per layer {table_gb:.3f} GB x "
          f"{engine.cfg.num_layers} layers staged per segment:")
    _report(prof, wall_ms, segments, "segment", "segment")


def _paged_requests(vocab: int):
    """(prompt, max_new_tokens) of the paged phase: request 0 is the
    64-token prefix plus 32 tokens (3 segments, so it outlives requests 1-3
    by a tick and its pages are live when requests 4 and 5, which open
    with the same prefix, are admitted); the rest draw 40-96 tokens."""
    import numpy as np
    rng = np.random.default_rng(2)
    lo, hi = PAGED["prompt"]
    prefix = rng.integers(0, vocab, PAGED["prefix"])
    out = []
    for i in range(PAGED["requests"]):
        if i == 0:
            p = np.concatenate([prefix, rng.integers(0, vocab, 32)])
        elif i in PAGED["shared"]:
            tail = int(rng.integers(8, hi - PAGED["prefix"] + 1))
            p = np.concatenate([prefix, rng.integers(0, vocab, tail)])
        else:
            p = rng.integers(0, vocab, int(rng.integers(lo, 65)))
        out.append((p, PAGED["new_tokens"]))
    return out


def serve_paged(params):
    """Phase 9: the paged-KV + segment-streamed path at Mixtral's widths
    (the same 4 layers and weights as phase 4: the pinned host tier is
    shared, not pinned twice). Once the queue is empty, a live, warmed
    request is forked into a free slot at a length inside a page, so its
    next append copies on write. The pool is audited once, after the run,
    so the timed window holds serving alone (the CPU tests audit every
    tick). Returns (engine, launch counts)."""
    import numpy as np
    import torch
    from repro_torch import build, kernels
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS)
    ps = PAGED["page_size"]
    cap = -(-(PAGED["prompt"][1] + PAGED["new_tokens"] + 1) // ps) * ps
    engine, sched = build(
        cfg, cache=dict(num_indexes=2, num_ways=2, policy="lru"),
        serving=dict(max_batch=PAGED["slots"], capacity=cap,
                     prefill_chunk=8, kv_paged=True, page_size=ps,
                     prefill_segment=PAGED["segment"],
                     admit_chunks_per_tick=1,
                     prefix_keep_pages=PAGED["keep_pages"]),
        seed=0, params=params, device="cuda")
    print(f"[paged] kv_paged page_size={ps} capacity={cap} pool="
          f"{engine.num_pages} pages, prefill_segment={PAGED['segment']} "
          f"(1 segment/tick), prefix_keep_pages={PAGED['keep_pages']}, "
          f"{PAGED['slots']} slots")
    reqs = [sched.submit(p, max_new_tokens=n)
            for p, n in _paged_requests(cfg.vocab_size)]
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    forked = None
    t0 = time.perf_counter()
    while sched.queue or any(s is not None for s in sched.slots):
        sched.step()
        if forked is None and not sched.queue and None in sched.slots:
            live = [r for t, r in enumerate(sched.slots)
                    if r is not None and sched._tickets[t] is None
                    and len(r.generated) <= r.max_new_tokens - 2
                    and (len(r.prompt) + len(r.generated) - 1) % ps]
            if live:
                parent = min(live, key=lambda r: r.rid)
                forked = (parent, sched.fork(parent.rid))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launches()
    st = sched.stats
    total = sum(len(r.generated) for r in sched.finished)
    print(f"[paged] served {st.requests_finished} requests / {total} "
          f"tokens in {dt:.3f} s ({total / dt:.3f} tok/s wall, {st.steps} "
          f"decode steps, peak HBM "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    print(f"[paged] segments={st.prefill_segments} prefix_hits="
          f"{st.prefix_hits} prefix_tokens_skipped="
          f"{st.prefix_tokens_skipped} cow_forks={st.cow_forks} "
          f"pages_in_use={st.kv_pages_in_use} retained="
          f"{st.prefix_pages_retained}; cache hit rate {st.hit_rate:.4f} "
          f"(hits={st.hits} accesses={st.accesses} fetches="
          f"{st.fetched_experts}); prefill warming {st.prefill_tokens} "
          f"tokens, hits={st.prefill_hits} accesses={st.prefill_accesses} "
          f"fetches={st.prefill_fetched}")
    print(f"[paged] latency ttft_ms p50={st.ttft_ms_p50:.1f} "
          f"p99={st.ttft_ms_p99:.1f} tpot_ms p50={st.tpot_ms_p50:.1f} "
          f"p99={st.tpot_ms_p99:.1f} stall_ms p50={st.stall_ms_p50:.1f} "
          f"p99={st.stall_ms_p99:.1f}; launches {launches}")
    # what came out, and the page accounting
    if st.requests_finished != len(reqs) + 1 or forked is None:
        raise SystemExit("paged phase: not every request finished, or no "
                         "fork happened")
    for r in sched.finished:
        o = r.output
        if len(o) != r.max_new_tokens or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            raise SystemExit(f"paged request {r.rid}: bad output "
                             f"{o.tolist()}")
    if st.accesses != st.tokens * cfg.moe.top_k * cfg.num_layers:
        raise SystemExit("paged: accesses do not count every decoded pick")
    if st.prefix_hits < 2 or st.prefix_tokens_skipped <= 0 \
            or st.cow_forks < 1:
        raise SystemExit("paged: no prefix sharing or no copy-on-write")
    if not np.array_equal(forked[0].output, forked[1].output):
        raise SystemExit(f"fork child {forked[1].output.tolist()} differs "
                         f"from its parent {forked[0].output.tolist()}")
    engine.kv_pool.check_invariants()
    # every table is freed; the in-use gauge excludes retained pages
    if st.kv_pages_in_use != 0 \
            or st.prefix_pages_retained > PAGED["keep_pages"]:
        raise SystemExit("paged: pages leaked")
    for name in ("swiglu_gmm", "gmm", "paged_flash_decode",
                 "paged_flash_prefill"):
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} was never launched while "
                             f"serving the paged path")
    return engine, launches


def check_attention(engine):
    """Phase 10: the layer-level attention functions on the card, kernel
    against kernel over the same KV: ``decode_attention_paged`` (paged
    flash-decode) against ``decode_attention`` (flash-decode) with the
    cache laid out in permuted pages, and ``segment_attention_paged``
    (paged prefill kernel) against the dense ``segment_attention`` (the
    plain flash scan)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    cfg = engine.cfg
    p = transformer.layer_params(engine.params["scan"]["s0"]["attn"], 0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ps, S, B = PAGED["page_size"], engine.ecfg.capacity, PAGED["slots"]
    mp, N = S // ps, B * (S // ps) + 5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    kd = rnd(B, S, cfg.num_kv_heads, cfg.head_dim)
    vd = rnd(B, S, cfg.num_kv_heads, cfg.head_dim)
    pages = torch.randperm(N, generator=gen, device="cuda")[:B * mp]
    pages = pages.reshape(B, mp).to(torch.int32)
    kp = torch.zeros((N, ps) + kd.shape[2:], dtype=kd.dtype, device="cuda")
    vp = torch.zeros_like(kp)
    kp[pages.reshape(-1).long()] = kd.reshape((B * mp, ps) + kd.shape[2:])
    vp[pages.reshape(-1).long()] = vd.reshape((B * mp, ps) + vd.shape[2:])

    def close(what, got, want, rel):
        err = (got.float() - want.float()).abs().max().item()
        tol = rel * want.float().abs().max().item()
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        print(f"[attention] {what}: max_abs_err={err:.6g} tol={tol:.6g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{what} disagrees")

    x = rnd(B, 1, cfg.d_model)
    pos = torch.tensor([20, 57, 100, S - 2], device="cuda")
    od, _ = attn.decode_attention(p, x, {"k": kd.clone(), "v": vd.clone()},
                                  pos, cfg)
    op, _ = attn.decode_attention_paged(p, x, {"k": kp.clone(),
                                               "v": vp.clone()},
                                        pos, pages, cfg)
    # one split kernel, fed from the dense cache and, through the page
    # table in boxes of 16 keys, from the pool: here one split of the same
    # 128 keys either way. Held to one bf16 rounding of the attention
    # output, carried through wo
    close("decode_attention_paged vs decode_attention", op, od, 2 ** -6)
    C, pos0, plen = PAGED["segment"], 64, 90
    xs = rnd(1, C, cfg.d_model)
    positions = pos0 + torch.arange(C, device="cuda")[None]
    sd, cd = attn.segment_attention(p, xs, {"k": kd[:1].clone(),
                                            "v": vd[:1].clone()},
                                    pos0, positions, cfg)
    sp, cp = attn.segment_attention_paged(
        p, xs, {"k": kp.clone(), "v": vp.clone()}, pos0, positions,
        pages[:1], cfg, -1, pos0, plen)
    # the kernel against the plain flash scan (another summation order)
    close("segment_attention_paged vs segment_attention (prompt rows)",
          sp[:, :plen - pos0], sd[:, :plen - pos0], 2 ** -6)
    row = pages[0, (pos0 + 5) // ps].long()
    if not torch.equal(cp["k"][row, (pos0 + 5) % ps], cd["k"][0, pos0 + 5]):
        raise SystemExit("segment_attention_paged wrote other K than the "
                         "dense segment")


def _span_means(rec):
    """{(track, name): (count, mean ms)} of the complete spans on the
    engine and scheduler tracks."""
    acc = {}
    for ev in rec.events():
        if ev.kind == "X" and ev.track in ("engine", "sched"):
            n, t = acc.get((ev.track, ev.name), (0, 0))
            acc[(ev.track, ev.name)] = (n + 1, t + ev.dur_ns)
    return {k: (n, t / n / 1e6) for k, (n, t) in sorted(acc.items())}


def serve_traced(params, base):
    """Phase 8: phase 4's model, weights and requests served twice more,
    untraced and then with a ``TraceRecorder``: both runs' tokens must
    equal phase 4's bitwise (the recorder reads clocks and counters only).
    The trace goes to ``chiprun_out/trace_mixtral.json`` and must pass the
    Chrome-trace validator with every request's queued / prefill / decode
    spans. Returns the traced run's launch counts."""
    import numpy as np
    from repro_torch import build
    from repro_torch.config import get_config
    from repro_torch.obs import (TraceRecorder, validate_chrome_trace,
                                 write_chrome_trace)
    from repro_torch.obs.export import LIFECYCLE_SPANS, lifecycle_coverage

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS)
    hi = SERVE["prompt"][1]
    tok_s, launches = {}, None
    for run in ("untraced", "traced"):
        rec = TraceRecorder() if run == "traced" else None
        _, sched = build(
            cfg, cache=dict(num_indexes=2, num_ways=2, policy="lru"),
            serving=dict(max_batch=SERVE["slots"],
                         capacity=hi + SERVE["new_tokens"] + 1,
                         prefill_chunk=8),
            seed=0, params=params, device="cuda", recorder=rec)
        outs, dt, launches = _serve_requests(sched, cfg.vocab_size)
        total = sum(len(o) for o in outs.values())
        tok_s[run] = total / dt
        if any(not np.array_equal(outs[r], base["outs"][r]) for r in outs):
            raise SystemExit(f"the {run} run's tokens differ from phase 4's")
        print(f"[trace] {run}: {total} tokens in {dt:.3f} s "
              f"({tok_s[run]:.3f} tok/s wall), tokens equal to phase 4's")
    path = ROOT / "chiprun_out" / "trace_mixtral.json"
    path.parent.mkdir(exist_ok=True)
    doc = write_chrome_trace(rec, str(path))
    problems = validate_chrome_trace(doc)
    cover = lifecycle_coverage(doc)
    for rid in outs:
        missing = set(LIFECYCLE_SPANS) - cover.get(f"req:{rid}", set())
        if missing:
            problems.append(f"req:{rid} misses {sorted(missing)}")
    print(f"[trace] {len(rec)} events ({rec.dropped} dropped) -> "
          f"{path.relative_to(ROOT)}; traced {tok_s['traced']:.3f} tok/s "
          f"against untraced {tok_s['untraced']:.3f}")
    for (track, name), (n, ms) in _span_means(rec).items():
        print(f"[trace]   {track} {name}: {n} spans, mean {ms:.3f} ms")
    if problems or rec.dropped:
        raise SystemExit(f"the trace is not valid: {problems[:5]}, "
                         f"{rec.dropped} dropped")
    return launches


def _static_engine(params, n: int, m: int, prefill_chunk: int):
    """An engine over phase 4's weights (and its pinned host tier) with an
    N x M cache, for the static batch."""
    from repro_torch import build
    from repro_torch.config import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS)
    engine, _ = build(
        cfg, cache=dict(num_indexes=n, num_ways=m, policy="lru"),
        serving=dict(max_batch=STATIC["batch"],
                     capacity=STATIC["prompt"] + STATIC["steps"] + 1,
                     prefill_chunk=prefill_chunk),
        seed=0, params=params, device="cuda")
    return engine


def static_generate(params, base):
    """Phase 12b (1): ``generate`` for STATIC's prompts through three cache
    geometries sharing phase 4's weights; the tokens must be bitwise equal
    (the paper's no-accuracy-trade-off claim: the grouped kernels read the
    same weights from the slot buffer and from staged host copies). Returns
    (the engines by label, the launch counts of the three runs, the
    prompts)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    B, P, n = STATIC["batch"], STATIC["prompt"], STATIC["steps"]
    engines, outs, rows, prompts = {}, {}, {}, None
    kernels.reset_launches()
    for label, N, M, chunk in STATIC["caches"]:
        engine = _static_engine(params, N, M, chunk)
        vocab = engine.cfg.vocab_size
        if prompts is None:
            prompts = np.random.default_rng(3).integers(
                0, vocab, (B, P)).astype(np.int32)
        decode, select = engine._decode_step, engine.select_tokens
        step_ms, rows[label] = [], []

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode(*a, **k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def recording(logits, *a, **k):
            rows[label].append(logits.float().cpu())
            return select(logits, *a, **k)
        engine._decode_step, engine.select_tokens = timed, recording
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = engine.generate(prompts, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del engine._decode_step, engine.select_tokens
        slot_gb = sum(t.numel() * t.element_size()
                      for t in engine.tiers.slots) / 1e9
        ms = sum(step_ms) / len(step_ms)
        print(f"[static] {label} cache N={N} M={M} ({slot_gb:.2f} GB of "
              f"slots): generate {B} x {P} -> {n} tokens in {wall:.3f} s "
              f"({B * n / wall:.3f} tok/s wall), decode {ms:.3f} ms/step "
              f"(median {sorted(step_ms)[len(step_ms) // 2]:.3f}), hit rate "
              f"{st.hit_rate:.4f} (hits={st.hits} accesses={st.accesses} "
              f"fetches={st.fetched_experts}); first row "
              f"{out[0, :8].tolist()}")
        if out.shape != (B, n) or out.min() < 0 or out.max() >= vocab:
            raise SystemExit(f"static {label}: bad tokens {out.tolist()}")
        if st.first_tokens != B or st.tokens != B * (n - 1) \
                or st.accesses != st.hits + st.host_assignments \
                or st.fetched_experts > st.host_assignments:
            raise SystemExit(f"static {label}: the stats identities fail")
        outs[label] = out
        engines[label] = engine
    launches = kernels.launches()
    print(f"[static] phase 4's dense tpot p50 {base['tpot_ms']:.3f} ms on "
          f"the scheduler path ({card_line()}); generate launches "
          f"{launches}")
    ref_label = "full"
    for label, out in outs.items():
        diff = np.argwhere(out != outs[ref_label])
        if diff.size:
            r, s = (int(v) for v in diff[0])
            row = rows[ref_label][s][r]
            gap = float(row[outs[ref_label][r, s]] - row[out[r, s]])
            raise SystemExit(f"static: {label}'s tokens differ from "
                             f"{ref_label}'s at row {r} token {s} (logit "
                             f"gap {gap:.4f})")
    print(f"[static] tokens bitwise equal across the {len(outs)} cache "
          f"geometries: {B * n}/{B * n}")
    for name, count in launches.items():
        if (count > 0) != (name in ("swiglu_gmm", "gmm", "flash_decode")):
            raise SystemExit(f"static: kernel {name} launched {count} times")
    return engines, launches, prompts


def static_prefill_request(engines, prompts):
    """Phase 12b (2): each prompt's first token through ``prefill_request``
    with the bypass (the full cache's engine, prefill_chunk 0) and with
    chunked warming (phase 4's geometry, prefill_chunk 8)."""
    bypass, warm = engines["full"], engines["phase 4"]
    for i, prompt in enumerate(prompts):
        t0, _ = bypass.prefill_request(prompt)
        t1, _ = warm.prefill_request(prompt)
        print(f"[static] prompt {i}: first token bypass {t0}, warmed {t1}")
        if t0 != t1:
            raise SystemExit("static: warming changed a first token")
    st = warm.stats
    print(f"[static] warming: {st.prefill_tokens} tokens, hits="
          f"{st.prefill_hits} accesses={st.prefill_accesses} fetches="
          f"{st.prefill_fetched}; bypass accesses "
          f"{bypass.stats.prefill_accesses}")
    if st.prefill_accesses == 0 or bypass.stats.prefill_accesses != 0:
        raise SystemExit("static: the warming replay did not run, or the "
                         "bypass warmed")


def static_oracle(engine):
    """Phase 12b (3): ``collaborative_moe_reference`` (the sequential
    oracle) against probe -> execute -> commit on one cached and one
    uncached layer, 2 tokens of dup-free picks, three rounds each (misses,
    then hits and evictions in a 4-way set), from two fresh tiers over
    phase 4's host tier: hits and cache state exact, the slot buffers
    bitwise, y within phase 5's tolerance (2^-6 of the largest value)."""
    import torch
    from repro_torch.config import CacheConfig
    from repro_torch.core import collaborative as collab
    cfg = engine.cfg
    E, K, T = cfg.moe.num_experts, cfg.moe.top_k, 2
    ccfg = CacheConfig(num_indexes=2, num_ways=4)
    grouped, oracle = (collab.init_tiers(*engine.tiers.host, ccfg,
                                         num_experts=E, device="cuda")
                       for _ in range(2))
    gen = torch.Generator(device="cuda").manual_seed(5)
    perm = torch.Generator().manual_seed(5)
    for layer in (0, LAYERS - 1):
        for rep in range(3):
            x = torch.randn((T, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            top_i = torch.randperm(E, generator=perm)[:T * K].reshape(T, K)
            top_i = top_i.to(torch.int32).cuda()
            top_w = torch.rand((T, K), generator=gen, device="cuda")
            top_w = top_w / top_w.sum(-1, keepdim=True)
            y, grouped, sg = collab.collaborative_moe(grouped, layer, x,
                                                      top_i, top_w, ccfg)
            want, oracle, so = collab.collaborative_moe_reference(
                oracle, layer, x, top_i, top_w, ccfg)
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            tol = 2 ** -6 * want.float().abs().max().item()
            same = all(torch.equal(getattr(grouped.state, k),
                                   getattr(oracle.state, k))
                       for k in ("tags", "age", "clock", "in_flight"))
            slots = all(torch.equal(a, b) for a, b in
                        zip(grouped.slots, oracle.slots))
            print(f"[static] oracle layer {layer} round {rep}: hits "
                  f"{sg['hits']}/{so['hits']}, fetches "
                  f"{sg['fetched_experts']}/{so['fetched_experts']}, state "
                  f"{'equal' if same else 'DIFFERS'}, slots "
                  f"{'equal' if slots else 'DIFFER'}, max_abs_err={err:.6g} "
                  f"tol={tol:.6g}")
            if not (same and slots and err <= tol
                    and bool(torch.isfinite(y).all())
                    and all(sg[k] == so[k] for k in
                            ("hits", "accesses", "host_flops_assignments"))
                    and sg["fetched_experts"] <= so["fetched_experts"]):
                raise SystemExit(f"static: the engine's MoE layer {layer} "
                                 f"disagrees with the sequential oracle")
    del grouped, oracle
    torch.cuda.empty_cache()


def static_trace(params, cfg):
    """Phase 12b (4): a router trace captured from the 4-layer model over
    STATIC's teacher-forced tokens on the card, replayed through the torch
    cache's ``access`` and ``NumpyCache`` (equal hits), then the
    simulator on it and on a synthetic 32-layer trace: cost-model numbers
    of the paper's testbed, not of this card."""
    import numpy as np
    import torch
    from repro_torch.config import CacheConfig
    from repro_torch.core import (NumpyCache, TraceConfig, access,
                                  init_cache_state, synthetic_trace,
                                  trace_stats)
    from repro_torch.core.costmodel import PAPER_TIMINGS
    from repro_torch.core.router_trace import capture_trace
    from repro_torch.core.simulator import best_cache_config, simulate
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, STATIC["trace_tokens"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = capture_trace(cfg, params, tokens)
    torch.cuda.synchronize()
    print(f"[static] captured trace {trace.shape} in "
          f"{time.perf_counter() - t0:.3f} s: {trace_stats(trace)}")
    if trace.shape != (STATIC["trace_tokens"], LAYERS, cfg.moe.top_k) \
            or trace.min() < 0 or trace.max() >= cfg.moe.num_experts:
        raise SystemExit("static: the captured trace is malformed")
    ccfg = CacheConfig(num_indexes=LAYERS, num_ways=2)
    twin = NumpyCache(ccfg, num_experts=cfg.moe.num_experts)
    state, hits = init_cache_state(ccfg), 0
    for t in range(trace.shape[0]):
        for layer in range(LAYERS):
            twin.access(layer, [int(e) for e in trace[t, layer]])
            state, h, _ = access(state, layer,
                                 torch.from_numpy(trace[t, layer]).int(),
                                 "lru")
            hits += int(h.sum())
    print(f"[static] replay N={LAYERS} M=2 lru: torch cache hits {hits}, "
          f"NumpyCache hits {twin.hits} of {twin.accesses}")
    if hits != twin.hits or not np.array_equal(state.tags.numpy(),
                                               twin.tags):
        raise SystemExit("static: the torch cache and NumpyCache disagree "
                         "on the captured trace")
    tm = PAPER_TIMINGS["mixtral-8x7b"]
    synth = synthetic_trace(TraceConfig(num_tokens=STATIC["trace_tokens"],
                                        num_layers=32, num_experts=8))
    cfgs = best_cache_config(tm)
    print(f"[static] paper testbed cost model (AMD 7960X + RTX 4090, PCIe "
          f"4.0 x16; not this card): best_cache_config {cfgs}")
    for label, tr in (("captured", trace), ("synthetic 32-layer", synth)):
        for method in ("ours", "ours_prefetch", "cpu_only", "on_demand",
                       "pregated", "fiddler"):
            for threads in (1, 24):
                r = simulate(tr, tm, threads, method, ccfg=cfgs[4])
                print(f"[static] paper testbed model, {label} trace, "
                      f"{method} {threads} threads: {r.tokens_per_s:.4f} "
                      f"tok/s, hit rate {r.hit_rate:.4f}, "
                      f"{r.joules_per_token:.2f} J/token")
                if not (math.isfinite(r.tokens_per_s) and r.tokens_per_s > 0):
                    raise SystemExit(f"static: simulate {method} failed")


def static_mesh_step():
    """Phase 12b (5): one train step of reduced smollm on the card under
    the host mesh, bitwise equal to the step without a mesh (a second
    run without one says whether the card's step repeats at all)."""
    import torch
    from repro_torch import models
    from repro_torch.config import (OptimizerConfig, ShapeConfig, get_config,
                                    reduced)
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import init_opt_state, make_train_step
    from repro_torch.sharding import use_mesh
    from repro_torch.tree import leaves
    cfg = reduced(get_config("smollm-360m"))
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = {k: torch.as_tensor(v).cuda() for k, v in SyntheticLM(
        cfg, ShapeConfig("t", 64, 2, "train"), seed=0).batch(0).items()}
    outs = []
    for mesh in (None, make_host_mesh(), None):
        params = models.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        step = make_train_step(cfg, ocfg)
        opt = init_opt_state(params)
        if mesh is None:
            p, o, m = step(params, opt, batch)
        else:
            with use_mesh(mesh):
                p, o, m = step(params, opt, batch)
        outs.append([t.detach() for t in leaves(p) + leaves(o)]
                    + [m["loss"], m["grad_norm"]])
    same = [all(torch.equal(a, b) for a, b in zip(outs[0], o))
            for o in outs[1:]]
    print(f"[static] train step under make_host_mesh(): loss "
          f"{float(outs[1][-2]):.6f}, bitwise equal to the step without a "
          f"mesh: {same[0]} (a second step without one: {same[1]})")
    if not same[0]:
        raise SystemExit("static: the size-1 mesh changed the train step")


def static_phase(params, base):
    """Phase 12b: the static-batch path and the paper's tooling on phase
    4's weights. Returns the launch counts of the ``generate`` runs."""
    import torch
    t0 = time.perf_counter()
    engines, launches, prompts = static_generate(params, base)
    static_prefill_request(engines, prompts)
    static_oracle(engines["phase 4"])
    cfg = engines["phase 4"].cfg
    del engines
    torch.cuda.empty_cache()
    static_trace(params, cfg)
    static_mesh_step()
    print(f"[static] phase 12b took {time.perf_counter() - t0:.1f} s")
    return launches


def serve_moe_models():
    """Phase 13: phi35-moe and qwen3-moe-30b-a3b on the collaborative
    engine at their published widths, 4 layers each, seeded random
    weights, phase 4's requests; each model's served MoE layer against
    the dense plain reference (phase 5's check). Each model's pinned host
    tier is released before the next. Returns {arch: launch counts}."""
    import torch
    from repro_torch import build
    from repro_torch.config import get_config

    hi = SERVE["prompt"][1]
    out = {}
    for arch, ways in MOE_MODELS:
        cfg = dataclasses.replace(get_config(arch), num_layers=LAYERS)
        m = cfg.moe
        t0 = time.perf_counter()
        engine, sched = build(
            cfg, cache=dict(num_indexes=2, num_ways=ways, policy="lru"),
            serving=dict(max_batch=SERVE["slots"],
                         capacity=hi + SERVE["new_tokens"] + 1,
                         prefill_chunk=8),
            seed=0, device="cuda")
        torch.cuda.synchronize()
        host_gb = sum(t.numel() * t.element_size()
                      for t in engine.tiers.host) / 1e9
        slot_gb = sum(t.numel() * t.element_size()
                      for t in engine.tiers.slots) / 1e9
        full = get_config(arch).num_layers
        print(f"[{arch}] published widths, num_layers cut {full} -> "
              f"{LAYERS}: d_model={cfg.d_model} heads="
              f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} experts="
              f"{m.num_experts} top{m.top_k} d_ff={m.d_ff} vocab="
              f"{cfg.vocab_size}; cache N=2 M={ways}; host tier "
              f"{host_gb:.2f} GB, slot buffer {slot_gb:.2f} GB, built in "
              f"{time.perf_counter() - t0:.1f} s")
        outs, dt, out[arch] = _serve_requests(sched, cfg.vocab_size)
        st = sched.stats
        total = sum(len(o) for o in outs.values())
        print(f"[{arch}] served {st.requests_finished} requests / {total} "
              f"tokens in {dt:.3f} s ({total / dt:.3f} tok/s wall, "
              f"{st.steps} decode steps); cache hit rate {st.hit_rate:.4f} "
              f"(hits={st.hits} accesses={st.accesses} fetches="
              f"{st.fetched_experts}); tpot_ms p50={st.tpot_ms_p50:.1f}; "
              f"launches {out[arch]}")
        if st.requests_finished != SERVE["requests"]:
            raise SystemExit(f"{arch}: not every request finished")
        for rid, o in outs.items():
            if len(o) != SERVE["new_tokens"] or o.min() < 0 \
                    or o.max() >= cfg.vocab_size:
                raise SystemExit(f"{arch} request {rid}: bad output "
                                 f"{o.tolist()}")
        if st.accesses != st.tokens * m.top_k * cfg.num_layers \
                or st.hits == 0 or st.fetched_experts == 0:
            raise SystemExit(f"{arch}: accesses miscounted, or one tier "
                             f"carried no traffic")
        for name in ("swiglu_gmm", "gmm", "flash_decode"):
            if out[arch][name] <= 0:
                raise SystemExit(f"{arch}: kernel {name} was never "
                                 f"launched")
        check_layer(engine)
        del engine, sched
        _release_host_tier()
        print(f"[{arch}] host tier released: host RSS {_rss_gb():.2f} GB, "
              f"peak {_peak_rss_gb():.2f} GB")
    return out


def _greedy(params, cfg, batch, n: int, capacity: int, label: str):
    """The generic path's timed run: prefill of ``batch`` with room for
    ``capacity`` tokens, then n - 1 greedy decode steps. Prints prefill ms,
    decode ms a step, tok/s, peak device memory and the launch counts;
    fails on tokens outside the vocab, non-finite logits or a wrong
    position. Returns (tokens [B, n] on the host, the last token, the
    state, the launch counts)."""
    import torch
    from repro_torch import kernels, models
    B, S = batch["tokens"].shape
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = models.prefill(params, batch, cfg, capacity=capacity)
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = torch.isfinite(logits).all()
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(n - 1):
        logits, state = models.decode_step(params, state, {"tokens": tok},
                                           cfg)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, 0].argmax(-1)[:, None]
        outs.append(tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    launches = kernels.launches()
    out = torch.cat(outs, dim=1).cpu()
    print(f"[{label}] batch {B} x prompt {S}: prefill {prefill_ms:.3f} ms "
          f"({B * S / prefill_ms * 1e3:.1f} prompt tok/s), decode "
          f"{step_ms:.3f} ms/step ({B / step_ms * 1e3:.3f} tok/s), {n} "
          f"tokens a row; peak HBM "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{launches}; first row {out[0, :8].tolist()}")
    if tuple(out.shape) != (B, n) or out.min() < 0 \
            or out.max() >= cfg.vocab_size or not bool(finite):
        raise SystemExit(f"{label}: tokens outside the vocab or non-finite "
                         f"logits")
    if int(state["pos"]) != S + n - 1:
        raise SystemExit(f"{label}: the state's position is wrong")
    return out, tok, state, launches


def serve_dense():
    """Phase 14: the generic path at mistral-nemo-12b's full published
    size (40 layers, d_model 5120, 32/8 heads of 128, d_ff 14336, vocab
    131072; 12.2 B parameters, bf16 on the card), seeded random weights:
    4 prompts of 1024 tokens, prefill with room for the generated tokens,
    then greedy decode steps through the flash-decode kernel, and where
    four more decode steps' time goes (``torch.profiler``); then prefill
    of S+1 tokens against prefill of S and one decode step. Returns the
    launch counts of the timed run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models
    from repro_torch.config import get_config

    cfg = get_config(DENSE["arch"])
    B, S, n = DENSE["batch"], DENSE["prompt"], DENSE["new_tokens"]
    prof_steps = DENSE["profiled"]
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    count = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    print(f"[dense] {cfg.name} at its published size: layers="
          f"{cfg.num_layers} d_model={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size}: {count / 1e9:.3f} B parameters, {gb:.2f} GB "
          f"on the card, drawn in {time.perf_counter() - t0:.1f} s")
    warm = torch.zeros((1, 64), dtype=torch.long, device="cuda")
    _, st = models.prefill(params, {"tokens": warm}, cfg, capacity=65)
    models.decode_step(params, st, {"tokens": warm[:, :1]}, cfg)
    torch.cuda.synchronize()
    rng = np.random.default_rng(9)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    _, tok, state, launches = _greedy(params, cfg, {"tokens": prompt}, n,
                                      S + n + prof_steps, "dense")
    if launches["flash_decode"] != cfg.num_layers * (n - 1):
        raise SystemExit(f"flash_decode launched {launches['flash_decode']} "
                         f"times, not once per layer and decode step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            logits, state = models.decode_step(params, state,
                                               {"tokens": tok}, cfg)
            tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"[profile] {cfg.name} decode: {prof_steps} steps at batch {B}:")
    _report(prof, wall_ms, prof_steps, "dense decode", "step")
    ops = sum(e.count for e in prof.key_averages() if _device_ms(e) > 0)
    print(f"[profile] dense decode: {ops / prof_steps:.0f} device operations "
          f"a step")
    del state, logits
    toks = prompt[:1, :S // 2 + 1]
    full, _ = models.prefill(params, {"tokens": toks}, cfg)
    _, st = models.prefill(params, {"tokens": toks[:, :-1]}, cfg,
                           capacity=S // 2 + 1)
    step, _ = models.decode_step(params, st, {"tokens": toks[:, -1:]}, cfg)
    # 40 layers, each adding to the residual stream an output within about
    # two bf16 roundings: 2^-4 of the largest logit, as phase 16's
    _close(f"{cfg.name}: prefill {S // 2} then decode vs prefill "
           f"{S // 2 + 1} (logits, {cfg.num_layers} layers)", step[:, 0],
           full[:, 0], 2 ** -4)
    del params, st, full, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_mamba():
    """Phase 15: the generic serve path (``repro_torch.models.prefill`` and
    ``decode_step``, greedy) at mamba2-370m's published widths and all 48
    layers, seeded random weights. Each batch: one prefill through the
    ``ssd_scan`` kernel (one launch per layer), then greedy decode steps
    through the recurrence. Returns (params, cfg, launch counts)."""
    import numpy as np
    import torch
    from repro_torch import kernels, models
    from repro_torch.config import get_config

    cfg = get_config("mamba2-370m")
    s = cfg.ssm
    print(f"[mamba] {cfg.name} at published widths and depth: "
          f"layers={cfg.num_layers} d_model={cfg.d_model} d_inner="
          f"{s.d_inner(cfg.d_model)} heads={s.num_heads(cfg.d_model)}x"
          f"{s.head_dim} d_state={s.d_state} chunk={s.chunk_size} "
          f"vocab={cfg.vocab_size} (tied)")
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size()
             for t in _leaves(params)) / 1e9
    print(f"[mamba] weights {gb:.3f} GB on the card, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    # the first calls pay cuBLAS's and the allocator's set-up
    warm = torch.zeros((1, 64), dtype=torch.long, device="cuda")
    _, st = models.prefill(params, {"tokens": warm}, cfg)
    models.decode_step(params, st, {"tokens": warm[:, :1]}, cfg)
    torch.cuda.synchronize()
    rng = np.random.default_rng(5)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for B, S, n in MAMBA["batches"]:
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = models.prefill(params, {"tokens": prompt}, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        finite = torch.isfinite(logits).all()
        outs = [tok]
        t0 = time.perf_counter()
        for _ in range(n - 1):
            logits, state = models.decode_step(params, state,
                                               {"tokens": tok}, cfg)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, 0].argmax(-1)[:, None]
            outs.append(tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
        out = torch.cat(outs, dim=1).cpu()
        print(f"[mamba] batch {B} x prompt {S}: prefill {prefill_ms:.3f} ms "
              f"({B * S / prefill_ms * 1e3:.1f} prompt tok/s), decode "
              f"{step_ms:.3f} ms/step ({B / step_ms * 1e3:.3f} tok/s), "
              f"{n} tokens a row; first row {out[0, :8].tolist()}")
        if tuple(out.shape) != (B, n) or out.min() < 0 \
                or out.max() >= cfg.vocab_size or not bool(finite):
            raise SystemExit(f"mamba batch {B}x{S}: tokens outside the "
                             f"vocab or non-finite logits")
        if int(state["pos"]) != S + n - 1:
            raise SystemExit("mamba: the state's position is wrong")
    launches = kernels.launches()
    print(f"[mamba] peak HBM {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB; launches {launches}")
    want = cfg.num_layers * len(MAMBA["batches"])
    if launches["ssd_scan"] != want:
        raise SystemExit(f"ssd_scan launched {launches['ssd_scan']} times, "
                         f"not once per layer and prefill ({want})")
    return params, cfg, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _close(what, got, want, rel):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * want.float().abs().max().item()
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol
    print(f"[check] {what}: max_abs_err={err:.6g} tol={tol:.6g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what} disagrees")


def check_mamba(params, cfg):
    """Phase 16: one Mamba layer on the card, at the served shape: the
    layer through the kernel against the same layer through the plain scan
    (``ssd_scan_plain``), and prefill of S+1 tokens against prefill of S
    tokens and one decode step (the kernel's final state and the conv
    state against the recurrence), for the layer and for the whole model."""
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.models import ssm, transformer
    lp = transformer.layer_params(params["scan"]["s0"]["mamba"], 0)
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, S, _ = MAMBA["batches"][0]
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = ssd_scan.launches
    out_k, st_k = ssm.mamba_apply(lp, x, cfg, ssm.init_ssm_state(cfg, B,
                                                                 "cuda"))
    if ssd_scan.launches != before + 1:
        raise SystemExit("the layer did not run the ssd_scan kernel")
    ssm.ssd_scan = ssd_scan_plain            # the same layer, plain scan
    out_p, st_p = ssm.mamba_apply(lp, x, cfg, ssm.init_ssm_state(cfg, B,
                                                                 "cuda"))
    ssm.ssd_scan = ssd_scan
    # y differs by one bf16 rounding, carried through the gated RMSNorm
    # and out_proj; the fp32 state by reordered sums
    _close("mamba_apply prefill: kernel vs plain scan (output)", out_k,
           out_p, 2 ** -6)
    _close("mamba_apply prefill: kernel vs plain scan (ssd state)",
           st_k["ssd"], st_p["ssd"], 2 ** -13)
    if not torch.equal(st_k["conv"], st_p["conv"]):
        raise SystemExit("the conv state depends on the scan")
    S1 = MAMBA["batches"][1][1]               # 1000 + 1: a ragged chunk
    xs = x[:1, :S1 + 1]
    full, _ = ssm.mamba_apply(lp, xs, cfg, ssm.init_ssm_state(cfg, 1, "cuda"))
    _, st = ssm.mamba_apply(lp, xs[:, :-1], cfg,
                            ssm.init_ssm_state(cfg, 1, "cuda"))
    step, _ = ssm.mamba_apply(lp, xs[:, -1:], cfg, st, decode=True)
    # the recurrence against the chunked scan: y within a bf16 rounding,
    # and the projections' GEMMs of 1 and S+1 rows sum in other orders
    _close("mamba_apply: prefill S then decode vs prefill S+1 (last token)",
           step[:, 0], full[:, -1], 2 ** -6)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, S1 + 1)), device="cuda")
    full_logits, _ = models.prefill(params, {"tokens": toks}, cfg)
    _, st = models.prefill(params, {"tokens": toks[:, :-1]}, cfg)
    step_logits, _ = models.decode_step(params, st, {"tokens": toks[:, -1:]},
                                        cfg)
    # 48 layers, each adding to the residual stream an output within about
    # two bf16 roundings: 2^-4 of the largest logit
    _close(f"model: prefill {S1} then decode vs prefill {S1 + 1} (logits, "
           f"{cfg.num_layers} layers)", step_logits[:, 0], full_logits[:, 0],
           2 ** -4)
    same = int(step_logits[0, 0].argmax()) == int(full_logits[0, 0].argmax())
    print(f"[check] model: the greedy token agrees: {same}")


def profile_mamba(params, cfg, steps: int = 4):
    """Phase 17: where a Mamba prefill's (served batch) and a decode
    step's time goes (``torch.profiler``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models
    B, S, _ = MAMBA["batches"][0]
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state = models.prefill(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"[profile] mamba prefill: batch {B} x {S} tokens, "
          f"{cfg.num_layers} layers:")
    _report(prof, wall_ms, 1, "mamba prefill", "prefill")
    tok = logits[:, -1].argmax(-1)[:, None]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state = models.decode_step(params, state,
                                               {"tokens": tok}, cfg)
            tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"[profile] mamba decode: {steps} steps at batch {B}:")
    _report(prof, wall_ms, steps, "mamba decode", "step")
    launches = sum(e.count for e in prof.key_averages()
                   if _device_ms(e) > 0)
    print(f"[profile] mamba decode: {launches / steps:.0f} device "
          f"operations a step")


def serve_mixed(arch, layers, B, S, n, check_len):
    """Phases 18-20: one mixed-period model on the generic path
    (``repro_torch.models.prefill`` with room for the generated tokens,
    then greedy ``decode_step``s), seeded random weights on the card:
    prefill ms, decode ms a step, tok/s, peak device memory; tokens in the
    vocab, finite logits, each attention layer's flash-decode launched once
    a decode step and each Mamba layer's ``ssd_scan`` once a prefill; an
    MoE layer against the dense plain reference; prefill of ``check_len``
    tokens against prefill of one fewer and a decode step. The weights are
    freed before returning the launch counts of the timed run."""
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.config import get_config
    from repro_torch.models import transformer

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(
        full, num_layers=layers)
    cut = "no cut" if layers is None else \
        f"num_layers cut {full.num_layers} -> {layers}"
    slots, G, R = transformer.build_slots(cfg)
    kinds = [s for _, _, _, s in transformer.layer_order(cfg)]
    n_attn = sum(s.kind == "attn" for s in kinds)
    n_mamba = len(kinds) - n_attn
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    count = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    print(f"[{arch}] published widths, {cut}: d_model={cfg.d_model} heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size}; period of {len(slots)} x "
          f"{G} groups + {R} remainder: {n_attn} attention, {n_mamba} Mamba "
          f"layers, windows {[s.window for s in slots]}, MoE slots "
          f"{[j for j, s in enumerate(slots) if s.is_moe]}; "
          f"{count / 1e9:.3f} B parameters, {gb:.2f} GB on the card, drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    if any(t.device.type != "cuda" for t in leaves):
        raise SystemExit(f"{arch}: a weight is not on the card")
    warm = torch.zeros((1, 64), dtype=torch.long, device="cuda")
    _, st = models.prefill(params, {"tokens": warm}, cfg, capacity=65)
    models.decode_step(params, st, {"tokens": warm[:, :1]}, cfg)
    del st
    torch.cuda.synchronize()
    rng = np.random.default_rng(10)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    out, _, state, launches = _greedy(params, cfg, {"tokens": prompt}, n,
                                      S + n, arch)
    if launches["flash_decode"] != n_attn * (n - 1) \
            or launches["ssd_scan"] != n_mamba:
        raise SystemExit(f"{arch}: flash_decode launched "
                         f"{launches['flash_decode']} times (want "
                         f"{n_attn * (n - 1)}), ssd_scan "
                         f"{launches['ssd_scan']} (want {n_mamba})")
    del state
    if any(s.is_moe for s in slots):
        check_moe_layer(params, cfg, B)
    toks = torch.cat([prompt[:1], out[:1, :1].to("cuda")], 1)[:, :check_len]
    full_logits, _ = models.prefill(params, {"tokens": toks}, cfg)
    if check_len - 1 > 1024 and (check_len - 1) % 1024:
        # past 1024 keys the flash scan takes whole 1024-key chunks (the
        # reference asserts as much): the prefix streams as one segment
        # over a cache of check_len keys instead (attention stacks only)
        st = models.init_state(cfg, 1, check_len, "cuda")
        _, st, _ = transformer.backbone(params, toks[:, :-1], cfg, "segment",
                                        state=st)
    else:
        _, st = models.prefill(params, {"tokens": toks[:, :-1]}, cfg,
                               capacity=check_len)
    step, _ = models.decode_step(params, st, {"tokens": toks[:, -1:]}, cfg)
    # every layer adds to the residual stream an output within about two
    # bf16 roundings: 2^-4 of the largest logit, as phases 14 and 16
    _close(f"{arch}: prefill {check_len - 1} then decode vs prefill "
           f"{check_len} (logits, {cfg.num_layers} layers)", step[:, 0],
           full_logits[:, 0], 2 ** -4)
    del params, leaves, st, full_logits, step
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{arch}] weights freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB still allocated")
    return launches


def check_moe_layer(params, cfg, T: int):
    """Phase 20: the generic path's MoE layer (``models.moe.moe_apply``,
    decode-shaped: one flat dispatch group of T tokens, the expert tables
    on the card) against a dense plain reference: every pick through the
    plain SwiGLU with its expert's weights, weighted, plus the shared
    experts, summed in fp32. Within 2^-6 of the largest output, as phase
    13's check."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm_plain, swiglu_gmm_plain
    from repro_torch.models import transformer
    from repro_torch.models.moe import moe_apply, route
    slots = transformer.build_slots(cfg)[0]
    j = next(j for j, s in enumerate(slots) if s.is_moe)
    p = transformer.layer_params(params["scan"][f"s{j}"]["moe"], 0)
    m = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((T, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    y = moe_apply(p, x, m, capacity_factor=m.serve_capacity_factor)[:, 0]
    _, top_i, top_w = route(p["router"], x[:, 0], m.top_k)
    want = torch.zeros((T, cfg.d_model), device="cuda")
    for t in range(T):
        for k in range(m.top_k):
            e = int(top_i[t, k])
            h = swiglu_gmm_plain(x[t][None], p["w1"][e][None],
                                 p["w3"][e][None])
            want[t] += top_w[t, k] * \
                gmm_plain(h, p["w2"][e][None])[0, 0].float()
    if "shared" in p:
        sh = p["shared"]
        h = swiglu_gmm_plain(x[:, 0][None], sh["w1"][None], sh["w3"][None])
        want += gmm_plain(h, sh["w2"][None])[0].float()
    _close(f"{cfg.name}: MoE layer s{j} ({m.num_experts} experts top"
           f"{m.top_k}, {m.num_shared_experts} shared) vs the dense plain "
           f"reference", y, want, 2 ** -6)


def _decode_weight_bytes(params) -> int:
    """Bytes of the weights one decode step reads: every leaf but the
    front end's projection, the encoder's (its memory K/V is computed
    once, at prefill, and so are the cross-attention's K/V projections) and
    an untied embedding table (a step reads B of its rows; the head reads
    ``lm_head`` or, tied, ``embed`` whole)."""
    skip = {"frontend_proj", "enc", "enc_norm"}
    if "lm_head" in params:
        skip.add("embed")

    def walk(tree, path):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        if path[0] in skip or path[-2:] in (("cross", "wk"), ("cross", "wv")):
            return 0
        return tree.numel() * tree.element_size()
    return walk(params, ())


def _grid_positions(B: int, S: int, P: int, grid: int):
    """[3, B, S] M-RoPE ids: P patches on a grid x grid layout at t = 0
    (h = i // grid, w = i % grid), the text after them at t = h = w = its
    index, so a decode step's ``pos`` on all three streams continues it."""
    import torch
    pos = torch.arange(S, device="cuda").expand(3, B, S).clone()
    i = torch.arange(P, device="cuda")
    pos[0, :, :P] = 0
    pos[1, :, :P] = i // grid
    pos[2, :, :P] = i % grid
    return pos


def _serve_front_end(arch: str, batch_of, B: int, S: int, n: int,
                     check_len: int, want_launches):
    """Phases 21-22: one model at its full published size on the generic
    path with its stub front end, seeded random weights on the card:
    prefill of ``batch_of(B, S)`` (tokens and the front end's inputs) with
    room for the generated tokens, then greedy ``decode_step``s; prefill
    ms, decode ms a step, tok/s, peak device memory, the weight-read bound
    of a step and where two more steps' time goes; tokens in the vocab,
    finite logits, ``flash_decode`` launched ``want_launches(cfg, n - 1)``
    times; prefill of ``check_len`` tokens against prefill of one fewer
    and a decode step (the front end's inputs held fixed). Returns (params,
    cfg, batch, launches of the timed run); the caller frees the
    weights."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models
    from repro_torch.config import get_config

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    count = sum(t.numel() for t in leaves)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    step_gb = _decode_weight_bytes(params) / 1e9
    print(f"[{arch}] at its published size, no cut: layers="
          f"{cfg.num_layers} (+ {cfg.encoder_layers} encoder) d_model="
          f"{cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}x"
          f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} front "
          f"end {cfg.frontend_embed_dim}: {count / 1e9:.3f} B parameters, "
          f"{gb:.2f} GB on the card, drawn in "
          f"{time.perf_counter() - t0:.1f} s; a decode step reads "
          f"{step_gb:.3f} GB of weights: bound "
          f"{step_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms")
    if any(t.device.type != "cuda" for t in leaves):
        raise SystemExit(f"{arch}: a weight is not on the card")
    _, st = models.prefill(params, batch_of(1, 64), cfg, capacity=65)
    models.decode_step(params, st, {"tokens": torch.zeros(
        (1, 1), dtype=torch.long, device="cuda")}, cfg)
    del st
    batch = batch_of(B, S)
    _, tok, state, launches = _greedy(params, cfg, batch, n, S + n + 2, arch)
    if launches["flash_decode"] != want_launches(cfg, n - 1) \
            or sum(launches.values()) != launches["flash_decode"]:
        raise SystemExit(f"{arch}: flash_decode launched "
                         f"{launches['flash_decode']} times (want "
                         f"{want_launches(cfg, n - 1)}), other kernels "
                         f"{launches}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            logits, state = models.decode_step(params, state,
                                               {"tokens": tok}, cfg)
            tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report(prof, wall_ms, 2, f"{arch} decode", "step")
    ops = sum(e.count for e in prof.key_averages() if _device_ms(e) > 0)
    print(f"[profile] {arch} decode: {ops / 2:.0f} device operations a step")
    del state, logits
    full = {k: (v[:, :1] if k == "positions" else v[:1])
            for k, v in batch.items()}
    full["tokens"] = full["tokens"][:, :check_len]
    if "positions" in full:
        full["positions"] = full["positions"][..., :check_len]
    short = dict(full, tokens=full["tokens"][:, :-1])
    if "positions" in full:
        short["positions"] = full["positions"][..., :-1]
    full_logits, _ = models.prefill(params, full, cfg)
    _, st = models.prefill(params, short, cfg, capacity=check_len)
    step, _ = models.decode_step(params, st,
                                 {"tokens": full["tokens"][:, -1:]}, cfg)
    # every layer adds to the residual stream an output within about two
    # bf16 roundings: 2^-4 of the largest logit, as phases 14 and 18-20
    _close(f"{arch}: prefill {check_len - 1} then decode vs prefill "
           f"{check_len} (logits, front end's inputs fixed)", step[:, 0],
           full_logits[:, 0], 2 ** -4)
    del st, step
    return params, cfg, full, full_logits, launches


def serve_vlm():
    """Phase 21: qwen2-vl-7b at its full published size (28 layers,
    d_model 3584, 28/4 heads of 128, d_ff 18944, untied vocab 152064, a
    1280 -> 3584 patch projection; 7.62 B parameters, 15.2 GB): 4 prompts
    of 1024 tokens whose first 64 are seeded patch embeddings on an 8 x 8
    grid (M-RoPE positions: t = 0, h, w on the grid; the text at t = h =
    w = its index), 32 greedy tokens through ``flash_decode`` (GQA group
    7); then moving one patch's grid position must move the logits
    (M-RoPE is live). Frees the weights; returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.config import get_config

    V = VLM
    cfg = get_config(V["arch"])

    def batch_of(B, S):
        gen = torch.Generator(device="cuda").manual_seed(12)
        rng = np.random.default_rng(12)
        P = min(V["patches"], S - 1)
        return {"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (B, S)), device="cuda"),
                "patches": torch.randn((B, P, cfg.frontend_embed_dim),
                                       generator=gen, device="cuda"
                                       ).to(torch.bfloat16),
                "positions": _grid_positions(B, S, P, V["grid"])}

    params, cfg, full, full_logits, launches = _serve_front_end(
        V["arch"], batch_of, V["batch"], V["prompt"], V["new_tokens"],
        V["check_len"], lambda c, steps: c.num_layers * steps)
    moved = dict(full, positions=full["positions"].clone())
    moved["positions"][1, :, 5] += 3             # patch 5 three rows down
    moved_logits, _ = models.prefill(params, moved, cfg)
    text_logits, _ = models.prefill(params, {"tokens": full["tokens"]}, cfg)
    d_pos = (moved_logits.float() - full_logits.float()).abs().max().item()
    d_patch = (text_logits.float() - full_logits.float()).abs().max().item()
    print(f"[check] {cfg.name}: one patch's grid position moves the last "
          f"logits by {d_pos:.6g}, the patches (against text embeddings "
          f"at text positions) by {d_patch:.6g} "
          f"{'ok' if d_pos > 0 and d_patch > 0 else 'FAIL'}")
    if not (d_pos > 0 and d_patch > 0):
        raise SystemExit(f"{cfg.name}: M-RoPE or the patch front end is "
                         f"not live")
    del params, full, full_logits, moved_logits, text_logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{cfg.name}] weights freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    return launches


def serve_encdec():
    """Phase 22: seamless-m4t-large-v2 at its full published size (24
    encoder and 24 decoder layers, d_model 1024, 16/16 heads of 64, d_ff
    8192, vocab 256206 tied; 1.77 B parameters): 4 requests of 1024 seeded
    frames and 1024 decoder tokens (the reference's CLI ties both to
    --prompt; 1024 keeps the flash scan's chunks whole), 32 greedy tokens:
    every decoder layer's self- and cross-attention through
    ``flash_decode`` (GQA group 1). The decoder's self KV holds the
    generated tokens too, the memory K/V the 1024 frames alone. Frees the
    weights; returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.config import get_config

    E = ENCDEC
    cfg = get_config(E["arch"])

    def batch_of(B, S):
        gen = torch.Generator(device="cuda").manual_seed(13)
        rng = np.random.default_rng(13)
        Sf = E["frames"] if S == E["prompt"] else S
        return {"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (B, S)), device="cuda"),
                "frames": torch.randn((B, Sf, cfg.frontend_embed_dim),
                                      generator=gen, device="cuda"
                                      ).to(torch.bfloat16)}

    params, cfg, full, full_logits, launches = _serve_front_end(
        E["arch"], batch_of, E["batch"], E["prompt"], E["new_tokens"],
        E["check_len"], lambda c, steps: 2 * c.num_layers * steps)
    del params, full, full_logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{cfg.name}] weights freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    return launches


def _train_args(ckpt_dir: Path, **kw):
    """The trainer's arguments (``repro_torch.launch.train``) for phase 23:
    smollm-360m at its full size (``--full``), 8 x 256 tokens a step."""
    from repro_torch.launch import train
    argv = ["--arch", TRAIN["arch"], "--full", "--steps",
            str(TRAIN["steps"]), "--batch", str(TRAIN["batch"]), "--seq",
            str(TRAIN["seq"]), "--ckpt-dir", str(ckpt_dir), "--device",
            "cuda"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return train.parser().parse_args(argv)


def _train_summary(label: str, out: dict, batch: int, seq: int) -> None:
    steps = sorted(out["history"])
    times = sorted(out["history"][i][4] for i in steps)
    med = times[len(times) // 2]
    print(f"[{label}] {len(steps)} steps of {batch} x {seq}: step "
          f"{med * 1e3:.3f} ms (median; {times[0] * 1e3:.3f}-"
          f"{times[-1] * 1e3:.3f}), {batch * seq / med:.1f} tok/s a step, "
          f"{out['tok_per_s']:.1f} tok/s over the run (checkpoints "
          f"included), peak HBM {out.get('peak_hbm_gb', 0):.2f} GB, "
          f"restarts {out['restarts']}")


def _profile_train(step, params, opt, batches, label: str):
    """Where a train step's time goes (``torch.profiler``): device time by
    kind against the wall, and device operations a step. Returns the
    updated (params, opt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(batches)
    print(f"[profile] {label}: {n} train step(s):")
    _report(prof, wall_ms, n, label, "step")
    ops = sum(e.count for e in prof.key_averages() if _device_ms(e) > 0)
    print(f"[profile] {label}: {ops / n:.0f} device operations a step")
    return params, opt


def train_smollm():
    """Phase 23a: ``repro_torch.launch.train``'s code path at smollm-360m's
    full published size (32 layers, d_model 960, 15/5 heads of 64, d_ff
    2560, tied embeddings; seeded random weights) for 20 steps of 8 x 256
    synthetic tokens, checkpoints every 5 steps and a failure injected at
    step 7 (restored from step 5); then the same run uninterrupted (one
    step-0 checkpoint). Prints every step's loss and grad norm, the step
    time, tok/s, peak HBM and restarts, and the two runs' final losses:
    equal up to the device's reduction order, within 2^-8 relative; then
    where two more steps' time goes."""
    import shutil
    import torch
    from repro_torch.config import OptimizerConfig, ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import make_train_step
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    for label, kw in (("recovered", dict(ckpt_every=TRAIN["ckpt_every"],
                                          inject_failure=TRAIN["failure"])),
                      ("uninterrupted", dict(ckpt_every=10 ** 6))):
        out = train.run(_train_args(root / label, **kw), log_every=1)
        _train_summary(f"train {TRAIN['arch']} {label}", out,
                       TRAIN["batch"], TRAIN["seq"])
        bad = [i for i, h in out["history"].items()
               if not all(map(math.isfinite, h[:4]))]
        if bad or sorted(out["history"]) != list(range(TRAIN["steps"])):
            raise SystemExit(f"train {label}: steps {bad} not finite, or "
                             f"steps missing")
        runs[label] = out
        if label == "uninterrupted":
            cfg, n = out["cfg"], TRAIN["steps"]
            data = SyntheticLM(cfg, ShapeConfig("t", TRAIN["seq"],
                                                TRAIN["batch"], "train"))
            _profile_train(
                make_train_step(cfg, OptimizerConfig(warmup_steps=10,
                                                     total_steps=n)),
                *out["state"], [train.to_device(data.batch(i), "cuda")
                                for i in (n, n + 1)],
                f"train {TRAIN['arch']}")
        del out["state"]
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    last = TRAIN["steps"] - 1
    rec = runs["recovered"]["history"][last][0]
    clean = runs["uninterrupted"]["history"][last][0]
    tol = 2 ** -8 * abs(clean)
    ok = runs["recovered"]["restarts"] == 1 and abs(rec - clean) <= tol
    print(f"[train] final loss (step {last}): recovered {rec:.6f}, "
          f"uninterrupted {clean:.6f}, difference {abs(rec - clean):.3g} "
          f"(tol {tol:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train: the recovered run does not match the "
                         "uninterrupted one")
    first = runs["uninterrupted"]["history"][0][0]
    if not clean < first:
        raise SystemExit(f"train: the loss did not fall ({first:.4f} -> "
                         f"{clean:.4f})")


def train_mixtral():
    """Phase 23b: Mixtral-8x7B at its published widths with ``num_layers``
    cut 32 -> 2 (3.16 B parameters: bf16 weights and gradients, fp32
    master and moments, about 51 GB), every expert table on the card: a
    few train steps of 2 x 256 synthetic tokens through
    ``make_train_step``, with loss, aux, grad norm, step time and peak
    HBM."""
    import torch
    from repro_torch.config import OptimizerConfig, ShapeConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state, make_train_step
    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=MIXTRAL_TRAIN["layers"])
    B, S, n = (MIXTRAL_TRAIN[k] for k in ("batch", "seq", "steps"))
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda", host_experts=False)
    opt = init_opt_state(params)
    print(f"[train mixtral] {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B parameters; weights and "
          f"optimizer state {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    step = make_train_step(cfg, OptimizerConfig(warmup_steps=1,
                                                total_steps=n))
    data = SyntheticLM(cfg, ShapeConfig("t", S, B, "train"), seed=0)
    times = []
    for i in range(n):
        batch = to_device(data.batch(i), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in m.items()}
        print(f"[train mixtral] step {i}: loss {vals['loss']:.4f} xent "
              f"{vals['xent']:.4f} aux {vals['aux']:.4f} gnorm "
              f"{vals['grad_norm']:.3f} in {times[-1] * 1e3:.3f} ms")
        if not all(map(math.isfinite, vals.values())):
            raise SystemExit("train mixtral: non-finite metrics")
    med = sorted(times[1:])[len(times[1:]) // 2]
    print(f"[train mixtral] step {med * 1e3:.3f} ms (median of steps 1-"
          f"{n - 1}), {B * S / med:.1f} tok/s, peak HBM "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    params, opt = _profile_train(step, params, opt,
                                 [to_device(data.batch(n), "cuda")],
                                 "train mixtral")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def check_train_against_cpu():
    """Phase 23c: ``loss_fn`` and every gradient leaf of one reduced config
    a family (dense, MoE, Mamba, a mixed period, vlm, audio) on the card
    against the same function on the CPU, same weights and batch, within
    the CPU tests' tolerances against the compiled reference: the loss
    within 2^-8 relative, each gradient within 2^-4 of its largest
    value."""
    import torch
    from repro_torch import models
    from repro_torch.config import ShapeConfig, get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.tree import leaves, tree_map
    for arch in TRAIN_CHECK:
        cfg = reduced(get_config(arch))
        cpu = models.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", host_experts=False)
        batch = SyntheticLM(cfg, ShapeConfig("t", 80, 2, "train"),
                            seed=0).batch(0)
        out = {}
        for dev, params in (("cpu", cpu),
                            ("cuda", tree_map(lambda t: t.to("cuda"), cpu))):
            ls = leaves(params)
            for t in ls:
                t.requires_grad_(True)
            loss, parts = models.loss_fn(
                params, {k: torch.as_tensor(v).to(dev)
                         for k, v in batch.items()}, cfg)
            grads = torch.autograd.grad(loss, ls, allow_unused=True,
                                        materialize_grads=True)
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
        lerr = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        gerr = max((g.float() - w.float()).abs().max().item()
                   / max(w.float().abs().max().item(), 1e-30)
                   for g, w in zip(out["cuda"][1], out["cpu"][1]))
        ok = lerr <= 2 ** -8 and gerr <= 2 ** -4
        print(f"[train check] {arch}: loss card {out['cuda'][0]:.6f} cpu "
              f"{out['cpu'][0]:.6f} (rel {lerr:.3g}), worst gradient leaf "
              f"rel {gerr:.4f} over {len(out['cpu'][1])} leaves "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"train check {arch}: card and CPU disagree")


def train_phases():
    """Phase 23: training (23a-c) with the kernel launch counts set to 0
    before and read after: a train-mode forward reaches no kernel."""
    from repro_torch import kernels
    kernels.reset_launches()
    train_smollm()
    train_mixtral()
    check_train_against_cpu()
    launches = kernels.launches()
    print(f"[train] kernel launches {launches}")
    if any(launches.values()):
        raise SystemExit("train: a train phase launched a kernel")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild

    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    sources = sorted({k["source"] for k in kernels.ALL})
    kbuild.build(sources)
    print(f"[build] {len(sources)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, log in kbuild.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {src}: {line.strip()}")
    measured = check_kernels(kernels.ALL)
    print(f"[pcie] pinned host->device copy: {h2d_rate_gbps():.2f} GB/s")
    engine, dense_launches, base = serve()
    check_layer(engine)
    profiles = {"dense": profile_decode(engine, "dense")}
    pf_launches, pf_profiles = serve_prefetch(engine.params, base)
    profiles.update(pf_profiles)
    for run, p in profiles.items():
        print(f"[compare] {run}: {p['step_ms']:.3f} ms/step, idle "
              f"{p['idle']:.4f}, host lane {p['host_ms']:.3f} ms/step, "
              + ", ".join(f"{k} {v:.3f}" for k, v in p["streams"].items()))
    traced_launches = serve_traced(engine.params, base)
    paged, paged_launches = serve_paged(engine.params)
    check_attention(paged)
    profile_decode(paged, "paged")
    profile_segment(paged)
    static_launches = static_phase(engine.params, base)
    del engine, paged
    _release_host_tier()
    print(f"[serve] Mixtral's host tier released: host RSS {_rss_gb():.2f} "
          f"GB, peak {_peak_rss_gb():.2f} GB")
    moe_launches = serve_moe_models()
    dense_launches_generic = serve_dense()
    params, cfg, ssm_launches = serve_mamba()
    check_mamba(params, cfg)
    profile_mamba(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mixed_launches = {arch: serve_mixed(arch, layers, B, S, n, check)
                      for arch, layers, B, S, n, check in MIXED}
    vlm_launches = serve_vlm()
    encdec_launches = serve_encdec()
    train_launches = train_phases()
    rows = []
    for k in kernels.ALL:
        name = k["name"]
        by_phase = {"dense": dense_launches[name],
                    "prefetch": pf_launches["prefetch"][name],
                    "host": pf_launches["host"][name],
                    "traced": traced_launches[name],
                    "paged": paged_launches[name],
                    "static": static_launches[name],
                    **{arch: moe_launches[arch][name]
                       for arch, _ in MOE_MODELS},
                    DENSE["arch"]: dense_launches_generic[name],
                    "ssm": ssm_launches[name],
                    **{arch: mixed_launches[arch][name]
                       for arch, *_ in MIXED},
                    VLM["arch"]: vlm_launches[name],
                    ENCDEC["arch"]: encdec_launches[name],
                    "train": train_launches[name]}
        rows.append(dict(
            name=name, route="cuda",
            source=str(Path(k["source"]).relative_to(ROOT)),
            replaces=k["replaces"], launches=sum(by_phase.values()),
            launches_by_phase=by_phase, **measured[name]["served"],
            long=measured[name].get("long"),
            models={label[6:]: m for label, m in measured[name].items()
                    if label.startswith("model:")}))
        if rows[-1]["launches"] <= 0:
            raise SystemExit(f"kernel {name} was launched in no serve "
                             f"phase")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
