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
     (bitwise); at the served and long shapes the times of the
     kernel (events around the wrapper call, and the profiler's device
     time alone), the plain version and the library yardstick (if any),
     beside the bound its inputs give;
  4. serve 6 greedy requests through ``repro_torch.build`` at
     Mixtral-8x7B's published widths (d_model 4096, 32/8 heads of 128,
     8 experts top-2 of d_ff 14336, vocab 32000), dense KV. The one cut: 4
     layers of 32, so the pinned host tier holds 32 experts (11.3 GB).
     Cache N = 2, M = 2, lru (4 slots, 1.41 GB of HBM): layers 2-3 are
     uncached, so both tiers carry traffic. Weights are random, seeded;
  5. the served MoE layer against a dense plain reference on the card,
     for a cached and an uncached layer;
  6. where a dense decode step's time goes (``torch.profiler``);
  7. serve 7 requests of 40-96 tokens (3 opening with one 64-token
     prefix) plus one fork on the paged-KV + segment-streamed path (page
     size 16, 32-token segments, one per tick, prefix retention 8), same
     model and weights; checks tokens, counters, prefix hits, copy-on-
     write, the fork child against its parent and the page accounting;
  8. the attention layer functions on the card: paged decode against
     dense decode over the same KV in permuted pages, paged segment
     (kernel) against the dense segment (plain flash scan);
  9. where a paged decode step's time goes;
 10. where a segment-streamed prefill's time goes;
 11. serve mamba2-370m on the generic path (``repro_torch.models.prefill``
     and ``decode_step``, greedy) at its published widths and all 48
     layers, seeded random weights: 4 prompts of 2048 tokens with 64
     generated tokens, then 1 prompt of 1000 (a ragged chunk) with 16;
     every prefill runs the ``ssd_scan`` kernel once per layer;
 12. one Mamba layer on the card: through the kernel against through the
     plain scan; prefill of S+1 tokens against prefill of S and a decode
     step, for the layer and for the 48-layer model;
 13. where a Mamba prefill's and a decode step's time goes;
 14. the ``kernels`` line (launch counts from the serve phases alone, by
     phase and summed) and the result line.
Prints nothing of the result when no GPU is present.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                         # dense bf16 tensor-core peak
LAYERS = 4
SERVE = dict(requests=6, prompt=(16, 32), new_tokens=16, slots=4)
# phase 7: the paged-KV + segment-streamed path. Prompts of 40-96 tokens,
# three of them opening with one 64-token prefix (4 full pages of 16)
PAGED = dict(page_size=16, segment=32, keep_pages=8, slots=4, prompt=(40, 96),
             new_tokens=16, prefix=64, requests=7, shared=(0, 4, 5))
# phase 11: mamba2-370m's generic path, (batch, prompt, generated tokens):
# the served batch, and one prompt with a 232-token ragged chunk
MAMBA = dict(batches=((4, 2048, 64), (1, 1000, 16)))


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
            if label in ("served", "long"):
                ms = time_ms(lambda: wrapper(*args))
                dev_ms = device_ms(lambda: wrapper(*args))
                plain_ms = time_ms(lambda: plain(*args), iters=3)
                lib = k["library"](args) if k["library"] else None
                lib_ms = time_ms(lib) if lib is not None else None
                bound_ms, by = bound(*k["work"](args, got))
                results.setdefault(name, {})[label] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                    device_ms=dev_ms)
                print(f"[kernel] {name} {label}: {ms:.4f} ms, device "
                      f"{dev_ms} ms (plain "
                      f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
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


def serve():
    """Phase 4: the port's main path at Mixtral's full widths."""
    import numpy as np
    import torch
    from repro_torch import build, kernels
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=LAYERS)
    print(f"[serve] {cfg.name} at published widths, num_layers cut 32 -> "
          f"{LAYERS}: d_model={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads}x{cfg.head_dim} experts={cfg.moe.num_experts} "
          f"top{cfg.moe.top_k} d_ff={cfg.moe.d_ff} vocab={cfg.vocab_size}")
    lo, hi = SERVE["prompt"]
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
    rng = np.random.default_rng(0)
    for _ in range(SERVE["requests"]):
        plen = int(rng.integers(lo, hi + 1))
        sched.submit(rng.integers(0, cfg.vocab_size, plen),
                     max_new_tokens=SERVE["new_tokens"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launches()
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
    return engine, launches, dict(tok_s=total / dt, seconds=dt)


def check_layer(engine):
    """Phase 5: one served MoE layer (tiers + kernels) against a dense
    plain reference with the host-tier weights, cached and uncached."""
    import torch
    from repro_torch.core import collaborative as collab
    from repro_torch.kernels.moe_gmm import gmm_plain, swiglu_gmm_plain
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
        want = torch.zeros((T, cfg.d_model), device="cuda")
        for t in range(T):
            for k in range(K):
                e = int(top_i[t, k])
                w1, w3, w2 = (h[layer, e].to("cuda")[None]
                              for h in engine.tiers.host)
                h = swiglu_gmm_plain(x[t][None, None], w1, w3)
                want[t] += top_w[t, k] * gmm_plain(h, w2)[0, 0].float()
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
    """Phases 6 and 9: where a decode step's time goes. Four requests
    decode together (no admission in the window); ``torch.profiler`` sums
    the device time by kernel and copy, against the window's wall time.
    A fresh scheduler re-initializes the engine's slots (and page pool)."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"[profile] {label}: {steps} decode steps at {SERVE['slots']} "
          f"slots:")
    _report(prof, wall_ms, steps, label, "step")


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


def profile_segment(engine, segments: int = 2):
    """Phase 10: where a segment-streamed prefill's time goes. One
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
    """Phase 7: the paged-KV + segment-streamed path at Mixtral's widths
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
    """Phase 8: the layer-level attention functions on the card, kernel
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


def serve_mamba():
    """Phase 11: the generic serve path (``repro_torch.models.prefill`` and
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
    """Phase 12: one Mamba layer on the card, at the served shape: the
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
    """Phase 13: where a Mamba prefill's (served batch) and a decode
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
    engine, dense_launches, _ = serve()
    check_layer(engine)
    profile_decode(engine, "dense")
    paged, paged_launches = serve_paged(engine.params)
    check_attention(paged)
    profile_decode(paged, "paged")
    profile_segment(paged)
    del engine, paged
    torch.cuda.empty_cache()
    params, cfg, ssm_launches = serve_mamba()
    check_mamba(params, cfg)
    profile_mamba(params, cfg)
    rows = []
    for k in kernels.ALL:
        name = k["name"]
        by_phase = {"dense": dense_launches[name],
                    "paged": paged_launches[name],
                    "ssm": ssm_launches[name]}
        rows.append(dict(
            name=name, route="cuda",
            source=str(Path(k["source"]).relative_to(ROOT)),
            replaces=k["replaces"], launches=sum(by_phase.values()),
            launches_by_phase=by_phase, **measured[name]["served"],
            long=measured[name].get("long")))
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
