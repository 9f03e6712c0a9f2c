#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout; one GPU

Phases, in order; any failure exits non-zero:
  1. the card (``nvidia-smi`` name and power limit) and the versions;
  2. build every kernel of the serving path from ``src/repro_torch/**/csrc``
     (one ``nvcc`` per source, all started together) into ``build/``;
  3. each kernel against its plain PyTorch version at the decode path's
     shapes (G = 8 groups, C = 8 rows, D = 4096, F = 14336) and at ragged
     shapes, with the tolerance printed; times of the kernel, the plain
     version and (for ``gmm``) ``torch.bmm``, beside the kernel's bound;
  4. serve 6 greedy requests through ``repro_torch.build`` at
     Mixtral-8x7B's published widths (d_model 4096, 32/8 heads of 128,
     8 experts top-2 of d_ff 14336, vocab 32000). The one cut: 4 layers
     of 32, so the pinned host tier holds 32 experts (11.3 GB). Cache
     N = 2, M = 2, lru (4 slots, 1.41 GB of HBM): layers 2-3 are
     uncached, so both tiers carry traffic. Weights are random, seeded;
  5. the served MoE layer against a dense plain reference on the card,
     for a cached and an uncached layer;
  6. where a decode step's time goes: ``torch.profiler`` over a few decode
     steps at 4 slots, device time by kernel and copy against wall time;
  7. the ``kernels`` line (launch counts from the serve phase alone) and
     the result line.
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

DECODE_SHAPE = (8, 8, 4096, 14336)          # G, C, D, F on the decode path
RAGGED_SHAPES = [(3, 5, 200, 100), (2, 13, 1000, 1000), (1, 3, 36, 52)]
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                         # dense bf16 tensor-core peak
LAYERS = 4
SERVE = dict(requests=6, prompt=(16, 32), new_tokens=16, slots=4)


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


def kernel_inputs(name, shape, gen):
    import torch
    G, C, D, F = shape
    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(
            torch.bfloat16)
    if name == "swiglu_gmm":
        return (rnd(G, C, D), rnd(G, D, F, scale=0.02),
                rnd(G, D, F, scale=0.02))
    return (rnd(G, C, F), rnd(G, F, D, scale=0.02))     # the down-projection


def bound(name, inputs, out):
    """Least time for the work: each input read once, the output written
    once, over HBM; the flops over the bf16 peak. Returns (ms, by)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + \
        out.numel() * out.element_size()
    G, C, K = inputs[0].shape
    N = inputs[1].shape[2]
    flops = 2 * G * C * K * N * (2 if name == "swiglu_gmm" else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels(kernels):
    """Each kernel vs its plain version; returns {name: measurements}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for k in kernels:
        name, wrapper, plain = k["name"], k["wrapper"], k["plain"]
        for shape in [DECODE_SHAPE] + RAGGED_SHAPES:
            inputs = kernel_inputs(name, shape, gen)
            got = wrapper(*inputs)
            torch.cuda.synchronize()
            want = plain(*inputs)
            err = (got.float() - want.float()).abs().max().item()
            # same products, other fp32 summation order: one bf16 rounding
            tol = 2 ** -7 * want.float().abs().max().item() + 1e-3
            ok = bool(torch.isfinite(got.float()).all()) and err <= tol
            print(f"[kernel] {name} G,C,D,F={shape}: max_abs_err={err:.6g} "
                  f"tol={tol:.6g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at {shape}")
            if shape == DECODE_SHAPE:
                ms = time_ms(lambda: wrapper(*inputs))
                plain_ms = time_ms(lambda: plain(*inputs), iters=3)
                lib_ms = None
                if name == "gmm":
                    lib_ms = time_ms(lambda: torch.bmm(*inputs))
                bound_ms, by = bound(name, inputs, got)
                results[name] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=by, library_ms=lib_ms)
                print(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.4f} "
                      f"ms, library {lib_ms} ms, bound {bound_ms:.4f} ms by "
                      f"{by}: {100 * bound_ms / ms:.1f}% of roofline)")
            del inputs, got, want
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
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"kernel {name} was never launched while "
                             f"serving")
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


def profile_decode(engine, steps: int = 4):
    """Phase 6: where a decode step's time goes. Four requests decode
    together (no admission in the window); ``torch.profiler`` sums the
    device time by kernel and copy, against the window's wall time."""
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
    rows = [(e.key, _device_ms(e), e.count)
            for e in prof.key_averages() if _device_ms(e) > 0]
    busy = sum(ms for _, ms, _ in rows)
    groups = {"host->device copy": ("HtoD",), "device->host copy": ("DtoH",),
              "device copy": ("DtoD",), "grouped expert kernels":
              ("grouped_kernel",), "gemm (attention, router, logits)":
              ("gemm", "gemv", "nvjet", "xmma", "cutlass")}
    by = {g: 0.0 for g in groups}
    for key, ms, _ in rows:
        for g, marks in groups.items():
            if any(m in key for m in marks):
                by[g] += ms
                break
    by["other"] = busy - sum(by.values())
    print(f"[profile] {steps} decode steps at {SERVE['slots']} slots: wall "
          f"{wall_ms:.3f} ms ({wall_ms / steps:.3f} ms/step), device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}")
    for g, ms in by.items():
        print(f"[profile]   {g}: {ms:.3f} ms ({ms / steps:.3f} ms/step, "
              f"{100 * ms / wall_ms:.1f}% of wall)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"[profile]   top: {ms:.3f} ms in {n} calls: {key[:90]}")
    if busy <= 0:
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")


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
    engine, launches, served = serve()
    check_layer(engine)
    profile_decode(engine)
    rows = []
    for k in kernels.ALL:
        rows.append(dict(
            name=k["name"], route="cuda",
            source=str(Path(k["source"]).relative_to(ROOT)),
            replaces=k["replaces"], launches=launches[k["name"]],
            **measured[k["name"]]))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
