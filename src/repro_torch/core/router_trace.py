"""Router traces: synthetic generation calibrated to the paper's measured
expert-selection patterns, and capture from a live model (the port's own
copy of the reference's ``core/router_trace.py``).

The paper's Fig. 2 statistics for Mixtral 8x7B on MMLU:
  * Consecutive Tokens Pattern: P(>=1 of top-2 experts repeats from the
    previous token) ~= 0.4-0.6 per layer; among repeating tokens ~23%
    also share an expert with t-2 and ~18% with t-3+.
  * Consecutive Layers Pattern: ~44% of routers pick at least one expert
    id equal to the previous layer's pick.

The synthetic generator is a per-layer sticky-categorical process: each
of the K slots keeps its previous expert with prob ``stickiness``,
otherwise resamples from a Zipf-skewed popularity distribution (dup-free
within a token). ``layer_corr`` biases the resample toward the previous
layer's picks, reproducing the layer pattern. :func:`synthetic_trace` and
:func:`trace_stats` are numpy and draw exactly the reference's numbers
from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class TraceConfig:
    num_tokens: int
    num_layers: int
    num_experts: int
    top_k: int = 2
    # For E=8, K=2 the *random* consecutive-token overlap is already
    # 1 - C(6,2)/C(8,2) = 0.46; the paper's 40-60% band therefore implies
    # mild stickiness on top of chance overlap.
    stickiness: float = 0.10
    zipf_s: float = 0.30
    layer_corr: float = 0.15
    seed: int = 0


def synthetic_trace(tc: TraceConfig) -> np.ndarray:
    """Returns expert selections [num_tokens, num_layers, top_k] int64."""
    rng = np.random.default_rng(tc.seed)
    E, K, L, T = tc.num_experts, tc.top_k, tc.num_layers, tc.num_tokens
    # per-layer popularity (mild Zipf, randomly permuted per layer)
    base = (1.0 / np.arange(1, E + 1) ** tc.zipf_s)
    pops = np.stack([rng.permutation(base) for _ in range(L)])
    pops /= pops.sum(axis=1, keepdims=True)

    trace = np.zeros((T, L, K), np.int64)
    prev_tok = np.zeros((L, K), np.int64)
    for l in range(L):
        prev_tok[l] = rng.choice(E, size=K, replace=False, p=pops[l])
    trace[0] = prev_tok

    for t in range(1, T):
        prev_layer_pick: Optional[np.ndarray] = None
        for l in range(L):
            picked = []
            for k in range(K):
                keep = rng.random() < tc.stickiness
                e = prev_tok[l, k]
                if not keep or e in picked:
                    p = pops[l].copy()
                    if prev_layer_pick is not None \
                            and rng.random() < tc.layer_corr:
                        p[prev_layer_pick] += 2.0 / E
                    if picked:
                        p[np.array(picked)] = 0.0
                    p /= p.sum()
                    e = rng.choice(E, p=p)
                picked.append(int(e))
            prev_tok[l] = picked
            prev_layer_pick = np.array(picked)
            trace[t, l] = picked
    return trace


def trace_stats(trace: np.ndarray) -> dict:
    """Measured pattern statistics (compare to the paper's Fig. 2 bands)."""
    T, L, K = trace.shape
    tok_repeat = np.zeros(L)
    layer_repeat = 0.0
    for l in range(L):
        a, b = trace[:-1, l, :], trace[1:, l, :]
        share = (a[:, :, None] == b[:, None, :]).any(axis=(1, 2))
        tok_repeat[l] = share.mean()
        if l > 0:
            c, d = trace[:, l - 1, :], trace[:, l, :]
            layer_repeat += (c[:, :, None] == d[:, None, :]).any(
                axis=(1, 2)).mean()

    # persistence among repeating tokens (paper: "share at least one
    # expert with the previous two/three tokens" = a common expert across
    # the run)
    def common(*offsets):
        # exists e present in trace[t - o] for every offset o
        base = max(offsets)
        sets = [trace[base - o: T - o] for o in offsets]   # [T', L, K]
        out = np.zeros(sets[0].shape[:2], bool)
        for k in range(K):
            e = sets[0][:, :, k:k + 1]                      # [T', L, 1]
            ok = np.ones_like(out)
            for s in sets[1:]:
                ok &= (s == e).any(axis=2)
            out |= ok
        return out
    rep = common(0, 1)
    run3 = common(0, 1, 2)
    run4 = common(0, 1, 2, 3)
    n = min(len(rep), len(run3), len(run4))
    rep, run3, run4 = rep[-n:], run3[-n:], run4[-n:]
    p2 = (rep & run3).sum() / max(rep.sum(), 1)
    p3 = (rep & run4).sum() / max(rep.sum(), 1)
    return {
        "consec_token_repeat_mean": float(tok_repeat.mean()),
        "consec_token_repeat_min": float(tok_repeat.min()),
        "consec_token_repeat_max": float(tok_repeat.max()),
        "consec_layer_repeat": float(layer_repeat / (L - 1)),
        "persist_t2_given_repeat": float(p2),
        "persist_t3_given_repeat": float(p3),
    }


def capture_trace(cfg, params, tokens, top_k: Optional[int] = None
                  ) -> np.ndarray:
    """Capture real router decisions from a model, teacher-forced.

    Runs the stack over ``tokens`` [B, S] layer by layer in train mode
    (no remat, no gradient: no kernel runs) on the parameters' device and
    records each MoE layer's top-``top_k`` picks for batch row 0, as the
    reference's ``capture_trace`` does: the router reads ``ln2`` of the
    layer's INPUT residual, and only the period-stacked layers
    (``params["scan"]``) run, a remainder's none. Interleaved stacks
    (jamba, llama4) record their MoE layers only. Returns [S, L_moe, K]
    int64."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.moe import route

    slots, G, _ = transformer.build_slots(cfg)
    K = top_k or cfg.moe.top_k
    device = params["embed"].device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=device)
    B, S = tokens.shape
    picks = []
    with torch.no_grad():
        x = transformer._embed_inputs(params, tokens, cfg)
        positions = transformer._positions(None, cfg, S, B, device)
        per_slot = [transformer.unstack(params["scan"][f"s{j}"], G)
                    for j in range(len(slots))]
        aux = torch.zeros((), dtype=torch.float32, device=device)
        for g in range(G):
            for j, slot in enumerate(slots):
                lp = per_slot[j][g]
                if slot.is_moe:
                    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
                    _, top_i, _ = route(lp["moe"]["router"], h[0].float(), K)
                    picks.append(top_i.to("cpu", torch.int64).numpy())
                x, aux = transformer._train_layer(lp, x, aux, slot, cfg,
                                                  positions)
    # [L_moe, S, K] -> [S, L_moe, K]
    return np.stack(picks).transpose(1, 0, 2)
