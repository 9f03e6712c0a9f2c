"""Decoder-only MoE LM assembly, homogeneous stacks (counterpart of the
reference's ``models/transformer.py``).

The parameter tree mirrors the reference's scan-stacked layout: every
per-layer leaf under ``params["scan"]["s0"]`` carries a leading ``[L]``
axis (``moe.w1`` is ``[L, E, D, F]``), so the weight bridge maps leaf to
leaf. The expert tables are the engine's host tier: they live in host
memory (pinned when the model runs on a GPU); everything else lives on the
compute device.

Only what serving runs is here: ``backbone`` in prefill mode (with the
routing trace the cache-warming replay consumes) and ``lm_logits``. The
decode step is the engine's (:mod:`repro_torch.serving.engine`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from . import attention as attn
from .layers import dense_init, embed_lookup, logits_from_embed, rmsnorm
from .moe import moe_apply, route

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Slot:
    kind: str        # "attn" | "mamba"
    is_moe: bool
    window: int      # -1 = global


def build_slots(cfg: ModelConfig) -> Tuple[List[Slot], int, int]:
    """Returns (period slots, num scanned groups, num remainder layers)."""
    p = len(cfg.layer_pattern)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe_every)
    if cfg.window_pattern:
        p = math.lcm(p, len(cfg.window_pattern))
    p = min(p, cfg.num_layers)
    slots = [Slot(cfg.layer_kind(i), cfg.is_moe_layer(i),
                  cfg.window_for_layer(i)) for i in range(p)]
    return slots, cfg.num_layers // p, cfg.num_layers % p


def homogeneous_slot(cfg: ModelConfig) -> Slot:
    """The one attention+MoE slot of a homogeneous stack; raises otherwise."""
    slots, _, R = build_slots(cfg)
    if len(slots) != 1 or R or slots[0].kind != "attn" \
            or not slots[0].is_moe or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the port serves homogeneous attention+MoE stacks "
            f"only")
    return slots[0]


def layer_params(lp: Params, layer: int) -> Params:
    """One layer's slice of the scan-stacked tree."""
    return {k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in lp.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Seeded random parameters with the reference's shapes and scales
    (``models/layers.py::_dense_init``: normal / sqrt(fan_in), fan_in the
    leading axis of each unstacked leaf; the expert tables' leading axis is
    E). ``generator`` must live on ``device``. Expert tables are drawn on
    the device one expert at a time and copied into host memory, pinned
    when ``device`` is a GPU."""
    homogeneous_slot(cfg)
    dev = torch.device(device)
    L, D = cfg.num_layers, cfg.d_model
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E, F = cfg.moe.num_experts, cfg.moe.d_ff
    g = generator

    def stacked(shape, dtype=torch.bfloat16):
        return torch.stack([dense_init(shape, g, dev, dtype=dtype)
                            for _ in range(L)])

    def embed():
        w = torch.randn((cfg.vocab_size, D), generator=g, device=dev)
        return (w * D ** -0.5).to(torch.bfloat16)

    def expert_table(shape):
        host = torch.empty((L, E) + shape, dtype=torch.bfloat16,
                           pin_memory=dev.type == "cuda")
        for l in range(L):
            for e in range(E):
                w = torch.randn(shape, generator=g, device=dev)
                host[l, e].copy_((w / math.sqrt(E)).to(torch.bfloat16))
        return host

    params: Params = {"embed": embed(),
                      "final_norm": torch.ones(D, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed()
    params["scan"] = {"s0": {
        "ln1": torch.ones((L, D), device=dev),
        "attn": {"wq": stacked((D, H * hd)), "wk": stacked((D, Hk * hd)),
                 "wv": stacked((D, Hk * hd)), "wo": stacked((H * hd, D))},
        "ln2": torch.ones((L, D), device=dev),
        "moe": {"router": stacked((D, E), torch.float32),
                "w1": expert_table((D, F)), "w3": expert_table((D, F)),
                "w2": expert_table((F, D))},
    }}
    return params


def init_state(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Params:
    """Dense decode state: per-layer KV stacked as [L, B, S, Hk, hd]."""
    homogeneous_slot(cfg)
    one = attn.init_kv_cache(batch, capacity, cfg.num_kv_heads,
                             cfg.head_dim, device)
    return {"scan": {"s0": {name: t.expand(cfg.num_layers, *t.shape).clone()
                            for name, t in one.items()}},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _embed_inputs(params: Params, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(torch.bfloat16)


def backbone(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
             mode: str = "prefill", want_trace: bool = False
             ) -> Tuple[torch.Tensor, Params, Optional[Params]]:
    """Prefill forward: embedding + all layers + final norm.

    tokens [B, S]. Returns (hidden [B, S, D], decode state with the
    prompt's KV and pos = S, trace). With ``want_trace`` the trace holds
    every layer's routing ``top_i``/``top_w`` [L, B, S, K] and post-ln2
    hidden ``h2`` [L, B, S, D] under ``trace["scan"]["s0"]``, from the same
    router weights and h2 that the layer's MoE consults."""
    if mode != "prefill":
        raise NotImplementedError(f"backbone mode {mode!r} is not ported "
                                  f"(decode runs in the engine)")
    slot = homogeneous_slot(cfg)
    x = _embed_inputs(params, tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None]
    K = cfg.moe.top_k
    lp_all = params["scan"]["s0"]
    ks, vs, tis, tws, h2s = [], [], [], [], []
    for layer in range(cfg.num_layers):
        lp = layer_params(lp_all, layer)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        o = attn.self_attention(lp["attn"], h, positions, cfg, slot.window)
        q, k, v = attn._project_qkv(lp["attn"], h, cfg)
        _, k = attn._rope_qk(q, k, positions, cfg)
        ks.append(k)
        vs.append(v)
        x = x + o
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        f = moe_apply(lp["moe"], h2, cfg.moe,
                      capacity_factor=cfg.moe.serve_capacity_factor)
        if want_trace:
            _, top_i, top_w = route(lp["moe"]["router"],
                                    h2.reshape(B * S, -1), K)
            tis.append(top_i.reshape(B, S, K))
            tws.append(top_w.reshape(B, S, K))
            h2s.append(h2)
        x = x + f
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    state = {"scan": {"s0": {"k": torch.stack(ks), "v": torch.stack(vs)}},
             "pos": torch.tensor(S, dtype=torch.int32)}
    trace = None
    if want_trace:
        trace = {"scan": {"s0": {"top_i": torch.stack(tis),
                                 "top_w": torch.stack(tws),
                                 "h2": torch.stack(h2s)}}}
    return x, state, trace


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    table = params.get("lm_head", params["embed"])
    return logits_from_embed(table, x, cfg.logit_softcap)
