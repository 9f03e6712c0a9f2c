"""Decoder-only LM assembly, homogeneous stacks (counterpart of the
reference's ``models/transformer.py``).

Three stacks run here: the attention+MoE stack the collaborative engine
serves, and, on the generic serve path, the attention + dense SwiGLU FFN
stack (smollm, mistral-nemo, qwen2 with its QKV biases) and the
attention-free Mamba2 stack. Any other stack (hybrid, encoder-decoder,
the vlm/audio front ends) raises ``NotImplementedError`` (ROADMAP slice
6).

The parameter tree mirrors the reference's scan-stacked layout: every
per-layer leaf under ``params["scan"]["s0"]`` carries a leading ``[L]``
axis (``moe.w1`` is ``[L, E, D, F]``, ``mamba.in_proj`` ``[L, D, ...]``),
so the weight bridge maps leaf to leaf. The expert tables are the
engine's host tier: they live in host memory (pinned when the model runs
on a GPU); everything else lives on the compute device.

``backbone`` runs the attention stacks in prefill and segment mode (the
MoE stack with the routing trace the cache-warming replay consumes) and
the dense stack also in decode mode, scored by the flash-decode kernel
(the MoE stack's decode step is the engine's,
:mod:`repro_torch.serving.engine`); the Mamba stack runs in prefill and
decode mode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from . import attention as attn
from . import ssm
from .layers import (dense_init, embed_lookup, ffn_apply, logits_from_embed,
                     rmsnorm)
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


def _slot_has_ffn(cfg: ModelConfig, slot: Slot) -> bool:
    return slot.is_moe or cfg.d_ff > 0


def stack_kind(cfg: ModelConfig) -> str:
    """``"moe"`` for a homogeneous attention+MoE stack, ``"dense"`` for a
    homogeneous attention stack with a dense FFN, ``"mamba"`` for an
    attention-free Mamba stack without FFN; raises ``NotImplementedError``
    (naming the ROADMAP slice) for any stack the port cannot run yet."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet (ROADMAP slice 6)")
    if cfg.frontend_embed_dim or cfg.family in ("vlm", "audio"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} front end "
                                  f"is not ported yet (ROADMAP slice 6)")
    slots, _, R = build_slots(cfg)
    if len(slots) == 1 and not R:
        if slots[0].kind == "attn" and slots[0].is_moe:
            return "moe"
        if slots[0].kind == "attn" and cfg.d_ff > 0:
            return "dense"
        if slots[0].kind == "mamba" and not _slot_has_ffn(cfg, slots[0]):
            return "mamba"
    raise NotImplementedError(
        f"{cfg.name}: the port runs homogeneous attention stacks (MoE or "
        f"dense FFN) and attention-free Mamba stacks; this {cfg.family} "
        f"stack (a hybrid or interleaved period) is ROADMAP slice 6")


def homogeneous_slot(cfg: ModelConfig) -> Slot:
    """The one attention+MoE slot of a homogeneous stack; raises otherwise."""
    if stack_kind(cfg) != "moe":
        raise NotImplementedError(
            f"{cfg.name}: the collaborative engine serves homogeneous "
            f"attention+MoE stacks only")
    return build_slots(cfg)[0][0]


def layer_params(lp: Params, layer: int) -> Params:
    """One layer's slice of the scan-stacked tree."""
    return {k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in lp.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Seeded random parameters with the reference's shapes and scales
    (``models/layers.py::_dense_init``: normal / sqrt(fan_in), fan_in the
    leading axis of each unstacked leaf; the expert tables' leading axis is
    E; the Mamba leaves follow :func:`ssm.mamba_params`). ``generator``
    must live on ``device``. Expert tables are drawn on the device one
    expert at a time and copied into host memory, pinned when ``device`` is
    a GPU."""
    kind = stack_kind(cfg)
    dev = torch.device(device)
    L, D = cfg.num_layers, cfg.d_model
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
    if kind == "mamba":
        layers = [ssm.mamba_params(cfg, g, dev) for _ in range(L)]
        params["scan"] = {"s0": {
            "ln1": torch.ones((L, D), device=dev),
            "mamba": {k: torch.stack([lp[k] for lp in layers])
                      for k in layers[0]}}}
        return params
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_p = {"wq": stacked((D, H * hd)), "wk": stacked((D, Hk * hd)),
              "wv": stacked((D, Hk * hd)), "wo": stacked((H * hd, D))}
    if cfg.qkv_bias:
        # the reference's zero-initialized QKV biases
        for name, n in (("bq", H * hd), ("bk", Hk * hd), ("bv", Hk * hd)):
            attn_p[name] = torch.zeros((L, n), dtype=torch.bfloat16,
                                       device=dev)
    layer = {"ln1": torch.ones((L, D), device=dev), "attn": attn_p,
             "ln2": torch.ones((L, D), device=dev)}
    if kind == "dense":
        F = cfg.d_ff
        layer["ffn"] = {"w1": stacked((D, F)), "w3": stacked((D, F)),
                        "w2": stacked((F, D))}
    else:
        E, F = cfg.moe.num_experts, cfg.moe.d_ff
        layer["moe"] = {"router": stacked((D, E), torch.float32),
                        "w1": expert_table((D, F)),
                        "w3": expert_table((D, F)),
                        "w2": expert_table((F, D))}
    params["scan"] = {"s0": layer}
    return params


def init_state(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Params:
    """Decode state: per-layer KV stacked as [L, B, S, Hk, hd], or the
    Mamba state (``conv`` [L, B, K-1, ci] bf16, ``ssd`` [L, B, nh, ds, hp]
    fp32; ``capacity`` unused). The paged pool is the KV state with
    ``(num_pages, page_size)`` in place of ``(batch, capacity)``: pages take
    the batch role, as in the reference's ``init_slots``."""
    if stack_kind(cfg) == "mamba":
        one = ssm.init_ssm_state(cfg, batch, device)
    else:
        one = attn.init_kv_cache(batch, capacity, cfg.num_kv_heads,
                                 cfg.head_dim, device)
    return {"scan": {"s0": {name: t.expand(cfg.num_layers, *t.shape).clone()
                            for name, t in one.items()}},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _embed_inputs(params: Params, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(torch.bfloat16)


def backbone(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
             mode: str = "prefill", want_trace: bool = False,
             state: Optional[Params] = None,
             pages: Optional[torch.Tensor] = None,
             kv_write_min=None, kv_write_max=None
             ) -> Tuple[torch.Tensor, Params, Optional[Params]]:
    """Embedding + all layers + final norm: an attention stack in prefill
    or segment mode (and the dense stack in decode mode), the Mamba stack
    in prefill or decode mode (:func:`_mamba_backbone`).

    Prefill: tokens [B, S]; returns (hidden [B, S, D], decode state with
    the prompt's KV and pos = S, trace). Each layer projects and ropes
    q/k/v once; the cache keeps that K/V.

    Segment (the reference's ``mode="segment"``): tokens [B, C] are one
    prompt segment whose first token sits at ``state["pos"]`` (an int or
    a 0-d tensor); the per-layer KV of ``state`` (dense [L, B, cap, ...]
    or, with ``pages`` [B, max_pages], the paged pool [L, N, ps, ...])
    carries the request's KV so far and takes the segment's own KV IN
    PLACE (paged: only positions in ``[kv_write_min, kv_write_max)``).
    Returns (hidden [B, C, D], state with pos + C, trace).

    Decode (dense stack): tokens [B, 1] at positions ``state["pos"]`` (a
    0-d tensor or [B]); each layer's new K/V lands IN PLACE in slot
    ``min(pos, capacity-1)`` of ``state``'s cache and the flash-decode
    kernel scores it. Returns (hidden [B, 1, D], state with pos + 1, None).

    With ``want_trace`` the trace holds every layer's routing
    ``top_i``/``top_w`` [L, B, S, K] and post-ln2 hidden ``h2``
    [L, B, S, D] under ``trace["scan"]["s0"]``, from the same router
    weights and h2 that the layer's MoE consults."""
    kind = stack_kind(cfg)
    if kind == "mamba":
        return _mamba_backbone(params, tokens, cfg, mode, state)
    if mode not in ("prefill", "segment", "decode"):
        raise NotImplementedError(f"backbone mode {mode!r} is not ported")
    if mode == "decode" and kind == "moe":
        raise NotImplementedError("the attention+MoE stack decodes in the "
                                  "collaborative engine")
    slot = build_slots(cfg)[0][0]
    x = _embed_inputs(params, tokens, cfg)
    B, S = tokens.shape
    if mode == "decode":
        pos = torch.as_tensor(state["pos"], device=x.device)
    else:
        pos = int(state["pos"]) if mode == "segment" else 0
        positions = pos + torch.arange(S, device=x.device)[None]
    lp_all = params["scan"]["s0"]
    kv = state["scan"]["s0"] if mode != "prefill" else None
    ks, vs, tis, tws, h2s = [], [], [], [], []
    for layer in range(cfg.num_layers):
        lp = layer_params(lp_all, layer)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if mode == "prefill":
            o, k, v = attn.prefill_attention(lp["attn"], h, positions, cfg,
                                             slot.window)
            ks.append(k)
            vs.append(v)
        elif mode == "decode":
            st = {"k": kv["k"][layer], "v": kv["v"][layer]}
            o, _ = attn.decode_attention(lp["attn"], h, st, pos, cfg,
                                         slot.window)
        else:
            st = {"k": kv["k"][layer], "v": kv["v"][layer]}
            if pages is not None:
                o, _ = attn.segment_attention_paged(
                    lp["attn"], h, st, pos, positions, pages, cfg,
                    slot.window, kv_write_min, kv_write_max)
            else:
                o, _ = attn.segment_attention(lp["attn"], h, st, pos,
                                              positions, cfg, slot.window)
        x = x + o
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if kind == "dense":
            f = ffn_apply(lp["ffn"], h2)
        else:
            f = moe_apply(lp["moe"], h2, cfg.moe,
                          capacity_factor=cfg.moe.serve_capacity_factor)
        if want_trace and kind == "moe":
            K = cfg.moe.top_k
            _, top_i, top_w = route(lp["moe"]["router"],
                                    h2.reshape(B * S, -1), K)
            tis.append(top_i.reshape(B, S, K))
            tws.append(top_w.reshape(B, S, K))
            h2s.append(h2)
        x = x + f
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        new_state = {"scan": {"s0": {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}},
                     "pos": torch.tensor(S, dtype=torch.int32)}
    elif mode == "decode":
        new_state = {"scan": state["scan"], "pos": state["pos"] + 1}
    else:
        new_state = {"scan": state["scan"],
                     "pos": torch.tensor(pos + S, dtype=torch.int32)}
    trace = None
    if want_trace and kind == "moe":
        trace = {"scan": {"s0": {"top_i": torch.stack(tis),
                                 "top_w": torch.stack(tws),
                                 "h2": torch.stack(h2s)}}}
    return x, new_state, trace


def _mamba_backbone(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                    mode: str, state: Optional[Params]
                    ) -> Tuple[torch.Tensor, Params, None]:
    """The attention-free Mamba stack (the reference's ``_apply_layer``
    mamba branch). Prefill: tokens [B, S], every layer from zero conv and
    SSD state, through the ``ssd_scan`` kernel. Decode: tokens [B, 1] and
    the ``state`` of a prefill or an earlier step, through the recurrence.
    Returns (hidden [B, S, D], new state with pos advanced, no trace)."""
    if mode == "segment":
        raise NotImplementedError(
            "segment-streamed prefill supports attention layers only")
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"backbone mode {mode!r} is not ported")
    x = _embed_inputs(params, tokens, cfg)
    B, S = tokens.shape
    lp_all = params["scan"]["s0"]
    st_all = state["scan"]["s0"] if mode == "decode" else None
    convs, ssds = [], []
    for layer in range(cfg.num_layers):
        lp = layer_params(lp_all, layer)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if mode == "decode":
            st = {"conv": st_all["conv"][layer], "ssd": st_all["ssd"][layer]}
            o, new = ssm.mamba_apply(lp["mamba"], h, cfg, st, decode=True)
        else:
            o, new = ssm.mamba_apply(lp["mamba"], h, cfg,
                                     ssm.init_ssm_state(cfg, B, x.device))
        x = x + o
        convs.append(new["conv"])
        ssds.append(new["ssd"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    pos = state["pos"] + 1 if mode == "decode" else \
        torch.tensor(S, dtype=torch.int32, device=x.device)
    return x, {"scan": {"s0": {"conv": torch.stack(convs),
                               "ssd": torch.stack(ssds)}},
               "pos": pos}, None


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    table = params.get("lm_head", params["embed"])
    return logits_from_embed(table, x, cfg.logit_softcap)
