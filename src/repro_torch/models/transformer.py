"""Decoder-only LM assembly with period-stacked heterogeneous layers
(counterpart of the reference's ``models/transformer.py``).

An architecture repeats a *period* of P layer slots (P = lcm of the
attention/Mamba interleave, the MoE interleave and the sliding-window
pattern: 1 for llama-likes and Mamba2, 6 for gemma3, 8 for jamba, 2 for
llama4): ``G = L // P`` groups of the period, then the ``L % P``
remainder layers. Each slot is attention or Mamba, then a dense SwiGLU
FFN, the MoE or nothing (:func:`_slot_has_ffn`), with its own window.
The vlm family (qwen2-vl) is such a stack with multimodal RoPE and a stub
patch front end: precomputed patch embeddings through ``frontend_proj``
replace the first prompt embeddings, and ``positions`` [3, B, S] carry
the (temporal, height, width) ids. Encoder-decoder models are
:mod:`repro_torch.models.encdec`'s.

The parameter tree mirrors the reference's: slot j of the period under
``params["scan"]["s{j}"]``, every leaf with a leading ``[G]`` axis
(``moe.w1`` is ``[G, E, D, F]``, ``mamba.in_proj`` ``[G, D, ...]``), the
remainder under ``params["rem"]["r{j}"]`` without it, so the weight bridge
maps leaf to leaf. The decode state mirrors the same layout (attention KV,
Mamba ``conv``/``ssd`` per slot).

Where the expert tables live: the homogeneous attention+MoE stack
(:func:`stack_kind` ``"moe"``: one slot, no remainder) is the
collaborative engine's, and its tables are the engine's host tier, in host
memory (pinned when the model runs on a GPU). Every other stack runs on
the generic path, which has no tier to page experts through, so its
tables live on the compute device with every other leaf, as the
reference's generic path holds them.

``backbone`` runs any stack in prefill, decode and train mode, and the
attention stacks in segment mode (the engine's MoE stack with the routing
trace the cache-warming replay consumes); the homogeneous MoE stack's
decode step is the engine's (:mod:`repro_torch.serving.engine`). Train
mode reaches no kernel: it picks the differentiable functions by mode.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from . import attention as attn
from . import ssm
from .layers import (dense_init, embed_lookup, ffn_apply, frontend_project,
                     logits_from_embed, rmsnorm)
from .moe import moe_apply, moe_train, route

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
    """``"moe"`` for the homogeneous attention+MoE stack the collaborative
    engine serves (one slot, no remainder), ``"dense"`` for a stack of
    attention layers with dense FFNs (any window pattern), ``"mamba"`` for
    an attention-free Mamba stack without FFN, ``"mixed"`` for any other
    period (hybrid attention/Mamba, interleaved MoE), ``"encdec"`` for an
    encoder-decoder model (:mod:`repro_torch.models.encdec`, not this
    module's stack)."""
    if cfg.is_encdec:
        return "encdec"
    slots, _, R = build_slots(cfg)
    if len(slots) == 1 and not R and slots[0].kind == "attn" \
            and slots[0].is_moe:
        return "moe"
    if all(s.kind == "attn" and not s.is_moe for s in slots) and cfg.d_ff:
        return "dense"
    if all(s.kind == "mamba" and not _slot_has_ffn(cfg, s) for s in slots):
        return "mamba"
    return "mixed"


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


def layer_order(cfg: ModelConfig) -> Iterator[Tuple[str, str, Optional[int],
                                                Slot]]:
    """Every layer in order: (tree, key, group or None, slot). Group g's
    slots run before group g + 1's; the remainder runs last."""
    slots, G, R = build_slots(cfg)
    for g in range(G):
        for j, slot in enumerate(slots):
            yield "scan", f"s{j}", g, slot
    for j in range(R):
        yield "rem", f"r{j}", None, slots[j % len(slots)]


def _at(tree: Params, g: Optional[int]) -> Params:
    return tree if g is None else layer_params(tree, g)


def unstack(tree: Params, n: int) -> List[Params]:
    """The n layers of a tree stacked on a leading [n] axis, as n trees of
    views (``torch.unbind``: one backward node a leaf, which stacks the n
    layers' gradients once)."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
        for i in range(n):
            out[i][k] = parts[i]
    return out


# -- parameters --------------------------------------------------------------

def stacked_init(shape, n: int, g: torch.Generator, dev,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """n draws of :func:`dense_init` stacked on a leading [n] axis."""
    return torch.stack([dense_init(shape, g, dev, dtype=dtype)
                        for _ in range(n)])


def attn_params(cfg: ModelConfig, n: int, g: torch.Generator, dev,
                qkv_bias: bool = False) -> Params:
    """n layers' q/k/v/o projections stacked on [n] (the reference's
    ``attn_params``), with its zero-initialized QKV biases if asked."""
    D, H, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = {"wq": stacked_init((D, H * hd), n, g, dev),
         "wk": stacked_init((D, Hk * hd), n, g, dev),
         "wv": stacked_init((D, Hk * hd), n, g, dev),
         "wo": stacked_init((H * hd, D), n, g, dev)}
    if qkv_bias:
        for name, w in (("bq", H * hd), ("bk", Hk * hd), ("bv", Hk * hd)):
            a[name] = torch.zeros((n, w), dtype=torch.bfloat16, device=dev)
    return a


def ffn_params(D: int, F: int, n: int, g: torch.Generator, dev) -> Params:
    """n layers' dense SwiGLU FFN (w1, w3 [D, F], w2 [F, D]) on [n]."""
    return {"w1": stacked_init((D, F), n, g, dev),
            "w3": stacked_init((D, F), n, g, dev),
            "w2": stacked_init((F, D), n, g, dev)}


def _slot_params(cfg: ModelConfig, slot: Slot, n: int, g: torch.Generator,
                 dev: torch.device, host_experts: bool) -> Params:
    """n layers of one slot, every leaf stacked on a leading [n] axis, with
    the reference's shapes and scales (``_layer_params``). A leaf is drawn
    for all n layers before the next leaf. Expert tables are drawn on
    ``dev`` one expert at a time; with ``host_experts`` they land in host
    memory, pinned when ``dev`` is a GPU."""
    D = cfg.d_model

    def expert_table(shape):
        out = torch.empty((n, E) + shape, dtype=torch.bfloat16,
                          device="cpu" if host_experts else dev,
                          pin_memory=host_experts and dev.type == "cuda")
        for l in range(n):
            for e in range(E):
                w = torch.randn(shape, generator=g, device=dev)
                out[l, e].copy_((w / math.sqrt(E)).to(torch.bfloat16))
        return out

    layer: Params = {"ln1": torch.ones((n, D), device=dev)}
    if slot.kind == "attn":
        layer["attn"] = attn_params(cfg, n, g, dev, cfg.qkv_bias)
    else:
        layers = [ssm.mamba_params(cfg, g, dev) for _ in range(n)]
        layer["mamba"] = {k: torch.stack([lp[k] for lp in layers])
                          for k in layers[0]}
    if _slot_has_ffn(cfg, slot):
        layer["ln2"] = torch.ones((n, D), device=dev)
        if slot.is_moe:
            m = cfg.moe
            E, F = m.num_experts, m.d_ff
            layer["moe"] = {"router": stacked_init((D, E), n, g, dev,
                                                   torch.float32),
                            "w1": expert_table((D, F)),
                            "w3": expert_table((D, F)),
                            "w2": expert_table((F, D))}
            if m.num_shared_experts:
                layer["moe"]["shared"] = ffn_params(
                    D, F * m.num_shared_experts, n, g, dev)
        else:
            layer["ffn"] = ffn_params(D, cfg.d_ff, n, g, dev)
    return layer


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", host_experts: Optional[bool] = None
                ) -> Params:
    """Seeded random parameters with the reference's tree, shapes and
    scales (``models/layers.py::_dense_init``: normal / sqrt(fan_in),
    fan_in the leading axis of each unstacked leaf; the expert tables'
    leading axis is E; the Mamba leaves follow :func:`ssm.mamba_params`).
    A front end adds ``frontend_proj`` [frontend_embed_dim, D].
    ``generator`` must live on ``device``. The homogeneous MoE stack's
    expert tables are the engine's host tier (host memory, pinned on a
    GPU) unless ``host_experts`` is False (training: every leaf on the
    device); every other leaf, and every other stack's tables, live on
    ``device``. Where they land moves no draw."""
    kind = _decoder_only(cfg)
    dev = torch.device(device)
    D = cfg.d_model
    g = generator
    slots, G, R = build_slots(cfg)
    host = kind == "moe" if host_experts is None else host_experts

    def embed():
        w = torch.randn((cfg.vocab_size, D), generator=g, device=dev)
        return (w * D ** -0.5).to(torch.bfloat16)

    params: Params = {"embed": embed(),
                      "final_norm": torch.ones(D, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed()
    if cfg.frontend_embed_dim:
        params["frontend_proj"] = dense_init((cfg.frontend_embed_dim, D), g,
                                             dev)
    params["scan"] = {f"s{j}": _slot_params(cfg, slot, G, g, dev, host)
                      for j, slot in enumerate(slots)}
    if R:
        params["rem"] = {f"r{j}": layer_params(_slot_params(
            cfg, slots[j % len(slots)], 1, g, dev, host), 0)
            for j in range(R)}
    return params


# -- decode state ------------------------------------------------------------

def _layer_state(cfg: ModelConfig, slot: Slot, batch: int, capacity: int,
                 device) -> Params:
    if slot.kind == "attn":
        return attn.init_kv_cache(batch, capacity, cfg.num_kv_heads,
                                  cfg.head_dim, device)
    return ssm.init_ssm_state(cfg, batch, device)


def init_state(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Params:
    """Decode state mirroring the scan/rem parameter tree: an attention
    slot's KV stacked as [G, B, S, Hk, hd], a Mamba slot's ``conv``
    [G, B, K-1, ci] bf16 and ``ssd`` [G, B, nh, ds, hp] fp32 (``capacity``
    unused); remainder layers without the [G] axis. The paged pool is the
    KV state with ``(num_pages, page_size)`` in place of ``(batch,
    capacity)``: pages take the batch role, as in the reference's
    ``init_slots``."""
    slots, G, R = build_slots(cfg)
    state: Params = {"scan": {}, "pos": torch.zeros(
        (), dtype=torch.int32, device=device)}
    for j, slot in enumerate(slots):
        one = _layer_state(cfg, slot, batch, capacity, device)
        state["scan"][f"s{j}"] = {name: t.expand(G, *t.shape).clone()
                                  for name, t in one.items()}
    if R:
        state["rem"] = {f"r{j}": _layer_state(cfg, slots[j % len(slots)],
                                              batch, capacity, device)
                        for j in range(R)}
    return state


# -- layers and the backbone -------------------------------------------------

def _decoder_only(cfg: ModelConfig) -> str:
    """:func:`stack_kind` of a stack this module runs; raises for an
    encoder-decoder model."""
    kind = stack_kind(cfg)
    if kind == "encdec":
        raise ValueError(f"{cfg.name}: an encoder-decoder model runs in "
                         f"repro_torch.models.encdec")
    return kind


def _embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings; with the vlm front end's ``patches`` [B, P, F]
    (prefill; decode steps are text) and S > P, the first P rows are the
    patches through ``frontend_proj``, rounded to bf16."""
    x = embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    if cfg.family == "vlm" and patches is not None \
            and x.shape[1] > patches.shape[1]:
        pe = frontend_project(patches.to(x.device), params["frontend_proj"])
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    if cfg.name.startswith("gemma"):
        # the reference's rounding point: the scale itself is bf16 first
        # (sqrt(2560) = 50.596 becomes 50.5), then one bf16 product
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _apply_layer(lp: Params, x: torch.Tensor, slot: Slot, cfg: ModelConfig,
                 mode: str, st: Optional[Params], pos, positions,
                 pages=None, kv_write_min=None, kv_write_max=None,
                 want_trace: bool = False, experts=None
                 ) -> Tuple[torch.Tensor, Optional[Params],
                            Optional[Params]]:
    """One layer (the reference's ``_apply_layer``): attention or Mamba,
    then the dense FFN, the MoE or nothing. Returns (x, new state, trace):
    the new state is the prefill's KV or Mamba state, a decode step's
    Mamba state, or None where the layer wrote its KV into ``st`` in
    place (decode and segment attention); the trace (MoE slots with
    ``want_trace``) holds the routing ``top_i``/``top_w`` [B, S, K] and
    the post-ln2 hidden ``h2`` [B, S, D] from the same router weights and
    h2 that the layer's MoE consults. ``experts``: the MoE's source of
    its expert table (:func:`moe_apply`), None for the layer's own."""
    B, S = x.shape[:2]
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    new = None
    if slot.kind == "attn":
        if mode == "prefill":
            o, k, v = attn.prefill_attention(lp["attn"], h, positions, cfg,
                                             slot.window)
            new = {"k": k, "v": v}
        elif mode == "decode":
            o, _ = attn.decode_attention(lp["attn"], h, st, pos, cfg,
                                         slot.window)
        elif pages is not None:
            o, _ = attn.segment_attention_paged(
                lp["attn"], h, st, pos, positions, pages, cfg, slot.window,
                kv_write_min, kv_write_max)
        else:
            o, _ = attn.segment_attention(lp["attn"], h, st, pos, positions,
                                          cfg, slot.window)
    elif mode == "decode":
        o, new = ssm.mamba_apply(lp["mamba"], h, cfg, st, decode=True)
    else:
        o, new = ssm.mamba_apply(lp["mamba"], h, cfg,
                                 ssm.init_ssm_state(cfg, B, x.device))
    x = x + o
    trace = None
    if _slot_has_ffn(cfg, slot):
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if slot.is_moe:
            f = moe_apply(lp["moe"], h2, cfg.moe,
                          capacity_factor=cfg.moe.serve_capacity_factor,
                          experts=experts)
            if want_trace:
                K = cfg.moe.top_k
                _, top_i, top_w = route(lp["moe"]["router"],
                                        h2.reshape(B * S, -1), K)
                trace = {"top_i": top_i.reshape(B, S, K),
                         "top_w": top_w.reshape(B, S, K), "h2": h2}
        else:
            f = ffn_apply(lp["ffn"], h2)
        x = x + f
    return x, new, trace


def _train_layer(lp: Params, x: torch.Tensor, aux: torch.Tensor,
                 slot: Slot, cfg: ModelConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer in train mode (the reference's ``_apply_layer`` with
    ``mode="train"``): differentiable functions only, chosen here by
    mode. Attention runs the flash scan with its VJP, Mamba the plain
    chunked scan, the MoE :func:`moe_train`, whose load-balance loss adds
    to ``aux``. Returns (x, aux)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if slot.kind == "attn":
        o, _, _ = attn.prefill_attention(lp["attn"], h, positions, cfg,
                                         slot.window)
    else:
        o, _ = ssm.mamba_apply(lp["mamba"], h, cfg, train=True)
    x = x + o
    if _slot_has_ffn(cfg, slot):
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if slot.is_moe:
            f, a = moe_train(lp["moe"], h2, cfg.moe)
            aux = aux + a
        else:
            f = ffn_apply(lp["ffn"], h2)
        x = x + f
    return x, aux


def _train_backbone(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                    patches: Optional[torch.Tensor],
                    positions: Optional[torch.Tensor], remat: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train mode of :func:`backbone`: (hidden after the final norm, the
    sum of the layers' load-balance losses, fp32). With ``remat`` each
    layer group runs under ``torch.utils.checkpoint`` (non-reentrant), as
    the reference's ``jax.checkpoint`` around its scan body, and, when
    the period has more than one slot, each layer inside it again (the
    reference's nested remat: the group's backward then keeps one layer's
    internals at a time, not the whole period's). Remainder layers run
    without, as the reference's."""
    x = _embed_inputs(params, tokens, cfg, patches)
    B, S = tokens.shape
    positions = _positions(positions, cfg, S, B, x.device)
    slots, G, R = build_slots(cfg)
    nested = remat and len(slots) > 1

    def group(x, aux, lps):
        for slot, lp in zip(slots, lps):
            if nested:
                x, aux = checkpoint(_train_layer, lp, x, aux, slot, cfg,
                                    positions, use_reentrant=False)
            else:
                x, aux = _train_layer(lp, x, aux, slot, cfg, positions)
        return x, aux

    per_slot = [unstack(params["scan"][f"s{j}"], G)
                for j in range(len(slots))]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(G):
        lps = [layers[g] for layers in per_slot]
        if remat:
            x, aux = checkpoint(group, x, aux, lps, use_reentrant=False)
        else:
            x, aux = group(x, aux, lps)
    for j in range(R):
        x, aux = _train_layer(params["rem"][f"r{j}"], x, aux,
                              slots[j % len(slots)], cfg, positions)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _positions(given: Optional[torch.Tensor], cfg: ModelConfig, S: int,
               B: int, device, start: int = 0) -> torch.Tensor:
    """Rotary positions of S tokens from ``start``: [1, S], or under M-RoPE
    ``given`` [3, B, S] (prefill) or else t = h = w = the text position,
    [3, B, S]."""
    if cfg.mrope and given is not None:
        return given.to(device)
    p = start + torch.arange(S, device=device)[None]
    return p.expand(B, S)[None].expand(3, B, S) if cfg.mrope else p


def _collect(tree: Params, where: Tuple[str, str, Optional[int]],
             value: Params) -> None:
    """Files one layer's state or trace under tree[scan|rem][key]: a list
    a scan slot (stacked on [G] afterwards), the value itself a remainder
    layer."""
    kind, key, g = where
    if g is None:
        tree.setdefault(kind, {})[key] = value
    else:
        tree.setdefault(kind, {}).setdefault(key, []).append(value)


def _stacked(tree: Params) -> Params:
    """Every scan slot's list of per-layer dicts stacked on a leading [G]."""
    out = {}
    for kind, slots in tree.items():
        out[kind] = {key: ({name: torch.stack([d[name] for d in v])
                            for name in v[0]} if isinstance(v, list) else v)
                     for key, v in slots.items()}
    return out


def backbone(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
             mode: str = "prefill", want_trace: bool = False,
             state: Optional[Params] = None,
             pages: Optional[torch.Tensor] = None,
             kv_write_min=None, kv_write_max=None,
             patches: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             remat: bool = True,
             expert_source: Optional[Callable[[int], Tuple]] = None):
    """Embedding + all layers in order + final norm.

    Train (every stack): tokens [B, S], with the vlm family's ``patches``
    and ``positions`` as at prefill; returns (hidden [B, S, D], None,
    aux): no state, and the sum of the MoE layers' load-balance losses
    (fp32, 0 without MoE) in the last place. ``remat`` checkpoints each
    layer group (:func:`_train_backbone`); the other modes ignore it.

    Prefill: tokens [B, S]; returns (hidden [B, S, D], decode state with
    the prompt's KV and every Mamba layer's state, pos = S, trace). Each
    attention layer projects and ropes q/k/v once; the cache keeps that
    K/V. A Mamba layer starts from zero conv and SSD state and scans
    through the ``ssd_scan`` kernel. The vlm family takes ``patches``
    [B, P, F] (:func:`_embed_inputs`) and, under M-RoPE, ``positions``
    [3, B, S] (:func:`_positions`); other modes ignore both.

    Segment (the reference's ``mode="segment"``, attention layers only):
    tokens [B, C] are one prompt segment whose first token sits at
    ``state["pos"]`` (an int or a 0-d tensor); the per-layer KV of
    ``state`` (dense [G, B, cap, ...] or, with ``pages`` [B, max_pages],
    the paged pool [G, N, ps, ...]) carries the request's KV so far and
    takes the segment's own KV IN PLACE (paged: only positions in
    ``[kv_write_min, kv_write_max)``). Returns (hidden [B, C, D], state
    with pos + C, trace).

    Decode (every stack but the engine's homogeneous MoE stack): tokens
    [B, 1] at positions ``state["pos"]`` (a 0-d tensor or [B]); each
    attention layer's new K/V lands IN PLACE in slot ``min(pos,
    capacity-1)`` of ``state``'s cache and the flash-decode kernel scores
    it with the layer's window; each Mamba layer steps its recurrence
    into a new state. Returns (hidden [B, 1, D], state with pos + 1,
    None).

    With ``want_trace`` (prefill and segment) the trace mirrors the
    scan/rem tree for the MoE slots: ``trace["scan"]["s{j}"]`` holds
    ``top_i``/``top_w`` [G, B, S, K] and ``h2`` [G, B, S, D] (remainder
    MoE layers under ``trace["rem"]`` without the [G] axis).

    ``expert_source`` (prefill, segment, decode), a callable from a
    layer's index in :func:`layer_order` to its expert table (w1, w3,
    w2) on the compute device, is where each MoE layer reads its experts
    (the engine's cache-aware source); without it each reads its own
    tables."""
    kind = _decoder_only(cfg)
    if mode == "train":
        x, aux = _train_backbone(params, tokens, cfg, patches, positions,
                                 remat)
        return x, None, aux
    if mode not in ("prefill", "segment", "decode"):
        raise NotImplementedError(f"backbone mode {mode!r} is not ported")
    if mode == "decode" and kind == "moe":
        raise NotImplementedError("the attention+MoE stack decodes in the "
                                  "collaborative engine")
    if mode == "segment" and any(s.kind == "mamba"
                                 for s in build_slots(cfg)[0]):
        raise NotImplementedError(
            "segment-streamed prefill supports attention layers only")
    want_trace = want_trace and mode != "decode"
    x = _embed_inputs(params, tokens, cfg,
                      patches if mode == "prefill" else None)
    B, S = tokens.shape
    if mode == "decode":
        pos = torch.as_tensor(state["pos"], device=x.device)
        positions = None
    elif mode == "segment":
        pos = int(state["pos"])
        positions = _positions(None, cfg, S, B, x.device, pos)
    else:
        pos = 0
        positions = _positions(positions, cfg, S, B, x.device)
    new_states: Params = {}
    traces: Params = {}
    for i, (kind_, key, g, slot) in enumerate(layer_order(cfg)):
        lp = _at(params[kind_][key], g)
        st = _at(state[kind_][key], g) if mode != "prefill" else None
        experts = None if expert_source is None else \
            functools.partial(expert_source, i)
        x, new, tr = _apply_layer(lp, x, slot, cfg, mode, st, pos,
                                  positions, pages, kv_write_min,
                                  kv_write_max, want_trace, experts)
        if new is not None:
            _collect(new_states, (kind_, key, g), new)
        if tr is not None:
            _collect(traces, (kind_, key, g), tr)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        new_state = _stacked(new_states)
        new_state["pos"] = torch.tensor(S, dtype=torch.int32)
    else:
        # the attention slots' KV was written in place; a decode step's
        # Mamba slots carry new states
        new_state = {k: dict(v) for k, v in state.items() if k != "pos"}
        for k, v in _stacked(new_states).items():
            new_state[k].update(v)
        new_state["pos"] = state["pos"] + 1 if mode == "decode" else \
            torch.tensor(pos + S, dtype=torch.int32)
    trace = _stacked(traces) if want_trace else None
    return x, new_state, trace


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    table = params.get("lm_head", params["embed"])
    return logits_from_embed(table, x, cfg.logit_softcap)
