"""Encoder-decoder assembly, the seamless-m4t family (counterpart of the
reference's ``models/encdec.py``).

The speech front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``frames [B, S_enc, frontend_embed_dim]``
through ``frontend_proj``, then bidirectional self-attention layers (roped,
unmasked) and ``enc_norm``. The decoder's layers run causal
self-attention, then ``ln_x`` and cross-attention over the encoder memory
(no RoPE), then the dense SwiGLU FFN; the logits are the tied embedding's.

The trees are the reference's: parameters ``frontend_proj``, ``embed``,
``enc`` and ``dec`` (every leaf stacked on a leading [L]), ``enc_norm``,
``final_norm``; the decode state ``kv`` {"k", "v"} [L, B, S, Hk, hd] (the
decoder's self-attention), ``memory_kv`` [L, B, S_enc, Hk, hd] (each
layer's cross-attention K/V, computed once at prefill) and ``pos``. A
prefill's ``kv`` holds the prompt's S slots, as the reference's does: a
decode step past them writes slot S-1 again
(:func:`repro_torch.models.model.prefill` takes ``capacity=`` to widen
it). A decode step scores both attentions with the flash-decode kernel.
Train mode (:func:`encode` and :func:`decode_stack` with ``"train"``)
runs the flash scan with its VJP and checkpoints each layer with
``remat``, as the reference's ``jax.checkpoint`` around its scan bodies.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from . import attention as attn
from .layers import (dense_init, embed_lookup, ffn_apply, frontend_project,
                     logits_from_embed, rmsnorm)
from .transformer import attn_params, ffn_params, layer_params, unstack

Params = Dict[str, Any]


def _enc_layer_params(cfg: ModelConfig, n: int, g: torch.Generator,
                      dev) -> Params:
    """n encoder layers stacked on [n]: the reference's
    ``_enc_layer_params`` shapes and scales (no QKV biases)."""
    D = cfg.d_model
    return {"ln1": torch.ones((n, D), device=dev),
            "attn": attn_params(cfg, n, g, dev),
            "ln2": torch.ones((n, D), device=dev),
            "ffn": ffn_params(D, cfg.d_ff, n, g, dev)}


def _dec_layer_params(cfg: ModelConfig, n: int, g: torch.Generator,
                      dev) -> Params:
    """An encoder layer plus ``ln_x`` and the ``cross`` projections."""
    p = _enc_layer_params(cfg, n, g, dev)
    p["ln_x"] = torch.ones((n, cfg.d_model), device=dev)
    p["cross"] = attn_params(cfg, n, g, dev)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Seeded random parameters with the reference's tree, shapes and
    scales (not its bits). ``generator`` must live on ``device``."""
    dev = torch.device(device)
    g = generator
    D = cfg.d_model
    embed = torch.randn((cfg.vocab_size, D), generator=g, device=dev)
    return {"frontend_proj": dense_init((cfg.frontend_embed_dim, D), g, dev),
            "embed": (embed * D ** -0.5).to(torch.bfloat16),
            "enc": _enc_layer_params(cfg, cfg.encoder_layers, g, dev),
            "dec": _dec_layer_params(cfg, cfg.num_layers, g, dev),
            "enc_norm": torch.ones(D, device=dev),
            "final_norm": torch.ones(D, device=dev)}


def _enc_layer(lp: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    o, _, _ = attn.prefill_attention(lp["attn"], h, positions, cfg,
                                     causal=False)
    x = x + o
    return x + ffn_apply(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           remat: bool = False) -> torch.Tensor:
    """frames [B, S_enc, F] -> encoder memory [B, S_enc, D]: the front
    end's projection rounded to bf16, then each layer's roped
    bidirectional self-attention and FFN, then ``enc_norm``. ``remat``
    (training) checkpoints each layer."""
    x = frontend_project(frames, params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for lp in unstack(params["enc"], cfg.encoder_layers):
        if remat:
            x = checkpoint(_enc_layer, lp, x, positions, cfg,
                           use_reentrant=False)
        else:
            x = _enc_layer(lp, x, positions, cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp: Params, x: torch.Tensor, positions, cfg: ModelConfig,
               mode: str, st: Optional[Params], pos, mem_kv: Params):
    """One decoder layer. Prefill (and train) returns the layer's roped
    self-attention K/V; decode writes the new token's into ``st`` in
    place (None)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    new = None
    if mode == "decode":
        o, _ = attn.decode_attention(lp["attn"], h, st, pos, cfg)
    else:
        o, k, v = attn.prefill_attention(lp["attn"], h, positions, cfg)
        new = {"k": k, "v": v}
    x = x + o
    h = rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    x = x + attn.cross_attention(lp["cross"], h, mem_kv)
    x = x + ffn_apply(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, new


def _train_dec_layer(lp: Params, x: torch.Tensor, positions,
                     cfg: ModelConfig, mem_kv: Params) -> torch.Tensor:
    return _dec_layer(lp, x, positions, cfg, "train", None, None, mem_kv)[0]


def decode_stack(params: Params, tokens: torch.Tensor,
                 memory: Optional[torch.Tensor], cfg: ModelConfig,
                 mode: str, state: Optional[Params] = None,
                 remat: bool = True
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The decoder over its self-attention and the encoder memory.

    Prefill: tokens [B, S] and ``memory`` [B, S_enc, D]; every layer's
    cross K/V is projected from the memory, and the state holds it with
    the prompt's self-attention K/V, pos = S. Decode: tokens [B, 1] at
    ``state["pos"]``; the state's ``memory_kv`` is reused and each layer's
    new K/V lands IN PLACE in slot ``min(pos, S-1)`` of ``state["kv"]``.
    Train: as prefill, the cross K/V projected from ``memory`` inside the
    graph (outside the checkpoints, as the reference's), each layer
    checkpointed with ``remat``, and no state (None).
    Returns (hidden [B, S, D] after ``final_norm``, new state)."""
    if mode not in ("prefill", "decode", "train"):
        raise NotImplementedError(f"encoder-decoder mode {mode!r} is not "
                                  f"ported")
    x = embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    S = tokens.shape[1]
    L = cfg.num_layers
    if mode == "train":
        positions = torch.arange(S, device=x.device)[None]
        layers = unstack(params["dec"], L)
        mem_kvs = [attn.encode_memory_kv(lp["cross"], memory,
                                         cfg.num_kv_heads, cfg.head_dim)
                   for lp in layers]
        for lp, mkv in zip(layers, mem_kvs):
            if remat:
                x = checkpoint(_train_dec_layer, lp, x, positions, cfg, mkv,
                               use_reentrant=False)
            else:
                x = _train_dec_layer(lp, x, positions, cfg, mkv)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), None
    if mode == "decode":
        pos = torch.as_tensor(state["pos"], device=x.device)
        positions = None
        mem_kv = state["memory_kv"]
    else:
        pos = None
        positions = torch.arange(S, device=x.device)[None]
        kvs = [attn.encode_memory_kv(layer_params(params["dec"], l)["cross"],
                                     memory, cfg.num_kv_heads, cfg.head_dim)
               for l in range(L)]
        mem_kv = {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}
    new = []
    for l in range(L):
        st = layer_params(state["kv"], l) if mode == "decode" else None
        x, kv = _dec_layer(layer_params(params["dec"], l), x, positions, cfg,
                           mode, st, pos, layer_params(mem_kv, l))
        new.append(kv)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "decode":
        return x, {"kv": state["kv"], "memory_kv": mem_kv,
                   "pos": state["pos"] + 1}
    kv = {n: torch.stack([d[n] for d in new]) for n in ("k", "v")}
    return x, {"kv": kv, "memory_kv": mem_kv,
               "pos": torch.tensor(S, dtype=torch.int32)}


def init_state(cfg: ModelConfig, batch: int, capacity: int, mem_len: int,
               device=None) -> Params:
    """A zero decode state: ``kv`` [L, B, capacity, Hk, hd], ``memory_kv``
    [L, B, mem_len, Hk, hd], both bf16, and pos 0."""
    def zeros(n):
        return torch.zeros((cfg.num_layers, batch, n, cfg.num_kv_heads,
                            cfg.head_dim), dtype=torch.bfloat16,
                           device=device)
    return {"kv": {"k": zeros(capacity), "v": zeros(capacity)},
            "memory_kv": {"k": zeros(mem_len), "v": zeros(mem_len)},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    return logits_from_embed(params["embed"], x, cfg.logit_softcap)
