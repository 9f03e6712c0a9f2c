"""Model API: init, the training loss, prefill and decode step
(counterpart of the reference's ``models/model.py``).

    loss, {"xent", "aux"} = loss_fn(params, batch, cfg)
    logits, state = prefill(params, {"tokens": tokens}, cfg)
    logits, state = decode_step(params, state, {"tokens": next_tok}, cfg)

The same signatures as the reference's, dispatching on ``cfg.is_encdec``
as it does. They serve every stack the reference's generic path serves:
dense-FFN attention stacks with any window pattern (gemma3's 5:1), the
vlm family's multimodal RoPE with its patch front end (qwen2-vl), the
Mamba2 stack, hybrid attention/Mamba periods with MoE (jamba),
interleaved MoE with a shared expert (llama4), and the encoder-decoder
stack with its audio front end (seamless-m4t,
:mod:`repro_torch.models.encdec`). The decode step of the attention+MoE
stack is the collaborative engine's (:mod:`repro_torch.serving.engine`).

Batch layout: ``tokens`` [B, S] (the decoder's, encoder-decoder); at
prefill and in training, the audio family's ``frames`` [B, S_enc, F], the
vlm family's ``patches`` [B, P, F] (the stub front ends' embeddings) and
``positions`` [3, B, S] (M-RoPE; text positions when absent); in training
``labels`` [B, S].
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from . import encdec, transformer

__all__ = ["decode_step", "init_params", "init_state", "loss_fn", "prefill"]

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", host_experts: Optional[bool] = None
                ) -> Params:
    """Seeded random parameters with the reference's tree
    (:func:`encdec.init_params` or :func:`transformer.init_params`;
    ``host_experts=False`` keeps the engine stack's expert tables on
    ``device``, for training)."""
    if cfg.is_encdec:
        return encdec.init_params(cfg, generator, device)
    return transformer.init_params(cfg, generator, device, host_experts)


# -- the loss (chunked over the sequence to bound the logits) ----------------

def _xent_chunked(params: Params, x: torch.Tensor, labels: torch.Tensor,
                  cfg: ModelConfig, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross entropy, the logits ``chunk`` positions at a
    time, each chunk checkpointed (the reference's ``_xent_chunked``):
    fp32 logits, log-sum-exp minus the target logit taken by a masked
    reduction over the vocabulary, summed chunk by chunk in fp32. As the
    reference's, it counts only the first ``S // chunk * chunk``
    positions: past ``chunk`` tokens, the tail of a sequence that is no
    whole number of chunks drops out."""
    B, S, D = x.shape
    lm = encdec.lm_logits if cfg.is_encdec else transformer.lm_logits
    chunk = min(chunk, S)
    n = S // chunk

    def body(xb, yb):
        lg = lm(params, xb, cfg).float()
        lse = torch.logsumexp(lg, dim=-1)
        iota = torch.arange(lg.shape[-1], device=lg.device)
        tgt = torch.where(iota == yb[..., None], lg, 0.0).sum(dim=-1)
        return (lse - tgt).sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        tot = tot + checkpoint(body, x[:, sl], labels[:, sl],
                               use_reentrant=False)
    return tot / (B * n * chunk)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of every stack (the reference's ``loss_fn``):
    ``xent + aux_loss_coef * aux``, with {"xent", "aux"}; aux is the
    MoE layers' summed load-balance loss (0 without MoE, and for the
    encoder-decoder). Differentiable end to end; it reaches no kernel."""
    if cfg.is_encdec:
        memory = encdec.encode(params, batch["frames"], cfg, remat)
        x, _ = encdec.decode_stack(params, batch["tokens"], memory, cfg,
                                   "train", remat=remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, _, aux = transformer.backbone(
            params, batch["tokens"], cfg, "train",
            patches=batch.get("patches"), positions=batch.get("positions"),
            remat=remat)
    xent = _xent_chunked(params, x, batch["labels"], cfg)
    coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0
    return xent + coef * aux, {"xent": xent, "aux": aux}


def init_state(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Params:
    """A zero decode state; an encoder-decoder's memory K/V holds
    ``capacity`` frames, as the reference's does."""
    if cfg.is_encdec:
        return encdec.init_state(cfg, batch, capacity, capacity, device)
    return transformer.init_state(cfg, batch, capacity, device)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """tokens [B, S] (and the front ends' inputs) -> (last-position logits
    [B, 1, V], decode state).

    An attention layer's state holds the prompt's S KV positions, as the
    reference's does: a decode step past them writes the last slot
    again. ``capacity`` (>= S) makes room for ``capacity - S`` decoded
    tokens in every attention layer's KV (under ``scan/s{j}`` with its
    leading [G] and ``rem/r{j}`` without; an encoder-decoder's ``kv``),
    zero-filled past the prompt. Mamba layers' states have no positions
    and stay as they are; so does an encoder-decoder's ``memory_kv``,
    whose keys cross-attention never masks (zero keys would enter its
    softmax)."""
    S = batch["tokens"].shape[1]
    if cfg.is_encdec:
        memory = encdec.encode(params, batch["frames"], cfg)
        x, state = encdec.decode_stack(params, batch["tokens"], memory, cfg,
                                       "prefill")
        caches = [state["kv"]]
        lm = encdec.lm_logits
    else:
        x, state, _ = transformer.backbone(
            params, batch["tokens"], cfg, "prefill",
            patches=batch.get("patches"), positions=batch.get("positions"))
        caches = [kv for tree in (state["scan"], state.get("rem", {}))
                  for kv in tree.values() if "k" in kv]
        lm = transformer.lm_logits
    if capacity is not None:
        if capacity < S:
            raise ValueError(f"capacity {capacity} < prompt length {S}")
        for kv in caches:
            for name in ("k", "v"):
                t = kv[name]
                ax = t.dim() - 3                     # the key axis
                kv[name] = torch.cat([t, t.new_zeros(
                    t.shape[:ax] + (capacity - S,) + t.shape[ax + 1:])],
                    dim=ax)
    return lm(params, x[:, -1:, :], cfg), state


def decode_step(params: Params, state: Params,
                batch: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence in the batch. tokens: [B, 1]."""
    if cfg.is_encdec:
        x, state = encdec.decode_stack(params, batch["tokens"], None, cfg,
                                       "decode", state=state)
        return encdec.lm_logits(params, x, cfg), state
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "decode", state=state)
    return transformer.lm_logits(params, x, cfg), state
