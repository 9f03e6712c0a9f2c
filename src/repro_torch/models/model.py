"""Model API of the generic serve path: init, prefill and decode step
(counterpart of the reference's ``models/model.py``, serving entry points).

    logits, state = prefill(params, {"tokens": tokens}, cfg)
    logits, state = decode_step(params, state, {"tokens": next_tok}, cfg)

The same signatures as the reference's (``init_params`` and
``init_state`` are the transformer's: the port has no encoder-decoder
module). They serve the dense-FFN attention stacks and the Mamba2 stack.
Stacks the port cannot run yet, encoder-decoder models among them, raise
``NotImplementedError`` (:func:`transformer.stack_kind`); the decode step
of the attention+MoE stack is the collaborative engine's
(:mod:`repro_torch.serving.engine`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from . import transformer
from .transformer import init_params, init_state

__all__ = ["decode_step", "init_params", "init_state", "prefill"]

Params = Dict[str, Any]


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """tokens [B, S] -> (last-position logits [B, 1, V], decode state).

    An attention stack's state holds the prompt's S KV positions, as the
    reference's does: a decode step past them writes the last slot
    again. ``capacity`` (>= S) makes room for ``capacity - S`` decoded
    tokens, zero-filled past the prompt (no effect on a Mamba stack,
    whose state has no positions)."""
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "prefill")
    if capacity is not None and "k" in state["scan"]["s0"]:
        kv = state["scan"]["s0"]
        S = kv["k"].shape[2]
        if capacity < S:
            raise ValueError(f"capacity {capacity} < prompt length {S}")
        for name in ("k", "v"):
            t = kv[name]
            kv[name] = torch.cat([t, t.new_zeros(
                t.shape[:2] + (capacity - S,) + t.shape[3:])], dim=2)
    return transformer.lm_logits(params, x[:, -1:, :], cfg), state


def decode_step(params: Params, state: Params,
                batch: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence in the batch. tokens: [B, 1]."""
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "decode", state=state)
    return transformer.lm_logits(params, x, cfg), state
