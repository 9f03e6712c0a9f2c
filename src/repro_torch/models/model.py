"""Model API of the generic serve path: init, prefill and decode step
(counterpart of the reference's ``models/model.py``, serving entry points).

    logits, state = prefill(params, {"tokens": tokens}, cfg)
    logits, state = decode_step(params, state, {"tokens": next_tok}, cfg)

The same signatures as the reference's (``init_params`` and
``init_state`` are the transformer's: the port has no encoder-decoder
module). They serve every decoder stack the reference's generic path
serves: dense-FFN attention stacks with any window pattern (gemma3's 5:1),
the Mamba2 stack, hybrid attention/Mamba periods with MoE (jamba) and
interleaved MoE with a shared expert (llama4). Stacks the port cannot run
yet, encoder-decoder models and the vlm/audio front ends, raise
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

    An attention layer's state holds the prompt's S KV positions, as the
    reference's does: a decode step past them writes the last slot
    again. ``capacity`` (>= S) makes room for ``capacity - S`` decoded
    tokens in every attention layer's KV (under ``scan/s{j}`` with its
    leading [G] and ``rem/r{j}`` without), zero-filled past the prompt;
    Mamba layers' states have no positions and stay as they are."""
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "prefill")
    if capacity is not None:
        S = batch["tokens"].shape[1]
        if capacity < S:
            raise ValueError(f"capacity {capacity} < prompt length {S}")
        for tree in (state["scan"], state.get("rem", {})):
            for kv in tree.values():
                if "k" not in kv:
                    continue
                for name in ("k", "v"):
                    t = kv[name]
                    ax = t.dim() - 3                 # the key axis
                    kv[name] = torch.cat([t, t.new_zeros(
                        t.shape[:ax] + (capacity - S,) + t.shape[ax + 1:])],
                        dim=ax)
    return transformer.lm_logits(params, x[:, -1:, :], cfg), state


def decode_step(params: Params, state: Params,
                batch: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence in the batch. tokens: [B, 1]."""
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "decode", state=state)
    return transformer.lm_logits(params, x, cfg), state
