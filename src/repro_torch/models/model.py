"""Model API of the generic serve path: init, prefill and decode step
(counterpart of the reference's ``models/model.py``, serving entry points).

    logits, state = prefill(params, {"tokens": tokens}, cfg)
    logits, state = decode_step(params, state, {"tokens": next_tok}, cfg)

The same signatures as the reference's (``init_params`` and
``init_state`` are the transformer's: the port has no encoder-decoder
module). Stacks the port cannot run yet, encoder-decoder models among
them, raise ``NotImplementedError`` (:func:`transformer.stack_kind`); the
decode step of the attention+MoE stack is the collaborative engine's
(:mod:`repro_torch.serving.engine`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from . import transformer
from .transformer import init_params, init_state

__all__ = ["decode_step", "init_params", "init_state", "prefill"]

Params = Dict[str, Any]


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Params]:
    """tokens [B, S] -> (last-position logits [B, 1, V], decode state)."""
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "prefill")
    return transformer.lm_logits(params, x[:, -1:, :], cfg), state


def decode_step(params: Params, state: Params,
                batch: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence in the batch. tokens: [B, 1]."""
    x, state, _ = transformer.backbone(params, batch["tokens"], cfg,
                                       "decode", state=state)
    return transformer.lm_logits(params, x, cfg), state
