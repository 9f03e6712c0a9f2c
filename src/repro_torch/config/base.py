"""Configuration dataclasses of the PyTorch port.

The port's own copy of the reference configuration types, cut to what the
collaborative MoE serving path and the generic Mamba2 path read. Field
names, defaults and :func:`reduced` follow the JAX package's
``config/base.py`` exactly, so a config built on either side describes the
same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

LayerKind = Literal["attn", "mamba"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    num_shared_experts: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25   # train-time dispatch capacity
    serve_capacity_factor: float = 8.0  # prefill/serve: effectively dropless
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config. One instance per ``--arch`` id."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int               # dense FFN hidden size (0 if every FFN is MoE)
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    layer_pattern: Tuple[LayerKind, ...] = ("attn",)
    moe_every: int = 1
    moe_offset: int = 0
    window_pattern: Tuple[int, ...] = ()
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    encoder_layers: int = 0
    frontend_embed_dim: int = 0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    max_seq_len: int = 131072

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> LayerKind:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe_every) == self.moe_offset

    def window_for_layer(self, i: int) -> int:
        if not self.window_pattern:
            return -1
        return self.window_pattern[i % len(self.window_pattern)]


@dataclass(frozen=True)
class CacheConfig:
    """Set-associative expert-cache configuration (the paper's §III-B)."""

    num_indexes: int          # N: cached layers 0..N-1 (one set per layer)
    num_ways: int             # M: expert slots per set
    policy: Literal["lru", "fifo", "random"] = "lru"

    @property
    def num_slots(self) -> int:
        return self.num_indexes * self.num_ways


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's geometry)."""
    period = max(len(cfg.layer_pattern), len(cfg.window_pattern) or 1,
                 cfg.moe_every)
    changes = dict(
        num_layers=min(cfg.num_layers, 2 * period),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_embed_dim=64 if cfg.frontend_embed_dim else 0,
        max_seq_len=512,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2), d_ff=128)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=32, head_dim=32, chunk_size=64)
    if cfg.window_pattern:
        changes["window_pattern"] = tuple(64 if w > 0 else -1
                                          for w in cfg.window_pattern)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
