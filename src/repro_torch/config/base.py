"""Configuration dataclasses of the PyTorch port.

The port's own copy of the reference configuration types: the model,
expert-cache, shape, optimizer and runtime configs. Field names, defaults,
:meth:`ModelConfig.param_count` and :func:`reduced` follow the JAX
package's ``config/base.py`` exactly, so a config built on either side
describes the same model and counts the same parameters.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

LayerKind = Literal["attn", "mamba"]
FFNKind = Literal["dense", "moe"]


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

    @property
    def attn_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    def layer_kind(self, i: int) -> LayerKind:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe_every) == self.moe_offset

    def window_for_layer(self, i: int) -> int:
        if not self.window_pattern:
            return -1
        return self.window_pattern[i % len(self.window_pattern)]

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500k) decode is architecturally sensible:
        no attention, at most a quarter of the layers attention (a hybrid
        such as jamba), or at least half the window pattern local
        (gemma3)."""
        if self.attn_free:
            return True
        n_attn = sum(1 for i in range(self.num_layers)
                     if self.layer_kind(i) == "attn")
        if n_attn <= self.num_layers // 4:
            return True
        if self.window_pattern and sum(
                1 for w in self.window_pattern if w > 0) * 2 \
                >= len(self.window_pattern):
            return True
        return False

    # Parameter counts (analytic; the trainer prints them) ----------------
    def _attn_params(self) -> int:
        hd = self.head_dim
        return self.d_model * hd * (self.num_heads + 2 * self.num_kv_heads) + \
            self.num_heads * hd * self.d_model

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _moe_ffn_params(self, active_only: bool = False) -> int:
        m = self.moe
        e = (m.top_k + m.num_shared_experts) if active_only \
            else (m.num_experts + m.num_shared_experts)
        return 3 * self.d_model * m.d_ff * e

    def _mamba_params(self) -> int:
        s = self.ssm
        di = s.d_inner(self.d_model)
        nh = s.num_heads(self.d_model)
        # in_proj (z, x, B, C, dt) + out_proj + conv + A, D
        return self.d_model * (2 * di + 2 * s.d_state + nh) + \
            di * self.d_model + (di + 2 * s.d_state) * s.d_conv + 2 * nh

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic count (``ModelConfig.param_count``):
        embeddings (twice unless tied), the front end's projection, every
        layer's attention or Mamba block and its dense FFN or MoE (with
        the router), and an encoder-decoder's cross-attention. Like the
        reference's it counts no norms, biases or ``dt_bias``, and layers
        past ``num_layers`` (the encoder's) by the decoder's pattern."""
        total = self.vocab_size * self.d_model * \
            (1 if self.tie_embeddings else 2)
        if self.frontend_embed_dim:
            total += self.frontend_embed_dim * self.d_model
        for i in range(self.num_layers + self.encoder_layers):
            if self.layer_kind(i) == "attn":
                total += self._attn_params()
            else:
                total += self._mamba_params()
            if self.is_moe_layer(i):
                total += self._moe_ffn_params(active_only)
                total += self.moe.num_experts * self.d_model  # router
            elif self.d_ff > 0:
                total += self._dense_ffn_params()
        if self.encoder_layers:          # cross-attention in the decoder
            total += self.num_layers * self._attn_params()
        return int(total)

    def expert_bytes(self, bytes_per_param: int = 2) -> int:
        """Size of a single expert's weights (the cache slot unit)."""
        if self.moe is None:
            return 0
        return 3 * self.d_model * self.moe.d_ff * bytes_per_param


@dataclass(frozen=True)
class CacheConfig:
    """Set-associative expert-cache configuration (the paper's §III-B)."""

    num_indexes: int          # N: cached layers 0..N-1 (one set per layer)
    num_ways: int             # M: expert slots per set
    policy: Literal["lru", "fifo", "random"] = "lru"

    @property
    def num_slots(self) -> int:
        return self.num_indexes * self.num_ways

    @staticmethod
    def from_memory(mem_bytes: int, expert_bytes: int, num_ways: int,
                    policy: str = "lru", max_layers: int = 10 ** 9
                    ) -> "CacheConfig":
        """The paper's slot math: S = mem / expert_bytes slots, N =
        floor(S / M) indexes (at most ``max_layers``)."""
        slots = int(mem_bytes // max(expert_bytes, 1))
        n = min(slots // num_ways, max_layers)
        if n < 1:
            raise ValueError(
                f"cache memory {mem_bytes} too small for even one "
                f"{num_ways}-way set of {expert_bytes}-byte experts")
        return CacheConfig(num_indexes=n, num_ways=num_ways, policy=policy)


@dataclass(frozen=True)
class ShapeConfig:
    """Input-shape cell: what step runs and with what geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0
    # int8 gradient compression across the (slow) pod axis
    compress_pod_grads: bool = False


@dataclass(frozen=True)
class RuntimeConfig:
    """Distributed runtime knobs (the reference's, field for field)."""

    remat: bool = True
    remat_policy: str = "dots_with_no_batch_dims"
    donate_state: bool = True
    # Checkpointing
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 100
    keep_ckpts: int = 3
    async_ckpt: bool = True
    # Fault tolerance
    heartbeat_interval_s: float = 10.0
    straggler_grace_s: float = 30.0
    elastic: bool = True


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
