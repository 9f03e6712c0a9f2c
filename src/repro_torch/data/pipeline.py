"""Synthetic sharded token pipeline (the port's copy of the reference's
``data/pipeline.py``, numpy only: batches are equal bit for bit).

Deterministic per (seed, step, shard): every data-parallel host generates
only its shard, so the pipeline scales to any process count without a
central dispenser — and a restarted/elastic job regenerates identical
batches from the step counter alone (important for the fault-tolerance
story: data state is a pure function of `step`).

The generator is a cheap per-element hash (splitmix-style) producing a
Zipf-ish skewed token stream plus a deterministic "document" structure so
losses are not pure noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


@dataclass
class SyntheticLM:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    num_shards: int = 1
    shard: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        B = self.shape.global_batch // self.num_shards
        S = self.shape.seq_len
        idx = (np.arange(B * (S + 1), dtype=np.uint64).reshape(B, S + 1)
               + np.uint64(step) * np.uint64(1 << 32)
               + np.uint64(self.shard) * np.uint64(1 << 48)
               + np.uint64(self.seed) * np.uint64(1 << 56))
        h = _splitmix(idx)
        # Zipf-ish skew: square a uniform to concentrate mass at low ids
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = (u * u * self.cfg.vocab_size).astype(np.int32)
        out = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        if self.cfg.family == "audio":
            f = _splitmix(idx[:, :S] + np.uint64(7))
            frames = ((f >> np.uint64(11)).astype(np.float64) / float(1 << 53)
                      - 0.5).astype(np.float32)
            out["frames"] = np.repeat(frames[:, :, None],
                                      self.cfg.frontend_embed_dim, axis=2)
        if self.cfg.family == "vlm":
            g = _splitmix(idx[:, :64] + np.uint64(13))
            patches = ((g >> np.uint64(11)).astype(np.float64) / float(1 << 53)
                       - 0.5).astype(np.float32)
            out["patches"] = np.repeat(patches[:, :, None],
                                       self.cfg.frontend_embed_dim, axis=2)
            p = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
            out["positions"] = np.stack([p, p, p])
        return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    return SyntheticLM(cfg, shape, seed=seed).batch(step)
