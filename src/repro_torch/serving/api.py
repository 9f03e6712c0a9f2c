"""One-call construction of the collaborative serving stack (counterpart
of the reference's ``serving/api.py::build``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import CacheConfig, ModelConfig, get_config, reduced
from repro_torch.models import init_params

from .engine import CollaborativeEngine, EngineConfig
from .scheduler import ContinuousBatchingScheduler

__all__ = ["build"]


def build(arch: Union[str, ModelConfig], *,
          cache: Union[None, CacheConfig, Dict] = None,
          serving: Union[None, EngineConfig, Dict] = None,
          seed: int = 0,
          params=None,
          reduce: bool = True,
          max_queue: Optional[int] = None,
          recorder=None,
          device="cuda"
          ) -> Tuple[CollaborativeEngine, ContinuousBatchingScheduler]:
    """Build the collaborative engine + continuous-batching scheduler.

    arch    — architecture id (``"mixtral-8x7b"``) or a ModelConfig, used
              AS-IS (``reduce`` only applies to an arch id).
    cache   — CacheConfig, or overrides of the default
              ``CacheConfig(num_indexes=num_layers, num_ways=2, "lru")``.
    serving — EngineConfig, or a dict of EngineConfig overrides.
    seed    — seeds parameter init, static cache placement and the
              scheduler's fallback sampling seeds.
    params  — pre-initialized parameters (skips ``init_params``); they
              must already lie on ``device``.
    device  — where the model runs: ``"cuda"`` unless the caller asks for
              ``"cpu"``. A missing GPU raises; nothing falls back.

    Returns ``(engine, scheduler)``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build(device='cuda'): no CUDA device available; "
                           "pass device='cpu' to run on the CPU")
    cfg = arch
    if isinstance(arch, str):
        cfg = get_config(arch)
        if reduce:
            cfg = reduced(cfg)
    if cfg.moe is None or cfg.moe_every != 1 or cfg.is_encdec:
        raise ValueError(
            f"{cfg.name}: collaborative serving needs a homogeneous "
            f"decoder-only MoE stack (every layer MoE)")

    if isinstance(cache, CacheConfig):
        ccfg = cache
    else:
        opts = dict(num_indexes=cfg.num_layers, num_ways=2, policy="lru")
        opts.update(cache or {})
        ccfg = CacheConfig(**opts)

    if isinstance(serving, EngineConfig):
        ecfg = dataclasses.replace(serving, cache=ccfg) if cache is not None \
            else serving
    else:
        ecfg = EngineConfig(cache=ccfg, **(serving or {}))

    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, dev)
    elif params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, not on "
                         f"the requested device {dev}")
    engine = CollaborativeEngine(cfg, params, ecfg, seed=seed,
                                 recorder=recorder)
    scheduler = ContinuousBatchingScheduler(engine, seed=seed + 1,
                                            max_queue=max_queue,
                                            recorder=recorder)
    return engine, scheduler
