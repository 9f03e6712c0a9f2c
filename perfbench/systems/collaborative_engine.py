"""The system under test for an attention + MoE configuration: the port's
``repro_torch.serving.build`` with the configuration file's cache and
engine options, over the benchmark's own weights. The window drives the
scheduler (``submit`` / ``step``) and, through it, the engine's admission
prefill (``start_prefill``, ``advance_prefill`` with the warming replay)
and decode (``decode_batch``: ``probe`` / ``execute`` / ``commit``)."""
from __future__ import annotations

from typing import Dict


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of a configuration file's published
    keys (as the port's own registered config does, with the file's
    values where they differ)."""
    from repro_torch.config import ModelConfig, MoEConfig
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    pd = cfg["prefill_dispatch"]
    return ModelConfig(
        name=cfg["name"], family="moe", num_layers=cfg["num_hidden_layers"],
        d_model=D, num_heads=H, num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or D // H, d_ff=0,
        vocab_size=cfg["vocab_size"],
        moe=MoEConfig(num_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff=cfg["intermediate_size"],
                      capacity_factor=pd["capacity_factor"],
                      serve_capacity_factor=pd["serve_capacity_factor"]),
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_seq_len=cfg["max_position_embeddings"])


def build(cfg: Dict, mix, params, seed: int, device, recorder=None):
    """(engine, scheduler) over ``params``: one request slot a client, the
    mix's KV capacity, the file's cache geometry and engine options."""
    from repro_torch.serving import build as serving_build
    cache = {k: v for k, v in cfg["cache"].items() if k != "why"}
    serving = dict(cfg["engine"], max_batch=mix.clients,
                   capacity=mix.capacity)
    return serving_build(model_config(cfg), cache=cache, serving=serving,
                         seed=int(seed) % (2 ** 31), params=params,
                         recorder=recorder, device=str(device))
