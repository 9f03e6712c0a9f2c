"""A second layer layout for the harness's tests: a stack whose MoE layers
alternate with dense SwiGLU FFNs (Jamba's ``expert_layer_period`` /
``expert_layer_offset``), with no attention, so that no layer reads keys.

It holds both sides a configuration names: the plain reference (``forward``
and the layout's ``draw``, ``host_tier`` and ``decode_flops``) and a stand-in
system (``build``), a one-token-a-step greedy server over that forward. The
tests resolve them by monkeypatching ``manifest.module``; no configuration
file of the benchmark names them.

    x      = embed[tokens]
    layer  h = rmsnorm(x) * ln
           MoE layer:   x += sum_k w_k * swiglu_e(h)
                        (top-k of softmax(h @ router), weights renormalised)
           dense layer: x += swiglu(h)
    logits = (rmsnorm(x) * final_norm) @ lm_head^T
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.weights import _norm, _normal, _page_locked

CONFIG = {
    "source": "https://example.org/hybrid-test-layout",
    "hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 4,
    "expert_layer_period": 2, "expert_layer_offset": 1, "num_experts": 4,
    "num_experts_per_tok": 2, "vocab_size": 64, "rms_norm_eps": 1e-05,
    "system": "hybrid", "reference": "hybrid",
    # the stand-in serves the reference's own greedy tokens: only a near tie
    # that rounding turns between a prefix's pass and the whole one differs
    "limits": {"mean_gap": 0.01},
}
LEAVES = ("w1", "w3", "w2")


def moe_layers(cfg: Dict) -> List[int]:
    p, o = cfg["expert_layer_period"], cfg["expert_layer_offset"]
    return [l for l in range(cfg["num_hidden_layers"]) if l % p == o]


def _shape(cfg: Dict, leaf: str, lead) -> tuple:
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    return tuple(lead) + ((F, D) if leaf == "w2" else (D, F))


def host_tier(cfg: Dict, pinned: bool) -> Dict[str, torch.Tensor]:
    """Expert tables of the MoE layers alone: [n_moe, E, D, F] / [.., F, D]."""
    lead = (len(moe_layers(cfg)), cfg["num_experts"])
    shapes = {k: _shape(cfg, k, lead) for k in LEAVES}
    if pinned:
        return {k: _page_locked(v, torch.bfloat16)
                for k, v in shapes.items()}
    return {k: torch.empty(v, dtype=torch.bfloat16)
            for k, v in shapes.items()}


def draw(cfg: Dict, seed: int, device, host=None) -> Dict:
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    n_moe = len(moe_layers(cfg))
    if host is None:
        host = host_tier(cfg, pinned=dev.type == "cuda")
    params = {"embed": _normal((V, D), D, g, dev),
              "lm_head": _normal((V, D), D, g, dev),
              "final_norm": _norm((D,), g, dev),
              "ln": _norm((L, D), g, dev),
              "router": _normal((n_moe, D, cfg["num_experts"]), D, g, dev,
                                torch.float32),
              "dense": {}, "experts": host}
    for leaf in LEAVES:
        fan_in = cfg["intermediate_size"] if leaf == "w2" else D
        params["dense"][leaf] = _normal(
            _shape(cfg, leaf, (L - n_moe,)), fan_in, g, dev)
        host[leaf].copy_(_normal(host[leaf].shape, fan_in, g, dev))
    return params


def active_params_per_token(cfg: Dict) -> int:
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    n_moe = len(moe_layers(cfg))
    n_dense = cfg["num_hidden_layers"] - n_moe
    return (n_dense * 3 * D * F + n_moe * (D * cfg["num_experts"]
            + cfg["num_experts_per_tok"] * 3 * D * F) + cfg["vocab_size"] * D)


def decode_flops(cfg: Dict, keys_seen) -> float:
    """2 a active parameter a token; no layer reads keys."""
    return 2.0 * active_params_per_token(cfg) * len(list(keys_seen))


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _swiglu(h, w1, w3, w2):
    a = h @ w1.float()
    return (a * torch.sigmoid(a) * (h @ w3.float())) @ w2.float()


def logits(params, cfg: Dict, tokens) -> torch.Tensor:
    """[S, V] float32 logits of every position."""
    eps, K = cfg["rms_norm_eps"], cfg["num_experts_per_tok"]
    dev = params["embed"].device
    x = params["embed"][torch.as_tensor(np.asarray(tokens), device=dev)
                        .long()].float()
    moe = moe_layers(cfg)
    for l in range(cfg["num_hidden_layers"]):
        h = _rms(x, params["ln"][l], eps)
        if l in moe:
            i = moe.index(l)
            p = torch.softmax(h @ params["router"][i], -1)
            top_w, top_i = torch.topk(p, K, dim=-1)
            top_w = top_w / top_w.sum(-1, keepdim=True)
            for e in range(cfg["num_experts"]):
                rows, slot = torch.nonzero(top_i == e, as_tuple=True)
                ex = [params["experts"][k][i, e].to(dev) for k in LEAVES]
                x = x.index_add(0, rows, _swiglu(h[rows], *ex)
                                * top_w[rows, slot][:, None])
        else:
            d = l - sum(m < l for m in moe)
            x = x + _swiglu(h, *(params["dense"][k][d] for k in LEAVES))
    h = _rms(x, params["final_norm"], eps)
    return h @ params["lm_head"].float().t()


def forward(params, cfg: Dict, seqs, capacity: int, device,
            weights: str = "fp32", routes=None) -> List[torch.Tensor]:
    """Logits at positions P-1 .. S-1 of each ``(tokens [S], P)``."""
    if weights != "fp32":
        raise ValueError("the test layout has no control precision")
    return [logits(params, cfg, t)[P - 1:] for t, P in seqs]


# -- a stand-in system: greedy, one token a request a step ------------------

@dataclass
class Stats:
    tokens: int = 0
    hits: int = 0
    accesses: int = 0
    fetched_experts: int = 0


@dataclass
class _Req:
    tokens: List[int]
    left: int
    on_token: Optional[object]
    served: int = 0


class Engine:
    def __init__(self, params, cfg):
        self.params, self.cfg, self._stats = params, cfg, Stats()

    @property
    def stats(self) -> Stats:
        return Stats(**vars(self._stats))


class Scheduler:
    """Each step gives every request its next greedy token; a step after a
    request's first token is a decode step (the recorder's
    ``sched``/``decode+drain`` span)."""

    def __init__(self, engine: Engine, recorder=None):
        self.engine, self.recorder, self.live = engine, recorder, []

    def submit(self, prompt, max_new_tokens: int, on_token=None) -> None:
        self.live.append(_Req([int(t) for t in prompt], max_new_tokens,
                              on_token))

    def step(self) -> None:
        t0 = time.perf_counter_ns()
        decode = False
        for r in self.live:
            decode |= r.served > 0
            tok = int(logits(self.engine.params, self.engine.cfg,
                             r.tokens)[-1].argmax())
            r.tokens.append(tok)
            r.left -= 1
            r.served += 1
            self.engine._stats.tokens += 1
            if r.on_token is not None:
                r.on_token(tok, r.left == 0)
        self.live = [r for r in self.live if r.left > 0]
        if self.recorder is not None and decode:
            self.recorder.complete("sched", "decode+drain", t0,
                                   time.perf_counter_ns())

    def run(self) -> None:
        while self.live:
            self.step()


def build(cfg: Dict, mix, params, seed: int, device, recorder=None):
    engine = Engine(params, cfg)
    return engine, Scheduler(engine, recorder)
