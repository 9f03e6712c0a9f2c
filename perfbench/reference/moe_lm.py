"""Plain reference of the attention + MoE decoder that ``repro_torch``'s
collaborative engine serves: float32 PyTorch, TF32 off, no kernel, cache,
tier or batching, one causal pass over each prompt and its served tokens.

It follows the equations the port declares for this stack (where they
depart from a published model, the configuration file lists it):

    x      = embed[tokens]
    layer  h  = rmsnorm(x) * ln1
           q, k, v = h @ wq, h @ wk, h @ wv; q, k turned by RoPE
                     (rotate-half, theta from the file) at their positions
           x += softmax(q k^T / sqrt(hd), causal) v @ wo   (GQA: kv head
                     h // (H / Hk) serves query head h)
           h2 = rmsnorm(x) * ln2
           p  = softmax(h2 @ router); top-k of p, weights renormalised
           x += sum_k w_k * (silu(h2 @ w1_e) * (h2 @ w3_e)) @ w2_e
    logits = (rmsnorm(x) * final_norm) @ lm_head^T

with rmsnorm(x) = x / sqrt(mean(x^2) + eps). The prompt's MoE runs as the
engine's admission forward declares it: one dispatch over the prompt
padded to the KV capacity, each expert taking at most C assignments in
token order (C from the file's ``prefill_dispatch``: the serve capacity
factor while the padded prompt has at most ``slack_max_assignments``
picks, the train factor past it, rounded up to ``round_to``); a pick past
its expert's C adds nothing. Padding comes after the prompt, so only the
prompt's own picks count against C. Decoded tokens run dropless.

``weights="fp8"`` is the control: every bf16 matrix (projections, experts,
LM head) rounded to float8 e4m3 with one scale a output column, then used
in float32.

Besides ``forward``, a reference module gives the harness what depends on
the configuration's layer layout: ``draw`` (the seeded weights both sides
share), ``host_tier`` (the empty expert tables in host memory) and
``decode_flops`` (the model FLOPs of decode tokens). Here they are the
benchmark's attention + MoE layout (``perfbench/weights.py``,
``perfbench/roofline.py``): every layer attention and an MoE, one
``scan/s0`` slot with a leading [L] axis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench import roofline, weights as layout

FP8_MAX = 448.0          # largest finite float8 e4m3fn


def _fp8(w: torch.Tensor, in_axis: int) -> torch.Tensor:
    w = w.float()
    scale = w.abs().amax(dim=in_axis, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _mat(w: torch.Tensor, dev, weights: str, in_axis: int = -2
         ) -> torch.Tensor:
    w = w.to(dev)
    return _fp8(w, in_axis) if weights == "fp8" else w.float()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv[None]).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def prefill_capacity(capacity: int, K: int, E: int, spec: Dict) -> int:
    """Assignments an expert takes in the admission forward."""
    picks = capacity * K
    cf = spec["serve_capacity_factor"] if picks <= \
        spec["slack_max_assignments"] else spec["capacity_factor"]
    c = max(int(capacity * K / E * cf), 1)
    r = spec["round_to"]
    return (c + r - 1) // r * r


def _keep(top_i: torch.Tensor, P: int, E: int, C: int) -> torch.Tensor:
    """[S, K] bool: rows < P keep a pick while its expert's count of picks
    so far (token-major, then pick order) is under C; later rows keep
    all."""
    S, K = top_i.shape
    keep = torch.ones((S, K), dtype=torch.bool, device=top_i.device)
    flat = top_i[:P].reshape(-1)
    onehot = torch.nn.functional.one_hot(flat.long(), E)
    before = torch.cumsum(onehot, 0) - onehot
    rank = before[torch.arange(flat.numel(), device=flat.device),
                  flat.long()]
    keep[:P] = (rank < C).reshape(P, K)
    return keep


def _layer(x, lw, cfg, P: int, C: int, routes=None):
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    Hk = cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    eps = cfg["rms_norm_eps"]
    S = x.shape[0]
    h = _rms(x, lw["ln1"], eps)
    q = _rope((h @ lw["wq"]).reshape(S, H, hd), cfg["rope_theta"])
    k = _rope((h @ lw["wk"]).reshape(S, Hk, hd), cfg["rope_theta"])
    v = (h @ lw["wv"]).reshape(S, Hk, hd)
    k = k.repeat_interleave(H // Hk, dim=1)
    v = v.repeat_interleave(H // Hk, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    x = x + o.reshape(S, H * hd) @ lw["wo"]
    h2 = _rms(x, lw["ln2"], eps)
    logits = h2 @ lw["router"]
    if routes is not None:
        routes.append(logits)
    probs = torch.softmax(logits, -1)
    top_w, top_i = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = _keep(top_i, P, E, C)
    y = torch.zeros_like(x)
    for e in range(E):
        rows, slot = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        he = h2[rows]
        a = he @ lw["w1"][e]
        f = (a * torch.sigmoid(a) * (he @ lw["w3"][e])) @ lw["w2"][e]
        y.index_add_(0, rows, f * top_w[rows, slot][:, None])
    return x + y


def forward(params, cfg: Dict, seqs: Sequence[Tuple[np.ndarray, int]],
            capacity: int, device, weights: str = "fp32",
            routes: Optional[List[torch.Tensor]] = None
            ) -> List[torch.Tensor]:
    """Logits [S - P + 1, V] (float32, on ``device``) at positions
    P-1 .. S-1 of each sequence ``(tokens [S], P)``: the rows that chose
    the served tokens. Layer by layer over every sequence, one layer's
    weights on the device at a time. ``routes``, if given, receives each
    layer's router logits [S, E] of each sequence, layer by layer."""
    if weights not in ("fp32", "fp8"):
        raise ValueError(f"weights must be fp32 or fp8, got {weights!r}")
    dev = torch.device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(params, cfg, seqs, capacity, dev, weights, routes)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _forward(params, cfg, seqs, capacity, dev, weights, routes):
    E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    C = prefill_capacity(capacity, K, E, cfg["prefill_dispatch"])
    embed = params["embed"].to(dev)
    xs = [embed[torch.as_tensor(np.asarray(t), device=dev).long()].float()
          for t, _ in seqs]
    lp = params["scan"]["s0"]
    with torch.no_grad():
        for l in range(cfg["num_hidden_layers"]):
            lw = {"ln1": lp["ln1"][l].to(dev), "ln2": lp["ln2"][l].to(dev),
                  "router": lp["moe"]["router"][l].to(dev).float()}
            for name in ("wq", "wk", "wv", "wo"):
                lw[name] = _mat(lp["attn"][name][l], dev, weights)
            for name in ("w1", "w3", "w2"):
                lw[name] = _mat(lp["moe"][name][l], dev, weights)
            xs = [_layer(x, lw, cfg, P, C, routes)
                  for x, (_, P) in zip(xs, seqs)]
            del lw
        head = _mat(params["lm_head"], dev, weights, in_axis=-1)
        out = []
        for x, (_, P) in zip(xs, seqs):
            h = _rms(x[P - 1:], params["final_norm"].to(dev),
                     cfg["rms_norm_eps"])
            out.append(h @ head.t())
    return out


def draw(cfg: Dict, seed: int, device,
         host: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Every weight of ``cfg`` from ``seed``, the expert tables in
    ``host`` (made if None)."""
    return layout.draw(cfg, seed, device, host=host)


def host_tier(cfg: Dict, pinned: bool) -> Dict[str, torch.Tensor]:
    """Empty expert tables [L, E, D, F] / [L, E, F, D], page-locked at their
    exact size where ``pinned``."""
    return layout.host_tier(layout.Shapes.of(cfg), pinned)


def decode_flops(cfg: Dict, keys_seen) -> float:
    """Model FLOPs of decode tokens that saw ``keys_seen`` keys each."""
    return roofline.decode_flops(cfg, keys_seen)
