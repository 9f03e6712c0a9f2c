"""The comparison that decides ``correct``: the served tokens of a run
against the plain reference, run once over each prompt with its served
tokens.

For a served token the gap is the reference's best logit at that position
minus the reference's logit of the token that was served: 0 where the
program chose what the reference would, more the worse its choice. The
control puts the reference computed in a lower precision in the
program's place: its token at a position is the one that precision puts
first, read against the float32 reference the same way.

Numbers (those compared have a limit in the configuration file's
``limits``, the others are printed beside them; the benchmark's
configuration compares ``mean_gap``):
    max_gap    the widest gap of any served token of the run
    mismatch   the share of served tokens (%) with a gap above 0: tokens
               the reference would not have chosen
    mean_gap   the mean gap over the served tokens. The program's bf16
               rounding turns a token only where the reference's best two
               lie within a rounding step or a router pick is near a tie,
               so its gaps are few and small; a lower precision moves
               every logit further, and a token altered or a state lost
               costs a whole logit's spread (1-4) a token, so a few
               percent of such tokens pass the limit
    far        the share of served tokens (%) with a gap above 0.1 (near
               the top, 2-5, a bf16 logit's step is 0.016-0.031); it
               lets a share of wrong tokens pass, and parts the program
               from float8 only at small widths (the tests' configuration)
    p99_gap    the 99th percentile of the gaps
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.window import Served


def sequences(served: Sequence[Served], prompts: Dict[int, np.ndarray]
              ) -> Tuple[List[Tuple[np.ndarray, int]], List[List[int]]]:
    """(tokens, prompt length) the reference runs over, and the tokens
    it judges: the prompt and every served token but the last."""
    seqs, toks = [], []
    for s in served:
        if not s.tokens:
            continue
        p = prompts[s.index]
        seqs.append((np.concatenate([p, np.asarray(s.tokens[:-1],
                                                   np.int64)]), len(p)))
        toks.append(list(s.tokens))
    return seqs, toks


def gaps(ref_logits: Sequence[torch.Tensor], tokens: Sequence[List[int]]
         ) -> np.ndarray:
    """Every judged position's gap (float64, in sequence order)."""
    out = []
    for lg, tk in zip(ref_logits, tokens):
        t = torch.as_tensor(tk, device=lg.device).long()
        out.append((lg.max(-1).values - lg.gather(1, t[:, None])[:, 0])
                   .double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(ref_logits: Sequence[torch.Tensor],
                 low_logits: Sequence[torch.Tensor]) -> np.ndarray:
    """The gaps of the tokens the lower precision puts first."""
    return gaps(ref_logits, [lo.argmax(-1).tolist() for lo in low_logits])


FAR = 0.1


def numbers(g: np.ndarray) -> Dict[str, float]:
    if not g.size:
        nan = float("nan")
        return {"max_gap": nan, "mismatch": nan, "mean_gap": nan,
                "far": nan, "p99_gap": nan, "judged_tokens": 0}
    return {"max_gap": float(g.max()),
            "mismatch": 100.0 * float((g > 0).mean()),
            "mean_gap": float(g.mean()),
            "far": 100.0 * float((g > FAR).mean()),
            "p99_gap": float(np.percentile(g, 99.0)),
            "judged_tokens": int(g.size)}


def verdict(nums: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): every configured number at
    or under its limit; a run with no limit set, or nothing judged, is
    not correct."""
    shown = {k: {"value": nums[k], "limit": float(v)}
             for k, v in limits.items()}
    ok = bool(limits) and nums.get("judged_tokens", 0) > 0 and all(
        np.isfinite(nums[k]) and nums[k] <= float(v)
        for k, v in limits.items())
    return ok, shown
