"""The one traffic generator: a mix file's parameters and a seed in, the
requests of a run out.

A mix (``perfbench/traffic/<name>.json``) is data only:

    arrival        "closed": each of ``clients`` sends its next request when
                   its last one has ended (the only loop the harness drives)
    clients        concurrent clients, and the engine's request slots
    prompt_tokens  {"lo", "hi"}: prompt lengths, stratified over the range
    new_tokens     {"lo", "hi"}: output tokens a request asks for
    block          lengths come in blocks of this many strata (even)
    capacity       the engine's KV capacity: hi prompt + hi new + 1
    greedy         every request decodes greedily

Every seed sends the same sizes in the same order; the seed draws the
token ids. A block holds ``block`` evenly spaced prompt lengths (the
midpoints of equal strata of [lo, hi]); they go out as antithetic pairs (a
length and its mirror image about the middle of the range), the pairs from
the middle of the range outward. So every even-length prefix of a block
has the mean prompt length of the whole range, and a window that holds
only a few requests holds the same work on every seed. New-token counts
are paired the same way. Token ids are uniform over the vocabulary, drawn
from the seed in the order the requests are sent; no two prompts share a
prefix beyond chance.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List

import numpy as np

# independent streams of one seed (numpy SeedSequence spawn keys)
_STREAM_REQUESTS = 0
_STREAM_WARMUP = 1


@dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    prompt_lo: int
    prompt_hi: int
    new_lo: int
    new_hi: int
    block: int
    capacity: int
    greedy: bool = True


@dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray        # [P] int64 token ids
    new_tokens: int


def load_mix(path: Path) -> Mix:
    d = json.loads(Path(path).read_text())
    if d.get("arrival") != "closed":
        raise ValueError(f"{path}: only closed-loop arrival is generated, "
                         f"got {d.get('arrival')!r}")
    mix = Mix(name=Path(path).stem, clients=int(d["clients"]),
              prompt_lo=int(d["prompt_tokens"]["lo"]),
              prompt_hi=int(d["prompt_tokens"]["hi"]),
              new_lo=int(d["new_tokens"]["lo"]),
              new_hi=int(d["new_tokens"]["hi"]),
              block=int(d["block"]), capacity=int(d["capacity"]),
              greedy=bool(d.get("greedy", True)))
    check_mix(mix)
    return mix


def check_mix(mix: Mix) -> None:
    if mix.clients < 1:
        raise ValueError(f"{mix.name}: clients must be >= 1")
    if not 1 <= mix.prompt_lo <= mix.prompt_hi:
        raise ValueError(f"{mix.name}: need 1 <= prompt lo <= hi")
    if not 1 <= mix.new_lo <= mix.new_hi:
        raise ValueError(f"{mix.name}: need 1 <= new lo <= hi")
    if mix.block < 2 or mix.block % 2:
        raise ValueError(f"{mix.name}: block must be even and >= 2")
    if mix.prompt_hi + mix.new_hi + 1 > mix.capacity:
        raise ValueError(f"{mix.name}: capacity {mix.capacity} cannot hold "
                         f"the longest request")
    if not mix.greedy:
        raise ValueError(f"{mix.name}: the correctness check compares "
                         f"greedy tokens; sampled traffic needs greedy "
                         f"requests mixed in first")


def strata(lo: int, hi: int, n: int) -> List[int]:
    """n evenly spaced sizes over [lo, hi]: the midpoints of n equal
    strata, rounded; symmetric about (lo + hi) / 2."""
    return [int(round(lo + (hi - lo) * (2 * i + 1) / (2 * n)))
            for i in range(n)]


def _block_order(n: int) -> List[int]:
    """Indices 0..n-1 as antithetic pairs (i, n-1-i), from the middle of
    the range outward, the shorter first."""
    return [j for i in reversed(range(n // 2)) for j in (i, n - 1 - i)]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(int(seed), spawn_key=(stream,))))


def requests(mix: Mix, vocab: int, seed: int) -> Iterator[Request]:
    """The run's requests in the order they are sent (endless)."""
    rng = _rng(seed, _STREAM_REQUESTS)
    plens = strata(mix.prompt_lo, mix.prompt_hi, mix.block)
    news = strata(mix.new_lo, mix.new_hi, mix.block)
    i = 0
    while True:
        for j in _block_order(mix.block):
            prompt = rng.integers(0, vocab, plens[j], dtype=np.int64)
            yield Request(i, prompt, news[j])
            i += 1


def warmup_requests(mix: Mix, vocab: int, seed: int,
                    new_tokens: int = 4) -> List[Request]:
    """One request a slot at the shortest prompt, for set-up: every shape
    the window uses (the padded prefill at capacity, the warming replay's
    chunk, a decode step over all slots) runs before the window opens; a
    longer prompt adds warming chunks of the same shape, and set-up."""
    rng = _rng(seed, _STREAM_WARMUP)
    return [Request(-1 - c, rng.integers(0, vocab, mix.prompt_lo,
                                         dtype=np.int64),
                    min(new_tokens, mix.new_hi))
            for c in range(mix.clients)]
