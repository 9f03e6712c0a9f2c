"""The traffic generator: deterministic per seed, the same sizes in the
same order for every seed, prompts within the mix's bounds."""
import itertools

import numpy as np
import pytest

from perfbench import manifest, traffic

MIXES = sorted(p.stem for p in (manifest.ROOT / "perfbench/traffic")
               .glob("*.json"))


def take(mix, seed, n, vocab=32000):
    return list(itertools.islice(traffic.requests(mix, vocab, seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = traffic.load_mix(manifest.ROOT / f"perfbench/traffic/{name}.json")
    seed = 2 ** 31 + 12345             # more than 32 signed bits hold
    a, b = take(mix, seed, 20), take(mix, seed, 20)
    assert all(np.array_equal(x.prompt, y.prompt)
               and x.new_tokens == y.new_tokens for x, y in zip(a, b))
    c = take(mix, seed + 1, 20)
    assert not all(np.array_equal(x.prompt[:8], y.prompt[:8])
                   for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_sizes(name):
    mix = traffic.load_mix(manifest.ROOT / f"perfbench/traffic/{name}.json")
    blocks = []
    for seed in (1, 2, 3, 2 ** 33):
        reqs = take(mix, seed, 2 * mix.block)
        lens = [len(r.prompt) for r in reqs]
        assert all(mix.prompt_lo <= n <= mix.prompt_hi for n in lens)
        assert all(max(r.prompt) < 32000 for r in reqs)
        blocks.append(sorted(lens[:mix.block]))
        mid = (mix.prompt_lo + mix.prompt_hi) / 2
        for k in range(2, len(lens) + 1, 2):       # every even prefix
            assert abs(np.mean(lens[:k]) - mid) <= 1
    assert all(b == blocks[0] for b in blocks)


def test_every_seed_sends_the_sizes_in_one_order():
    mix = traffic.load_mix(manifest.ROOT / "perfbench/traffic/chat1.json")
    runs = [[len(r.prompt) for r in take(mix, s, 2 * mix.block)]
            for s in (1, 2, 3, 2 ** 33)]
    assert all(r == runs[0] for r in runs)
    assert runs[0][:4] == [120, 136, 104, 152]


def test_strata_are_the_midpoints():
    assert traffic.strata(64, 192, 8) == [72, 88, 104, 120, 136, 152, 168,
                                          184]
    assert traffic.strata(16, 16, 4) == [16, 16, 16, 16]


def test_warmup_is_its_own_stream():
    mix = traffic.load_mix(manifest.ROOT / "perfbench/traffic/chat4.json")
    w = traffic.warmup_requests(mix, 32000, 5)
    assert len(w) == mix.clients
    assert all(len(r.prompt) == mix.prompt_lo for r in w)
    first = take(mix, 5, 1)[0]
    assert not np.array_equal(w[0].prompt[:len(first.prompt)], first.prompt)


@pytest.mark.parametrize("bad", [
    {"capacity": 100}, {"block": 3}, {"clients": 0}, {"greedy": False}])
def test_mix_rules(tmp_path, bad):
    import json
    d = json.loads((manifest.ROOT / "perfbench/traffic/chat1.json")
                   .read_text())
    d.update(bad)
    p = tmp_path / "m.json"
    p.write_text(json.dumps(d))
    with pytest.raises(ValueError):
        traffic.load_mix(p)
