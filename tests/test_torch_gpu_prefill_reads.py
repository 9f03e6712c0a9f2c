"""The prefill forward's lookahead reads
(``repro_torch.core.collaborative.ForwardExperts``) on the card.

Needs a CUDA card and skips elsewhere. Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu \
        tests/test_torch_gpu_prefill_reads.py

A source queues layer l+1's host-tier reads on the tiers' copy stream
when it hands layer l its table, into the table layer l-1 read. What must
hold, with one stream or the other held back by ``torch.cuda._sleep``:
the copies run on the copy stream, not on the compute stream;
a table is not overwritten while a stalled earlier read of it is still
queued; the compute stream does not read a table before its copies have
landed; and the forward's logits and KV are bitwise those of the forward
that reads each layer's table when it asks.
"""
import dataclasses

import pytest
import torch
from unittest import mock

from repro_torch import build
from repro_torch.config import get_config, reduced
from repro_torch.core import collaborative as collab

# four layers, so that layer 2 reuses the table layer 0 read
CFG = dataclasses.replace(reduced(get_config("mixtral-8x7b")), num_layers=4)
L = CFG.num_layers
SERVING = dict(max_batch=1, capacity=32, prefill_chunk=8)
STALL = 10 ** 8          # cycles of torch.cuda._sleep, tens of ms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the copy stream's ordering needs a CUDA card")


def _engine(policy="lru"):
    """A cold cache (``lru``: every expert from the host tier, so the copy
    stream writes every row of every table), or the static-random
    policy's preloaded slots (6 of 8 experts a layer resident)."""
    engine, _ = build(CFG, cache=dict(num_indexes=L, num_ways=6,
                                      policy=policy),
                      serving=SERVING, seed=0, device="cuda")
    torch.cuda.synchronize()
    return engine


def _poison(tiers):
    """Leave the allocator's cached blocks of a table's sizes full of NaN,
    so a read of a table whose copies have not landed shows."""
    junk = [collab._empty_table(tiers, CFG.moe.num_experts, "cuda")
            for _ in range(4)]
    for table in junk:
        for t in table:
            t.fill_(float("nan"))
    torch.cuda.synchronize()


def _sleep_on(stream, cycles=STALL):
    with torch.cuda.stream(stream):
        torch.cuda._sleep(cycles)


def _tables(tiers, ccfg):
    return [collab.forward_experts(tiers, layer, ccfg)[0]
            for layer in range(L)]


@pytest.mark.gpu
def test_host_reads_run_on_the_copy_stream(card):
    """With the copy stream held back, layer 0's reads, queued when the
    source is made, have not landed when the compute stream's work,
    the source's included, is done; they land once the stall ends: a
    third stream reads the table before and after."""
    engine = _engine()
    tiers = engine.tiers
    _poison(tiers)
    _sleep_on(tiers.copy.stream, 10 * STALL)
    src = collab.ForwardExperts(tiers, engine.ecfg.cache)
    reads = src._next
    assert reads.ways == [-1] * CFG.moe.num_experts
    torch.cuda.current_stream().synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        early = [t.to("cpu") for t in reads.table]
    assert not reads.done.query(), "the stall ended before the check"
    assert not any(torch.equal(t, host[0])
                   for t, host in zip(early, tiers.host)), \
        "the host reads ran on the compute stream"
    side.wait_event(reads.done)
    with torch.cuda.stream(side):
        late = [t.to("cpu") for t in reads.table]
    for t, host in zip(late, tiers.host):
        assert torch.equal(t, host[0])
    src.close()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["lru", "random"])
def test_a_reused_table_is_not_overwritten_while_read(card, policy):
    """After each layer's table is handed, the compute stream stalls before
    it reads (clones) the table; meanwhile the next read queues the layer
    after next into the same table. Every clone equals
    ``forward_experts``' own."""
    engine = _engine(policy)
    tiers, ccfg = engine.tiers, engine.ecfg.cache
    _poison(tiers)
    src = collab.ForwardExperts(tiers, ccfg)
    got = []
    for layer in range(L):
        table, _, _ = src.read(layer)
        torch.cuda._sleep(STALL)
        got.append(tuple(t.clone() for t in table))
    src.close()
    for layer, (a, b) in enumerate(zip(got, _tables(tiers, ccfg))):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), layer


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["lru", "random"])
def test_a_table_is_not_read_before_its_copies_land(card, policy):
    """The copy stream stalls before every layer's reads are queued; the
    compute stream reads (clones) each table as soon as it is handed.
    Every clone equals ``forward_experts``' own."""
    engine = _engine(policy)
    tiers, ccfg = engine.tiers, engine.ecfg.cache
    _poison(tiers)
    _sleep_on(tiers.copy.stream)
    src = collab.ForwardExperts(tiers, ccfg)
    got = []
    for layer in range(L):
        _sleep_on(tiers.copy.stream)
        table, _, _ = src.read(layer)
        got.append(tuple(t.clone() for t in table))
    src.close()
    for layer, (a, b) in enumerate(zip(got, _tables(tiers, ccfg))):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), layer


class _Stalled(collab.ForwardExperts):
    """The lookahead with both streams held back at every layer."""

    def read(self, layer):
        _sleep_on(self.tiers.copy.stream)
        out = super().read(layer)
        torch.cuda._sleep(STALL)
        return out


class _OneLayer:
    """Each layer's table read when the layer asks, nothing ahead."""

    def __init__(self, tiers, ccfg):
        self.tiers, self.ccfg = tiers, ccfg

    def read(self, layer):
        table, resident = collab.forward_experts(self.tiers, layer,
                                                 self.ccfg)
        return table, resident, 0

    def close(self):
        pass


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["lru", "random"])
def test_stalled_forward_is_bitwise_the_plain_one(card, policy):
    """The static batch's forward of two prompts with the stalled
    lookahead and with each layer's table read when it asks: the same
    logits and KV, bit for bit."""
    engine = _engine(policy)
    tokens = torch.randint(1, CFG.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(3))
    outs = []
    for source in (_Stalled, _OneLayer):
        with mock.patch.object(collab, "ForwardExperts", source):
            logits, state = engine.prefill(tokens.numpy())
        kv = state["scan"]["s0"]
        outs.append((logits, kv["k"], kv["v"]))
        torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
