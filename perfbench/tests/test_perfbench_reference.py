"""The plain reference against ``repro_torch`` on a tiny Mixtral-shaped
configuration on the CPU, on the same weights (only this test imports the
port; the reference never does)."""
import numpy as np
import pytest
import torch

from perfbench import harness, traffic, weights
from perfbench.reference import moe_lm
from perfbench.systems import collaborative_engine as ce
from perfbench.tests import tiny

# bf16 against float32: the port rounds every product, norm and logit to
# bf16 (2^-8 relative); logits here are of size 1-4, and two layers of
# rounding move them by a few of their ulps (2^-6 at 2-4)
LOGIT_TOL = 0.1
# a pick whose router logit lies this close to the next expert's can go
# either way under bf16 rounding (the router's logits move by ~0.005)
NEAR_TIE = 0.01


def setup(tmp_path, seed, mix=None):
    cell = tiny.cell(tmp_path, mix=mix)
    cfg = harness.load_config(cell)
    m = traffic.load_mix(cell.traffic_file)
    params = weights.draw(cfg, seed, "cpu")
    engine, _ = ce.build(cfg, m, params, seed, torch.device("cpu"))
    return cfg, m, params, engine


def first_near_tie(routes, K):
    """The first position at which some layer's k-th and (k+1)-th router
    logits lie within NEAR_TIE (a pick rounding may flip; its row and,
    through the KV, every later row may differ by far more than
    rounding), or None."""
    first = None
    for lg in routes:
        s = lg.sort(-1, descending=True).values
        near = torch.nonzero(s[:, K - 1] - s[:, K] < NEAR_TIE)
        if near.numel():
            p = int(near[0, 0])
            first = p if first is None else min(first, p)
    return first


@pytest.mark.parametrize("seeds", [tuple(range(12)) + (2 ** 31 + 3,)])
def test_prefill_and_decode_logits_match_the_port(tmp_path, seeds):
    """Prompts through the engine's admission (prefill forward and the
    warming replay) and then teacher-forced decode steps through the
    tiers, against one causal pass of the reference, every row up to the
    first pick that lies within NEAR_TIE of a tie in the reference."""
    checked = 0
    for seed in seeds:
        checked += _match_rows(tmp_path / str(seed), seed)
    assert checked >= 20


def _match_rows(tmp_path, seed):
    tmp_path.mkdir()
    cfg, mix, params, eng = setup(tmp_path, seed, mix={"clients": 1})
    rng = np.random.default_rng(seed)
    P, n = 20, 10
    seq = rng.integers(0, cfg["vocab_size"], P + n)
    t = eng.start_prefill(seq[:P])
    eng.advance_prefill(t, t.n_chunks)
    state = eng.init_slots()
    eng.write_slot(state, t.state, 0)
    rows = [t.logits[0, 0].float()]
    for i in range(n - 1):
        lg, state = eng.decode_batch(np.array([[seq[P + i]]]), state,
                                     np.array([True]))
        rows.append(lg[0, 0].float())
    got = torch.stack(rows)
    routes = []
    want = moe_lm.forward(params, cfg, [(seq[:P + n - 1], P)], mix.capacity,
                          "cpu", routes=routes)[0]
    assert eng.stats.hits > 0 and eng.stats.fetched_experts > 0
    tie = first_near_tie(routes, cfg["num_experts_per_tok"])
    keep = n if tie is None else max(0, tie - (P - 1))
    if keep:
        assert float((got - want)[:keep].abs().max()) <= LOGIT_TOL
        assert torch.equal(got[:keep].argmax(-1), want[:keep].argmax(-1))
    return keep


def test_prompt_picks_past_an_experts_capacity_drop_as_in_the_port(tmp_path):
    """At a KV capacity whose padded prompt has more than 256 picks, the
    admission forward caps each expert at C assignments in token order.
    Every token prefers expert 0 here, so the prompt's later tokens lose
    it: the reference with the cap agrees with the port, without it
    not. The prompt repeats one token, so every row of every layer sees
    the same values and routes alike."""
    mix = {"clients": 1, "prompt_tokens": {"lo": 8, "hi": 120},
           "capacity": 160}
    cfg, m, params, eng = setup(tmp_path, 5, mix=mix)
    C = moe_lm.prefill_capacity(m.capacity, 2, 8, cfg["prefill_dispatch"])
    assert C == 56
    P = 100
    prompt = np.full(P, 17, np.int64)
    got, _ = eng.prefill(prompt[None])
    want = moe_lm.forward(params, cfg, [(prompt, P)], m.capacity, "cpu")[0]
    assert float((got[0, 0].float() - want[0]).abs().max()) <= LOGIT_TOL
    loose = dict(cfg, prefill_dispatch=dict(cfg["prefill_dispatch"],
                                            capacity_factor=8.0))
    uncapped = moe_lm.forward(params, loose, [(prompt, P)], m.capacity,
                              "cpu")[0]
    assert float((got[0, 0].float() - uncapped[0]).abs().max()) > \
        10 * LOGIT_TOL


def test_keep_counts_picks_in_token_order():
    top_i = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 3], [0, 1]])
    keep = moe_lm._keep(top_i, P=4, E=4, C=2)
    assert keep.tolist() == [[True, True], [True, True], [True, False],
                             [False, True], [True, True]]


def test_fp8_control_rounds_every_matrix():
    w = torch.randn(64, 32, dtype=torch.bfloat16)
    q = moe_lm._fp8(w, -2)
    err = (q - w.float()).abs() / w.float().abs().amax(0, keepdim=True)
    assert 0 < float(err.max()) <= 2 ** -4
    assert moe_lm._mat(w, "cpu", "fp32").dtype == torch.float32
