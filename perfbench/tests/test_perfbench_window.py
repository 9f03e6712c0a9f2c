"""The window's arithmetic, by hand, and a stall injected into a window."""
import pytest

from perfbench import window
from perfbench.window import Served


def steady(n_req=4, tokens=10, step=0.05, t_first=0.2, start=0.0):
    """Closed-loop requests back to back: each waits t_first for its first
    token, then one token each ``step``."""
    out, t = [], start
    for i in range(n_req):
        s = Served(index=i, prompt_len=100, t_send=t)
        s.times = [t + t_first + k * step for k in range(tokens)]
        s.tokens = list(range(tokens))
        out.append(s)
        t = s.times[-1]
    return out, t


def test_hand_counts():
    served, end = steady()
    m = window.end_to_end(served, 0.0, end)
    assert m["tok_s"] == pytest.approx(40 / end)
    assert m["tpot_ms"] == pytest.approx(50.0)
    assert m["itl_p95_ms"] == pytest.approx(50.0)
    assert m["ttft_ms"] == pytest.approx(200.0)


def test_only_what_lies_in_the_window_counts():
    s = Served(index=0, prompt_len=10, t_send=0.5)
    s.times = [1.0, 1.1, 1.3, 2.5]
    assert window.tokens_in([s], 1.05, 2.0) == 2
    assert window.gaps([s], 1.05, 2.0) == [pytest.approx(0.2)]
    assert window.ttfts([s], 1.05, 2.0) == []
    assert window.ttfts([s], 0.0, 2.0) == [pytest.approx(0.5)]
    assert window.decode_positions([s], 1.05, 3.0) == [11, 12, 13]


def test_an_empty_window_reads_none():
    m = window.end_to_end([], 0.0, 1.0)
    assert m["tok_s"] == 0 and m["tpot_ms"] is None
    assert m["ttft_ms"] is None and m["itl_p95_ms"] is None


def test_a_stall_moves_tpot_tail_and_rate():
    """One 2 s stall in one request's decode (the host held up) raises the
    mean gap and the 95th percentile, and lowers the tokens a second."""
    base, end = steady(n_req=8, tokens=40)
    stalled, _ = steady(n_req=8, tokens=40)
    s = stalled[3]
    k = 20
    s.times = s.times[:k] + [t + 2.0 for t in s.times[k:]]
    for later in stalled[4:]:
        later.t_send += 2.0
        later.times = [t + 2.0 for t in later.times]
    a = window.end_to_end(base, 0.0, end)
    b = window.end_to_end(stalled, 0.0, end)
    assert b["tpot_ms"] > a["tpot_ms"] * 1.05
    assert b["tok_s"] < a["tok_s"] * 0.95
    # the tail moves where stalls are more than 5% of the gaps: every
    # tenth token of a request held up another 0.5 s
    tail, t = [], 0.0
    for i in range(8):
        r = Served(index=i, prompt_len=100, t_send=t)
        for k in range(40):
            t += 0.05 + (0.5 if k % 10 == 9 else 0.0)
            r.times.append(t)
        tail.append(r)
    c = window.end_to_end(tail, 0.0, t)
    assert c["itl_p95_ms"] > a["itl_p95_ms"] * 5
    assert c["tpot_ms"] > a["tpot_ms"] and c["tok_s"] < a["tok_s"]
