"""The seeded generator and the tails read from the clients' stamps."""

import json
from types import SimpleNamespace

import pytest

from port_bench import tails
from port_bench.cells import ROOT
from port_bench.generator import Traffic, strata, trace_rows

BIG_SEED = 2**31 + 12345   # more than 32 signed bits hold


def mix(name):
    path = ROOT / "traffic" / f"{name}.json"
    if not path.exists():
        path = ROOT / "tests" / "traffic" / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def closed_requests(params, seed, n_next=20):
    t = Traffic(params, seed, ROOT)
    first = t.first_requests()
    nxt = [t.next_request(i % t.clients) for i in range(n_next)]
    return first, nxt, t


@pytest.mark.parametrize("name", ["prefill-long",
                                  "tiny-resid"])
def test_closed_loop_same_seed_same_requests(name):
    a = closed_requests(mix(name), BIG_SEED)
    b = closed_requests(mix(name), BIG_SEED)
    assert [r.__dict__ for r in a[0] + a[1]] == [r.__dict__
                                                 for r in b[0] + b[1]]
    ta, tb = a[2], b[2]
    assert [ta.token_ids(r, 64000) for r in a[0][:2]] == [
        tb.token_ids(r, 64000) for r in b[0][:2]]


@pytest.mark.parametrize("name", ["prefill-long",
                                  "tiny-resid"])
def test_closed_loop_seeds_change_the_tokens_not_the_work(name):
    """Another seed: the same sizes in the same order, other token ids."""
    p = mix(name)
    a, b = Traffic(p, 1, ROOT), Traffic(p, BIG_SEED, ROOT)
    assert a.pool == b.pool
    ra, rb = a.first_requests()[0], b.first_requests()[0]
    assert ra.__dict__ == rb.__dict__
    assert a.token_ids(ra, 64000) != b.token_ids(rb, 64000)


def test_prefill_long_sizes():
    t = Traffic(mix("prefill-long"), 5, ROOT)
    assert sorted(p for p, _ in t.pool) == strata(16384, 65536, 8)
    assert all(o == round(p / 100) for p, o in t.pool)
    assert all(16384 <= p <= 65536 for p, _ in t.pool)


def test_an_unknown_kind_or_distribution_is_refused():
    with pytest.raises(ValueError, match="unknown traffic kind"):
        Traffic({"kind": "no_such_kind"}, 1, ROOT)
    with pytest.raises(KeyError, match="length distribution"):
        Traffic({"kind": "closed_loop", "clients": 2,
                 "prompt": {"no_such_dist": [1, 2]},
                 "output": {"per_prompt": 0.1}}, 1, ROOT)


def test_residual_start():
    """Each first request starts partway through its output: its prompt
    carries the share u already generated, it generates the rest; the
    shares are one stratified set, shuffled once."""
    p = mix("tiny-resid")
    t = Traffic(p, BIG_SEED, ROOT)
    pool = list(t.pool)
    first = t.first_requests()
    n = t.clients
    done = []
    for i, r in enumerate(first):
        prompt, out = pool[i]
        assert r.prompt_len + r.max_tokens == prompt + out
        assert 1 <= r.max_tokens <= out
        done.append((r.prompt_len - prompt) / out)
    want = [(i + 0.5) / n for i in range(n)]
    assert sorted(done) == pytest.approx(want, abs=1.0 / min(
        o for _, o in pool) + 1e-9)
    # later requests start from scratch
    nxt = t.next_request(0)
    assert (nxt.prompt_len, nxt.max_tokens) in pool


def test_poisson_arrivals():
    p = mix("arxiv-poisson")
    t = Traffic(p, BIG_SEED, ROOT)
    reqs = t.arrivals(45.0)
    ramp = [r for r in reqs if r.due < 0]
    window = [r for r in reqs if r.due >= 0]
    assert len(window) == round(p["rate"] * 45.0)
    assert len(ramp) == round(p["rate"] * p["ramp_s"])
    assert all(-p["ramp_s"] <= r.due < 0 for r in ramp)
    assert all(0 <= r.due < 45.0 for r in window)
    again = Traffic(p, BIG_SEED, ROOT).arrivals(45.0)
    assert [r.__dict__ for r in again] == [r.__dict__ for r in reqs]
    other = Traffic(p, 7, ROOT).arrivals(45.0)
    assert [r.__dict__ for r in other] == [r.__dict__ for r in reqs]
    rows = trace_rows(ROOT / p["lengths"]["trace"], 256)
    assert {(r.prompt_len, r.max_tokens) for r in reqs} <= set(rows)


def rec(due, stamps, finished_at=None):
    return SimpleNamespace(due=due, stamps=stamps, finished_at=finished_at)


def test_every_gap_and_open_gap_counts():
    t_open, t_close = 10.0, 20.0
    records = [
        rec(0.0, [5.0, 11.0, 12.0], finished_at=12.0),   # one gap straddles
        rec(0.0, [12.0, 12.0, 15.0]),                    # running: open gap
        rec(0.0, [1.0, 2.0], finished_at=2.0),           # before the window
        rec(11.0, []),                                   # no token yet
        rec(0.0, [18.0, 25.0], finished_at=25.0),        # next token late
    ]
    gaps = tails.token_gaps(records, t_open, t_close)
    assert sorted(gaps) == sorted([6.0, 1.0, 0.0, 3.0, 5.0, 2.0])


def test_first_token_waits_count_the_unanswered():
    t_open, t_close = 10.0, 20.0
    records = [rec(9.0, [12.0]),           # due before the window
               rec(11.0, [13.5]),
               rec(15.0, []),              # unanswered: its age
               rec(19.0, [21.0])]          # answered after the close
    assert tails.first_token_waits(records, t_open, t_close) == [
        2.5, 5.0, 1.0]
    assert tails.unanswered(records, t_open, t_close) == 2
    assert tails.percentile([1.0, 2.0, 3.0], 50) == 2.0
    assert tails.percentile([], 90) is None

