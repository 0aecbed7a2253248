"""The window's arithmetic on synthetic records: every stall moves the
rates and the tails, and an unanswered request counts."""

import pytest

from bench.window import RequestLog, p95, serve_numbers, train_numbers


def logs(stall_at=None, stall=0.0):
    """40 requests, issued every 0.25 s, a first token 0.1 s later and
    then one every 0.05 s for 9 more; from ``stall_at`` every later time
    waits ``stall`` longer."""
    out = []
    for i in range(40):
        issue = 0.25 * i
        times = [issue + 0.1 + 0.05 * j for j in range(10)]
        if stall_at is not None:
            times = [t + stall if t >= stall_at else t for t in times]
        out.append(RequestLog(i, issue, 100, 10, times))
    return out


def slowed(recs, at, factor):
    """Everything after ``at`` runs ``factor`` times slower."""
    def warp(t):
        return t if t < at else at + (t - at) * factor
    return [RequestLog(r.rid, warp(r.issue), r.prompt_len, r.max_new,
                       [warp(t) for t in r.token_times]) for r in recs]


def test_a_stall_moves_every_number():
    base = serve_numbers(logs(), 0.0, 10.0)
    stall = serve_numbers(logs(stall_at=5.0, stall=2.0), 0.0, 10.0)
    assert stall["serve_tokens_per_s"] < base["serve_tokens_per_s"]
    assert stall["ttft_p95_ms"] > base["ttft_p95_ms"]
    assert base["itl_p95_ms"] == pytest.approx(50.0)
    assert base["ttft_p95_ms"] == pytest.approx(100.0)
    # a stall the tail sees: more than a twentieth of the gaps wait
    slow = serve_numbers(slowed(logs(), 5.0, 2.0), 0.0, 10.0)
    assert slow["itl_p95_ms"] == pytest.approx(100.0)
    assert slow["ttft_p95_ms"] > base["ttft_p95_ms"]
    assert slow["serve_tokens_per_s"] < base["serve_tokens_per_s"]


def test_an_unanswered_request_counts_its_wait():
    recs = logs()
    waits = [RequestLog(100 + i, 9.0 - i * 1e-3, 100, 10)
             for i in range(10)]
    out = serve_numbers(recs + waits, 0.0, 10.0)
    assert out["attempted"] == 50
    assert out["ttft_p95_ms"] > 900.0
    failed = RequestLog(200, 1.0, 100, 10, failed=True)
    out = serve_numbers(recs + [failed], 0.0, 10.0)
    assert out["failed"] == 1 and out["attempted"] == 41


def test_tokens_count_inside_the_window_only():
    out = serve_numbers(logs(), 2.0, 4.0)
    # requests 8..15 first-token inside (2, 4]: their prompts, and every
    # token time inside the window
    inside = sum(1 for r in logs() for t in r.token_times if 2.0 < t <= 4.0)
    firsts = sum(1 for r in logs() if 2.0 < r.token_times[0] <= 4.0)
    assert out["serve_tokens_per_s"] == pytest.approx(
        (inside + 100 * firsts) / 2.0)


def test_train_rate_counts_every_step_and_second():
    ends = [2.0 * (i + 1) for i in range(10)]
    assert train_numbers(ends, 1000, 0.0)["train_tokens_per_s"] == 500.0
    stalled = ends[:5] + [t + 3.0 for t in ends[5:]]
    assert train_numbers(stalled, 1000, 0.0)["train_tokens_per_s"] < 500.0


def test_p95_is_the_tail():
    assert p95(list(range(101))) == pytest.approx(95.0)
