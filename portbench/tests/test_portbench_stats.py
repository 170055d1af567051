"""The latency arithmetic: times from the due time, failures as misses."""

import math

from portbench import stats


def _row(due, sent, first, last, n, ok=True):
    return {"due": due, "sent": sent, "first": first, "last": last,
            "n_tokens": n, "ok": ok}


def test_ttft_counts_from_the_due_time_not_the_send():
    r = _row(due=10.0, sent=10.4, first=11.0, last=12.0, n=11)
    assert stats.ttft_s(r) == 1.0


def test_failed_request_is_over_every_limit():
    assert stats.ttft_s(_row(1.0, 1.0, None, None, 0, ok=False)) == math.inf
    assert stats.ttft_s(_row(1.0, 1.0, 2.0, 3.0, 5, ok=False)) == math.inf
    assert stats.tpot_s(_row(1.0, 1.0, 2.0, 3.0, 5, ok=False)) is None


def test_tpot_spreads_the_decode_over_the_tokens_after_the_first():
    r = _row(due=0.0, sent=0.0, first=1.0, last=3.0, n=5)
    assert stats.tpot_s(r) == 0.5
    assert stats.tpot_s(_row(0.0, 0.0, 1.0, 1.0, 1)) is None


def test_nearest_rank_percentile():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 0.95) == 95
    assert stats.percentile(vals, 0.5) == 50
    assert stats.percentile([3.0], 0.95) == 3.0
    assert stats.percentile([], 0.95) is None


def test_failures_push_the_tail_past_every_limit():
    ok = [0.1] * 94
    assert stats.percentile(ok + [math.inf] * 6, 0.95) == math.inf
    assert stats.percentile(ok + [math.inf] * 5 + [0.2], 0.95) == 0.2
