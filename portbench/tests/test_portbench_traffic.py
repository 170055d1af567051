"""The generator: the same seed gives the same plan; every seed offers the
same sizes in another order."""

import json
import os

from portbench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mix(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def _sizes(p):
    if p["loop"] == "open_sessions":
        turns = [t for s in p["sessions"] for t in s["turns"]]
        return (sorted(len(t["user"]) for t in turns),
                sorted(t["max_tokens"] for t in turns),
                sorted(len(s["turns"]) for s in p["sessions"]),
                sorted(s["tenant"] for s in p["sessions"]),
                sorted(round(t["think_s"], 6) for t in turns))
    return (sorted(r["prompt_len"] for r in p["requests"]),
            sorted(r["max_tokens"] for r in p["requests"]))


def test_same_seed_same_plan_and_seeds_share_sizes():
    for name in ("chat-shared-prefix", "batch-decode"):
        mix = _mix(name)
        a = traffic.plan(mix, 2 ** 40 + 7, 40.0, 151936)
        b = traffic.plan(mix, 2 ** 40 + 7, 40.0, 151936)
        c = traffic.plan(mix, 5, 40.0, 151936)
        assert json.dumps(a) == json.dumps(b)
        assert json.dumps(a) != json.dumps(c)
        assert _sizes(a) == _sizes(c)


def test_session_arrivals_fill_the_window():
    mix = _mix("chat-shared-prefix")
    p = traffic.plan(mix, 11, 40.0, 1000)
    arr = [s["arrival_s"] for s in p["sessions"]]
    assert len(arr) == round(mix["session_rate"] * 40)
    assert arr == sorted(arr) and 0 < arr[0] and arr[-1] < 40.0
    greedy = [s for s in p["sessions"] if s["greedy"]]
    assert len(greedy) == -(-len(arr) // mix["greedy_every"])
    assert all(t["sampling"] == {"temperature": 0.0}
               for s in greedy for t in s["turns"])


def test_mix_limits_hold():
    mix = _mix("chat-shared-prefix")
    p = traffic.plan(mix, 3, 40.0, 1000)
    for s in p["sessions"]:
        assert 1 <= len(s["turns"]) <= 4
        for t in s["turns"]:
            assert 16 <= len(t["user"]) <= 1024
            assert 32 <= t["max_tokens"] <= 512
            assert 2.0 <= t["think_s"] <= 10.0
    counts = traffic.zipf_counts(8, 1.1, 100)
    assert sum(counts) == 100 and counts == sorted(counts, reverse=True)


def test_closed_prompts_are_unique_and_repeat_per_seed():
    mix = _mix("batch-decode")
    p = traffic.plan(mix, 9, 10.0, 32000)
    r = p["requests"][5]
    a, b = traffic.prompt_ids(r, 32000), traffic.prompt_ids(r, 32000)
    assert a == b and len(a) == r["prompt_len"]
    assert a != traffic.prompt_ids(p["requests"][6], 32000)
    assert traffic.context_range(mix) == (128, 1664)


def test_system_prompts_do_not_depend_on_rate_or_window():
    mix = _mix("chat-shared-prefix")
    a = traffic.plan(mix, 21, 40.0, 1000)["system"]
    b = traffic.plan({**mix, "session_rate": 0.5}, 21, 1.0, 1000)["system"]
    assert a == b


def test_schedule_seed_fixes_the_order_and_leaves_the_tokens():
    mix = {**_mix("chat-shared-prefix"), "schedule_seed": 7}
    a = traffic.plan(mix, 1, 40.0, 1000)
    b = traffic.plan(mix, 2, 40.0, 1000)

    def shape(p):
        return [(s["arrival_s"], s["tenant"],
                 [(len(t["user"]), t["max_tokens"], t["think_s"])
                  for t in s["turns"]]) for s in p["sessions"]]

    assert shape(a) == shape(b)
    assert a["system"] != b["system"]
