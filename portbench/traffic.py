"""The one traffic generator: a mix's data file in, a seeded plan out.

A traffic mix is a JSON file under ``portbench/traffic/`` holding only
parameters.  ``plan(mix, seed, window_s, vocab)`` turns it into what the
load generator sends; it is pure (no clock, no I/O), so the same seed gives
the same plan.

Every seed gets the same multiset of sizes, turn counts, think times and
inter-arrival gaps: each is laid out at fixed quantiles of its distribution
and only its order, and the token ids, come from the seed.  Two seeds then
offer the same work in another order, which keeps run-to-run spread down to
what the system itself adds.  A session mix with ``schedule_seed`` takes
its order from that seed instead: every run seed offers the same sessions
at the same times with other tokens.

Two loops:

* ``open_sessions``: sessions arrive open-loop (exponential gaps at
  ``session_rate`` per second); a session belongs to a tenant (Zipf over
  ``tenants.system_tokens``, whose entry is that tenant's system-prompt
  length) and has 1..n turns; turn k's prompt is the system prompt, every
  earlier user run and served answer, and its own user run.  A turn is due
  ``think_s`` after the previous turn's last token.
* ``closed``: ``clients`` clients each send their next request as soon as
  their last one ends; prompts are unique.

``greedy_every``: every n-th session (or request) decodes greedily, so the
served tokens can be checked against the reference; the others sample with
``sampling`` and a per-request seed.
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist
from typing import Any, Dict, List

_NORMAL = NormalDist()


def quantile_grid(spec: Dict[str, Any], n: int) -> List[int]:
    """``n`` sizes at the mid-quantiles (i + 0.5) / n of ``spec``'s
    distribution (``lognormal``: median, sigma; ``uniform``: min..max),
    clipped to [min, max], ascending."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            v = spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(u))
        elif spec["dist"] == "uniform":
            v = lo + u * (hi - lo + 1) - 0.5
        else:
            raise ValueError(f"unknown distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(v)))))
    return out


def uniform_grid(lo: float, hi: float, n: int) -> List[float]:
    return [lo + (i + 0.5) / n * (hi - lo) for i in range(n)]


def exponential_gaps(n: int, span_s: float) -> List[float]:
    """``n`` inter-arrival gaps at the mid-quantiles of an exponential,
    scaled so that they sum to ``span_s``."""
    g = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    s = sum(g)
    return [x * span_s / s for x in g]


def zipf_counts(n_tenants: int, s: float, n: int) -> List[int]:
    """How many of ``n`` sessions each tenant rank gets under Zipf(s):
    largest remainder, so the counts sum to ``n``."""
    w = [1.0 / (r + 1) ** s for r in range(n_tenants)]
    tot = sum(w)
    exact = [n * x / tot for x in w]
    counts = [int(x) for x in exact]
    order = sorted(range(n_tenants), key=lambda r: exact[r] - counts[r],
                   reverse=True)
    for r in order[: n - sum(counts)]:
        counts[r] += 1
    return counts


def _ids(rng: random.Random, n: int, vocab: int) -> List[int]:
    return [rng.randrange(vocab) for _ in range(n)]


def _sampling(mix: Dict[str, Any], greedy: bool,
              rng: random.Random) -> Dict[str, Any]:
    if greedy:
        return {"temperature": 0.0}
    return {**mix["sampling"], "seed": rng.randrange(2 ** 31)}


def plan(mix: Dict[str, Any], seed: int, window_s: float,
         vocab: int) -> Dict[str, Any]:
    """The seeded plan of one run of ``mix`` over a window of
    ``window_s`` seconds."""
    rng = random.Random(seed)
    if mix["loop"] == "open_sessions":
        return _plan_sessions(mix, rng, window_s, vocab)
    if mix["loop"] == "closed":
        return _plan_closed(mix, rng, window_s, vocab)
    raise ValueError(f"unknown loop {mix['loop']!r}")


def _plan_sessions(mix, rng, window_s, vocab):
    # the tenants' system prompts come first from the seed, so they do not
    # depend on the rate or the window (the warm-up serves them once)
    systems = mix["tenants"]["system_tokens"]
    system_ids = [_ids(rng, t, vocab) for t in systems]
    n = max(1, int(round(mix["session_rate"] * window_s)))
    # ``schedule_seed`` fixes the order too: every run seed then offers the
    # same sessions at the same times, and draws only the tokens
    order = (random.Random(mix["schedule_seed"]) if "schedule_seed" in mix
             else rng)
    lo_t, hi_t = mix["turns"]
    turns = [lo_t + i % (hi_t - lo_t + 1) for i in range(n)]
    order.shuffle(turns)
    n_turns = sum(turns)

    def shuffled(values):
        values = list(values)
        order.shuffle(values)
        return values

    users = shuffled(quantile_grid(mix["user_tokens"], n_turns))
    answers = shuffled(quantile_grid(mix["answer_tokens"], n_turns))
    thinks = shuffled(uniform_grid(*mix["think_s"], n_turns))
    tenant_of = shuffled(
        r for r, c in enumerate(zipf_counts(len(systems),
                                            mix["tenants"]["zipf_s"], n))
        for _ in range(c))
    # the last session arrives half a mean gap before the window closes
    gaps = shuffled(exponential_gaps(n, window_s * (n - 0.5) / n))
    sessions, t, k = [], 0.0, 0
    every = mix.get("greedy_every", 0)
    for i in range(n):
        t += gaps[i]
        greedy = bool(every) and i % every == 0
        session_turns = []
        for _ in range(turns[i]):
            session_turns.append({
                "user": _ids(rng, users[k], vocab),
                "max_tokens": answers[k],
                "think_s": round(thinks[k], 6),
                "sampling": _sampling(mix, greedy, rng),
            })
            k += 1
        sessions.append({"id": f"s{i:05d}", "arrival_s": round(t, 6),
                         "tenant": tenant_of[i], "greedy": greedy,
                         "turns": session_turns})
    return {"loop": "open_sessions", "system": system_ids,
            "sessions": sessions}


def _plan_closed(mix, rng, window_s, vocab):
    clients = int(mix["clients"])
    # enough requests for every client to keep sending through the window
    # at the fastest rate the mix allows (one request per client per
    # ``min_request_s``)
    per_client = int(math.ceil(window_s / mix["min_request_s"])) + 1
    block = clients
    reqs = []
    every = mix.get("greedy_every", 0)
    for b in range(per_client):
        prompts = quantile_grid(mix["prompt_tokens"], block)
        answers = quantile_grid(mix["answer_tokens"], block)
        rng.shuffle(prompts)
        rng.shuffle(answers)
        for j in range(block):
            i = b * block + j
            greedy = bool(every) and i % every == 0
            reqs.append({"id": f"r{i:06d}", "client": j,
                         "prompt_len": prompts[j], "max_tokens": answers[j],
                         "greedy": greedy,
                         "sampling": _sampling(mix, greedy, rng),
                         "token_seed": rng.randrange(2 ** 63)})
    return {"loop": "closed", "clients": clients, "requests": reqs}


def context_range(mix: Dict[str, Any]) -> tuple:
    """The shortest and longest context (prompt and answer) a request of
    ``mix`` can reach."""
    if mix["loop"] == "open_sessions":
        systems = mix["tenants"]["system_tokens"]
        turn = mix["user_tokens"]["max"] + mix["answer_tokens"]["max"]
        return (min(systems) + mix["user_tokens"]["min"],
                max(systems) + mix["turns"][1] * turn)
    return (mix["prompt_tokens"]["min"],
            mix["prompt_tokens"]["max"] + mix["answer_tokens"]["max"])


def prompt_max(mix: Dict[str, Any]) -> int:
    """The longest prompt a request of ``mix`` can send."""
    if mix["loop"] == "open_sessions":
        n = mix["turns"][1]
        return (max(mix["tenants"]["system_tokens"])
                + n * mix["user_tokens"]["max"]
                + (n - 1) * mix["answer_tokens"]["max"])
    return mix["prompt_tokens"]["max"]


def prompt_ids(req: Dict[str, Any], vocab: int) -> List[int]:
    """A closed-loop request's unique prompt, drawn from its own seed
    (drawn where it is sent, so a plan stays small)."""
    return _ids(random.Random(req["token_seed"]), req["prompt_len"], vocab)
