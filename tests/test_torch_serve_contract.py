"""The rest of the reference's OpenAI serving contract
(``tests/test_serve.py``) held against the port's ``ServingServer``.

The servers are ``tests/test_torch_serve.py``'s: a JAX server and a port
server over TINY in float32 with the same weights.  Each case keeps the
reference case's inputs and assertions; every greedy answer is also held
token-exact against the JAX server's answer to the same request (and the
dense greedy reference).  The admission cases build their own port
servers, as the reference's do.  The ``_TextAccum`` cases need no engine
and run the reference's own functions with ``serve`` pointed at the
port's module.
"""

import pathlib
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

from infinistore_tpu_torch.engine import InferenceEngine, Scheduler
from infinistore_tpu_torch.engine.engine import _truncate_logits
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.serve import ServingServer
from test_torch_serve import (PROMPT, TCFG, TPARAMS, ByteTok, _greedy_both,
                              _pair, _post, _sse, dense_greedy)

HERE = pathlib.Path(__file__).parent


@pytest.fixture(scope="module")
def servers():
    ref, srv = _pair("tiny-test")
    yield ref, srv
    for s in (ref, srv):
        s.close()


@pytest.fixture(scope="module")
def server(servers):
    return servers[1]


@pytest.fixture(scope="module")
def text_servers():
    ref, srv = _pair("tiny-text", tokenizer=ByteTok())
    yield ref, srv
    for s in (ref, srv):
        s.close()


@pytest.fixture(scope="module")
def text_server(text_servers):
    return text_servers[1]


def _port_engine():
    """A port engine as ``_pair`` builds it, for the cases that make their
    own servers."""
    eng = InferenceEngine(TPARAMS, TCFG, PagedCacheConfig(
        n_layers=TCFG.n_layers, n_kv_heads=TCFG.n_kv_heads,
        head_dim=TCFG.head_dim, n_blocks=64, block_tokens=4,
        dtype=torch.float32), device="cpu")
    eng.decode_chunk = 4
    return eng


def _stream_both(servers, body, path="/v1/completions"):
    """Stream a greedy request from the reference and the port: per choice
    index the concatenated token ids agree; returns the port's events."""
    ref_ev, ev = (_sse(s.port, body, path=path) for s in servers)

    def ids(events):
        out = {}
        for e in events:
            c = e["choices"][0]
            out.setdefault(c["index"], []).extend(c.get("token_ids", []))
        return out

    assert ids(ev) == ids(ref_ev)
    return ev


# ---------------------------------------------------------------------------
# backpressure and admission (own servers, as in the reference)
# ---------------------------------------------------------------------------


def test_max_queue_backpressure_429():
    """Admission control: past --max-queue requests answer 429 instead of
    queueing without bound; capacity frees as requests retire."""
    srv = ServingServer(_port_engine(), port=0, max_batch=2,
                        model_id="tiny-q", max_queue=2)
    srv.start()
    try:
        results = {}
        threads = []

        def post(i, body):
            results[i] = _post(srv.port, body, timeout=120)

        for i in range(6):
            t = threading.Thread(target=post, args=(
                i, {"prompt": PROMPT, "max_tokens": 32, "temperature": 0}))
            t.start()
            threads.append(t)
            if i < 2:
                time.sleep(0.3)  # let the first two enter the system
        for t in threads:
            t.join()
        statuses = [results[i][0] for i in range(6)]
        assert statuses[0] == 200 and statuses[1] == 200, statuses
        assert 429 in statuses, statuses
        want = dense_greedy(PROMPT, 32)
        for i in range(6):
            if results[i][0] == 200:
                assert results[i][1]["choices"][0]["token_ids"] == want
        status, body = _post(srv.port, {
            "prompt": PROMPT, "max_tokens": 2, "temperature": 0})
        assert status == 200, body
        assert body["choices"][0]["token_ids"] == want[:2]
    finally:
        srv.close()


def test_admission_depth_accounting():
    """The two depth checks see the right state at each handoff stage
    (the reference's case: popped items count against handler-side
    admission, the engine-side re-check does not count later arrivals)."""
    srv = ServingServer(_port_engine(), port=0, max_batch=2,
                        model_id="tiny-depth", max_queue=2)
    try:
        srv._submitting = 2
        with srv._cv:
            assert srv._over_depth_locked()
        assert not srv._sched_at_capacity()
        srv._submitting = 0
        srv._staged = [object(), object()]
        with srv._cv:
            assert srv._over_depth_locked()
        assert not srv._sched_at_capacity()
        srv._staged = []
        srv._scoring = 2
        with srv._cv:
            assert srv._over_depth_locked()
        assert srv._sched_at_capacity()
    finally:
        srv.httpd.server_close()


def test_scoring_respects_capacity_and_fault_class():
    """Echo/scoring requests answer 429 at capacity, and a runtime failure
    inside the scoring forward is a 500, not a 400."""
    eng = _port_engine()
    srv = ServingServer(eng, port=0, max_batch=2, model_id="tiny-cap",
                        max_queue=0)
    srv.start()
    try:
        status, body = _post(srv.port, {
            "prompt": PROMPT, "max_tokens": 0, "temperature": 0,
            "echo": True, "logprobs": 1,
        })
        assert status == 429, body
    finally:
        srv.close()

    srv = ServingServer(eng, port=0, max_batch=2, model_id="tiny-fault")
    srv.start()
    try:
        def boom(*a, **k):
            raise RuntimeError("injected scoring fault")

        srv.engine.prompt_logprobs = boom
        status, body = _post(srv.port, {
            "prompt": PROMPT, "max_tokens": 0, "temperature": 0,
            "echo": True, "logprobs": 1,
        })
        assert status == 500, body
        assert "scoring failed" in body["error"]
    finally:
        del srv.engine.prompt_logprobs
        srv.close()


# ---------------------------------------------------------------------------
# logprobs and n choices
# ---------------------------------------------------------------------------


def test_chat_logprobs_contract(text_servers):
    body = _greedy_both(text_servers, {
        "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 4, "temperature": 0,
        "logprobs": True, "top_logprobs": 3,
    }, path="/v1/chat/completions")
    choice = body["choices"][0]
    content = choice["logprobs"]["content"]
    assert len(content) == len(choice["token_ids"]) == 4
    for entry in content:
        assert isinstance(entry["token"], str)
        assert entry["logprob"] <= 0.0
        assert len(entry["top_logprobs"]) == 3
    status, _ = _post(text_servers[1].port, {
        "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 2, "top_logprobs": 3,
    }, path="/v1/chat/completions")
    assert status == 400


def test_streaming_n_choices(servers):
    want = dense_greedy(PROMPT, 5)
    events = _stream_both(servers, {
        "prompt": PROMPT, "max_tokens": 5, "temperature": 0, "n": 2,
    })
    per_choice: dict = {0: [], 1: []}
    finishes = {}
    for e in events:
        c = e["choices"][0]
        per_choice[c["index"]].extend(c["token_ids"])
        if c["finish_reason"]:
            finishes[c["index"]] = c["finish_reason"]
    assert per_choice[0] == want and per_choice[1] == want
    assert finishes == {0: "length", 1: "length"}


def test_streaming_n_choices_with_stop_no_duplicate_final(text_servers):
    """n=2 streaming with a stop string: each choice emits exactly ONE
    terminal chunk."""
    tok = text_servers[1].tokenizer
    full = dense_greedy(PROMPT, 8)
    stop_char = tok.decode([full[3]])
    body = _greedy_both(text_servers, {
        "prompt": PROMPT, "max_tokens": 8, "temperature": 0,
        "stop": stop_char,
    })
    want_ids = body["choices"][0]["token_ids"]
    events = _stream_both(text_servers, {
        "prompt": PROMPT, "max_tokens": 8, "temperature": 0, "n": 2,
        "stop": stop_char,
    })
    ids = {0: [], 1: []}
    finals = {0: 0, 1: 0}
    for e in events:
        c = e["choices"][0]
        ids[c["index"]].extend(c["token_ids"])
        if c["finish_reason"]:
            finals[c["index"]] += 1
    assert finals == {0: 1, 1: 1}
    assert ids[0] == want_ids and ids[1] == want_ids


def test_streaming_logprobs(servers):
    events = _stream_both(servers, {
        "prompt": PROMPT, "max_tokens": 4, "temperature": 0, "logprobs": 1,
    })
    ids, lp_tokens = [], []
    for e in events:
        c = e["choices"][0]
        ids.extend(c["token_ids"])
        lp = c.get("logprobs")
        if lp:
            lp_tokens.extend(lp["token_logprobs"])
    assert ids == dense_greedy(PROMPT, 4)
    assert len(lp_tokens) == 4
    assert all(x <= 0.0 for x in lp_tokens)


# ---------------------------------------------------------------------------
# completions and sampling parameters
# ---------------------------------------------------------------------------


def test_completion_matches_greedy(servers):
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 6, "temperature": 0,
    })
    assert body["choices"][0]["token_ids"] == dense_greedy(PROMPT, 6)
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 6


def test_eos_and_sampling_params(servers):
    ref = dense_greedy(PROMPT, 6)
    eos = ref[2]
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 6, "temperature": 0,
        "stop_token_ids": [eos],
    })
    toks = body["choices"][0]["token_ids"]
    cut = ref.index(eos)
    assert toks == ref[:cut + 1] and toks[-1] == eos
    assert body["choices"][0]["finish_reason"] == "stop"

    status, body = _post(servers[1].port, {
        "prompt": PROMPT, "max_tokens": 4, "temperature": 0.9,
        "top_p": 0.8, "top_k": 16,
    })
    assert status == 200
    toks = body["choices"][0]["token_ids"]
    assert len(toks) == 4 and all(0 <= t < TCFG.vocab_size for t in toks)


def test_param_validation_protects_batchmates(servers):
    """Out-of-range sampling params and impossible budgets are 400s at the
    door on both servers; the port serves on afterwards."""
    for bad in (
        {"prompt": PROMPT, "top_p": 1.5},
        {"prompt": PROMPT, "top_p": 0},
        {"prompt": PROMPT, "temperature": -1},
        {"prompt": PROMPT, "sample": "nucleus"},
        {"prompt": PROMPT, "top_k": -2},
        {"prompt": PROMPT, "max_tokens": 0},
        {"prompt": PROMPT, "max_tokens": 10_000},  # > total KV pages
        {"prompt": [0, 999999]},  # out of vocab
        {"prompt": [True, False]},  # bools are not token ids
    ):
        for srv in servers:
            status, body = _post(srv.port, bad)
            assert status == 400, (bad, body)
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 3, "temperature": 0})
    assert body["choices"][0]["token_ids"] == dense_greedy(PROMPT, 3)


def test_greedy_requests_normalize_stray_params(server):
    """temperature=0 normalizes stray top_k/top_p at submit time, so an
    all-greedy batch takes the minimal 'greedy' decode variant."""
    sched = server.sched
    assert isinstance(sched, Scheduler)
    a = sched.submit(PROMPT, 1, sample="greedy", top_p=0.9, top_k=7)
    b = sched.submit(PROMPT[:5], 1, sample="greedy", top_p=0.5)
    ra = next(r for r in sched.pending if r.req_id == a)
    rb = next(r for r in sched.pending if r.req_id == b)
    assert (ra.temperature, ra.top_k, ra.top_p) == (1.0, 0, 1.0)
    assert (rb.temperature, rb.top_k, rb.top_p) == (1.0, 0, 1.0)
    sched.pending.remove(ra)
    sched.pending.remove(rb)


# ---------------------------------------------------------------------------
# text accumulation: the reference's own cases, ``serve`` pointed at the port
# ---------------------------------------------------------------------------

_SERVE_IMPORT = re.compile(r"^(\s*from\s+)infinistore_tpu(\.serve\b)", re.M)
_TEXT_ACCUM_CASES = ("test_text_accum_stop_truncates_ids_and_text",
                     "test_text_accum_stop_at_char_zero",
                     "test_text_accum_no_stop_flush")


def _reference_serve_cases_against_the_port() -> types.ModuleType:
    path = HERE / "test_serve.py"
    src, n = _SERVE_IMPORT.subn(r"\1infinistore_tpu_torch\2",
                                path.read_text())
    assert n >= 4, n  # the module's ServingServer and each case's _TextAccum
    mod = types.ModuleType("port_test_serve")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_REF = _reference_serve_cases_against_the_port()
for _name in _TEXT_ACCUM_CASES:
    globals()[f"test_serve__{_name[5:]}"] = getattr(_REF, _name)


def test_text_accum_cases_use_the_ports_class():
    """The collected cases import ``_TextAccum`` from the port's module,
    and both tokenizers of the reference (incremental and plain) run."""
    import infinistore_tpu_torch.serve as port_serve

    assert _REF.ServingServer is port_serve.ServingServer
    for name in _TEXT_ACCUM_CASES:
        marks = getattr(getattr(_REF, name), "pytestmark", [])
        params = [m.args[1] for m in marks if m.name == "parametrize"]
        assert params == [[_REF.ByteTok, _REF.PlainTok]], name


def test_truncate_logits_topk_topp_compose_sequentially():
    """top-p acts on the top-k-renormalized distribution: probs [0.4, 0.35,
    0.25] with top_k=2, top_p=0.5 keep ONLY the argmax."""
    l = torch.tensor(np.log([[0.4, 0.35, 0.25]]), dtype=torch.float32)
    out = _truncate_logits(l, torch.tensor([2], dtype=torch.int32),
                           torch.tensor([0.5], dtype=torch.float32)).numpy()
    assert np.isfinite(out[0, 0])
    assert not np.isfinite(out[0, 1]) and not np.isfinite(out[0, 2]), out


# ---------------------------------------------------------------------------
# text and stops
# ---------------------------------------------------------------------------


def test_text_prompt_round_trip(text_servers):
    tok = text_servers[1].tokenizer
    prompt = tok.decode(PROMPT)
    want = dense_greedy(tok.encode(prompt), 6)
    body = _greedy_both(text_servers, {
        "prompt": prompt, "max_tokens": 6, "temperature": 0,
    })
    choice = body["choices"][0]
    assert choice["token_ids"] == want
    assert choice["text"] == tok.decode(want)


def test_full_stop_token_ids_list_honored(text_servers):
    full = dense_greedy(PROMPT, 8)
    body = _greedy_both(text_servers, {
        "prompt": PROMPT, "max_tokens": 8, "temperature": 0,
        "stop_token_ids": [full[5], full[2]],
    })
    cut = min(full.index(full[5]), full.index(full[2]))
    assert body["choices"][0]["token_ids"] == full[: cut + 1]


def test_stop_string_truncates_before_match(text_servers):
    tok = text_servers[1].tokenizer
    full = dense_greedy(PROMPT, 8)
    stop_char = tok.decode([full[3]])
    first = tok.decode(full).index(stop_char)
    body = _greedy_both(text_servers, {
        "prompt": PROMPT, "max_tokens": 8, "temperature": 0,
        "stop": stop_char,
    })
    choice = body["choices"][0]
    assert choice["text"] == tok.decode(full)[:first]
    assert choice["token_ids"] == full[:first]
    assert body["usage"]["completion_tokens"] == first


def test_streaming_text_deltas(text_servers):
    tok = text_servers[1].tokenizer
    want = dense_greedy(PROMPT[:7], 8)
    events = _stream_both(text_servers, {
        "prompt": PROMPT[:7], "max_tokens": 8, "temperature": 0,
    })
    text = "".join(e["choices"][0].get("text", "") for e in events)
    assert text == tok.decode(want)


def test_streaming_ids_respect_stop_horizon(text_servers):
    tok = text_servers[1].tokenizer
    full = dense_greedy(PROMPT, 8)
    stop_char = tok.decode([full[3]])
    req = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0,
           "stop": stop_char}
    body = _greedy_both(text_servers, req)
    want_ids = body["choices"][0]["token_ids"]
    want_text = body["choices"][0]["text"]
    events = _stream_both(text_servers, req)
    ids, text = [], ""
    for e in events:
        choice = e["choices"][0]
        ids.extend(choice["token_ids"])
        text += choice.get("text", "") or ""
    assert text == want_text
    assert ids == want_ids


# ---------------------------------------------------------------------------
# echo and chat
# ---------------------------------------------------------------------------


def test_echo_contract(text_servers):
    text_server = text_servers[1]
    tok = text_server.tokenizer
    want = dense_greedy(PROMPT, 4)
    body = _greedy_both(text_servers, {
        "prompt": PROMPT, "max_tokens": 4, "temperature": 0, "echo": True,
    })
    choice = body["choices"][0]
    assert choice["token_ids"] == PROMPT + want
    assert choice["text"] == tok.decode(PROMPT) + tok.decode(want)
    assert body["usage"] == {
        "prompt_tokens": len(PROMPT), "completion_tokens": 4,
        "total_tokens": len(PROMPT) + 4,
    }
    s = tok.decode(PROMPT)
    body = _greedy_both(text_servers, {
        "prompt": s, "max_tokens": 4, "temperature": 0, "echo": True,
    })
    assert body["choices"][0]["text"].startswith(s)
    events = _stream_both(text_servers, {
        "prompt": PROMPT, "max_tokens": 4, "temperature": 0, "echo": True,
    })
    first = list(events[0]["choices"][0]["token_ids"])
    ids = [t for e in events for t in e["choices"][0]["token_ids"]]
    assert first == PROMPT
    assert ids == PROMPT + want
    status, _ = _post(text_server.port, {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 2,
        "echo": True,
    }, path="/v1/chat/completions")
    assert status == 400

    # pure echo: no KV pages touched, the counters stay balanced
    free_before = text_server.engine.free_pages
    req_before = text_server.stats["requests"]
    done_before = text_server.stats["completed"]
    status, body = _post(text_server.port, {
        "prompt": PROMPT, "max_tokens": 0, "temperature": 0, "echo": True,
    })
    assert status == 200, body
    assert body["choices"][0]["token_ids"] == PROMPT
    assert body["usage"]["completion_tokens"] == 0
    assert text_server.engine.free_pages == free_before
    assert text_server.stats["requests"] == req_before + 1
    assert text_server.stats["completed"] == done_before + 1


def test_chat_completions_streaming(text_servers):
    tok = text_servers[1].tokenizer
    messages = [{"role": "user", "content": "yo"}]
    want = dense_greedy(tok.encode("user: yo\nassistant:"), 6)
    ref_ev, events = (
        _sse(s.port, {"messages": messages, "max_tokens": 6,
                      "temperature": 0}, path="/v1/chat/completions")
        for s in text_servers)
    got = {}
    for name, evs in (("ref", ref_ev), ("port", events)):
        content, roles = "", []
        for d in evs:
            assert d["object"] == "chat.completion.chunk"
            delta = d["choices"][0]["delta"]
            content += delta.get("content", "")
            if "role" in delta:
                roles.append(delta["role"])
        got[name] = (content, roles)
    content, roles = got["port"]
    assert content == tok.decode(want)
    assert roles == ["assistant"]
    assert got["ref"] == got["port"]


def test_chat_requires_tokenizer(server):
    status, body = _post(server.port, {
        "messages": [{"role": "user", "content": "x"}], "max_tokens": 2,
    }, path="/v1/chat/completions")
    assert status == 400 and "tokenizer" in body["error"]


def test_stop_string_requires_tokenizer(server):
    status, body = _post(server.port, {
        "prompt": PROMPT, "max_tokens": 2, "stop": ["x"],
    })
    assert status == 400 and "tokenizer" in body["error"]


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------


def test_top_p_values_share_one_decode_graph_key():
    """top_p is a per-row device value: four distinct values take ONE
    decode graph key (the counterpart of the reference's single entry in
    ``_decode_many_cache``), so a client's value never captures a graph."""
    eng = _port_engine()
    eng.decode_chunk = 32  # the engine default, as the reference's case
    for i, p in enumerate((0.9, 0.91, 0.905, 0.5)):
        st = eng.prefill(PROMPT[: 5 + i])
        eng.decode(st, 2, sample="categorical", top_p=p,
                   rng=torch.Generator().manual_seed(i))
        eng.release(st)
    assert len(eng._graphs) == 1, sorted(eng._graphs)
    (key,) = eng._graphs
    assert key[0] == 1 and key[2:5] == ("filter", 0, False), key
