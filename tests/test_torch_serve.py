"""The port's serving entry point (``infinistore_tpu_torch.serve``) against
the reference's on the CPU.

Both servers run TINY in float32 with the same weights (the reference's
``init_params``, carried over by ``params_from_jax``).  The OpenAI-contract
cases of ``tests/test_serve.py`` run against the port's ``ServingServer``,
and every greedy completion is held token-exact against the JAX server's
answer to the same request (and the dense greedy reference).  The step
profiler is held to the record fields and ``/debug/engine`` payload that
``tests/test_stepprof.py`` checks in the reference."""

import http.client
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_dense_greedy
from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu.serve import ServingServer as JServer
from infinistore_tpu_torch.engine import InferenceEngine
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import params_from_jax
from infinistore_tpu_torch.models import scaled as tscaled
from infinistore_tpu_torch.serve import ServingServer
from infinistore_tpu_torch.utils.metrics import (MetricsRegistry,
                                                 parse_prometheus_text)

torch.set_num_threads(2)

CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(7))
TPARAMS = params_from_jax(jax.tree.map(np.asarray, PARAMS), TCFG, "cpu")
PROMPT = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2]

dense_greedy = make_dense_greedy(PARAMS, CFG)


class ByteTok:
    """One token per character, id = codepoint (fits TINY's 512 vocab), with
    the incremental-detokenization surface the streaming path uses (the
    tokenizer of ``tests/test_serve.py``)."""

    def encode(self, s):
        return [min(ord(c), 511) for c in s]

    def decode(self, ids):
        return "".join(chr(t % 512) for t in ids)

    def convert_ids_to_tokens(self, ids):
        return [chr(t % 512) for t in ids]

    def convert_tokens_to_string(self, toks):
        return "".join(toks)


def _engines():
    jpc = JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
              head_dim=CFG.head_dim, n_blocks=64, block_tokens=4,
              dtype=CFG.dtype)
    tpc = PagedCacheConfig(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
                           head_dim=CFG.head_dim, n_blocks=64,
                           block_tokens=4, dtype=torch.float32)
    je = JEngine(PARAMS, CFG, jpc)
    te = InferenceEngine(TPARAMS, TCFG, tpc, device="cpu")
    je.decode_chunk = te.decode_chunk = 4
    return je, te


def _pair(model_id, **kw):
    """(reference server, port server) over the same weights.  Admission
    control is off while they are built: these tests hold the OpenAI
    contract, not the overload loop (the reference module's rule)."""
    old = os.environ.get("ISTPU_ADMISSION")
    os.environ["ISTPU_ADMISSION"] = "0"
    try:
        je, te = _engines()
        srvs = (JServer(je, port=0, max_batch=4, model_id=model_id, **kw),
                ServingServer(te, port=0, max_batch=4, model_id=model_id,
                              **kw))
        for s in srvs:
            s.start()
    finally:
        if old is None:
            os.environ.pop("ISTPU_ADMISSION", None)
        else:
            os.environ["ISTPU_ADMISSION"] = old
    return srvs


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


def _post(port, body, timeout=120, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _greedy_both(servers, body, path="/v1/completions"):
    """Post a greedy request to the reference and the port: both answer
    200 with the same token ids; returns the port's body."""
    (s_ref, b_ref), (s, b) = (_post(srv.port, body, path=path)
                              for srv in servers)
    assert s_ref == 200 and s == 200, (b_ref, b)
    assert [c["token_ids"] for c in b["choices"]] == \
        [c["token_ids"] for c in b_ref["choices"]]
    return b


def _sse(port, body, path="/v1/completions"):
    """The payloads of a streamed request, up to [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/event-stream")
    events, buf, done = [], b"", False
    while not done:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            assert event.startswith(b"data: ")
            payload = event[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            events.append(json.loads(payload))
    conn.close()
    assert done
    return events


# ---------------------------------------------------------------------------
# the OpenAI contract (tests/test_serve.py's cases, against the port)
# ---------------------------------------------------------------------------


def test_n_choices_and_usage(servers):
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 5, "temperature": 0, "n": 3,
    })
    assert [c["index"] for c in body["choices"]] == [0, 1, 2]
    want = dense_greedy(PROMPT, 5)
    assert all(c["token_ids"] == want for c in body["choices"])
    assert body["usage"] == {"prompt_tokens": len(PROMPT),
                             "completion_tokens": 15,
                             "total_tokens": len(PROMPT) + 15}
    status, body = _post(servers[1].port, {
        "prompt": PROMPT, "max_tokens": 16, "temperature": 5.0, "n": 4,
    })
    assert status == 200, body
    assert len({tuple(c["token_ids"]) for c in body["choices"]}) > 1


def test_completions_logprobs_contract(servers):
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 6, "temperature": 0, "logprobs": 2,
    })
    _s, ref = _post(servers[0].port, {
        "prompt": PROMPT, "max_tokens": 6, "temperature": 0, "logprobs": 2,
    })
    choice = body["choices"][0]
    assert choice["token_ids"] == dense_greedy(PROMPT, 6)
    lp = choice["logprobs"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 6
    assert len(lp["top_logprobs"]) == 6
    for chosen, top in zip(lp["token_logprobs"], lp["top_logprobs"]):
        assert len(top) == 2
        assert chosen == pytest.approx(max(top.values()), abs=1e-5)
        assert chosen <= 0.0
    ref_lp = ref["choices"][0]["logprobs"]
    np.testing.assert_allclose(lp["token_logprobs"], ref_lp["token_logprobs"],
                               atol=1e-5)
    for got, want in zip(lp["top_logprobs"], ref_lp["top_logprobs"]):
        assert got.keys() == want.keys()
    status, body = _post(servers[1].port, {
        "prompt": PROMPT, "max_tokens": 3, "temperature": 0, "logprobs": 0,
    })
    assert status == 200, body
    lp = body["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == 3
    assert all(t == {} for t in lp["top_logprobs"])


def test_logit_bias_contract(servers):
    want = dense_greedy(PROMPT, 1)
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 1, "temperature": 0,
        "logit_bias": {str(want[0]): -100},
    })
    assert body["choices"][0]["token_ids"][0] != want[0]
    forced = 77
    body = _greedy_both(servers, {
        "prompt": PROMPT, "max_tokens": 3, "temperature": 0,
        "logit_bias": {str(forced): 100},
    })
    assert body["choices"][0]["token_ids"] == [forced] * 3
    for bad in ({"logit_bias": {"999999": 1}}, {"logit_bias": {"3": 101}},
                {"logit_bias": {"x": 1}}, {"logit_bias": [1, 2]}):
        status, body = _post(servers[1].port, {
            "prompt": PROMPT, "max_tokens": 2, **bad,
        })
        assert status == 400, (bad, body)


def test_seed_contract(server):
    body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.9,
            "seed": 7}
    status, a = _post(server.port, body)
    assert status == 200, a
    _post(server.port, {"prompt": PROMPT, "max_tokens": 4,
                        "temperature": 0.9})
    status, b = _post(server.port, body)
    assert status == 200, b
    assert a["choices"][0]["token_ids"] == b["choices"][0]["token_ids"]
    status, c = _post(server.port, {**body, "seed": 8})
    assert status == 200, c
    assert c["choices"][0]["token_ids"] != a["choices"][0]["token_ids"]
    status, multi = _post(server.port, {**body, "n": 3})
    assert status == 200, multi
    outs = [tuple(ch["token_ids"]) for ch in multi["choices"]]
    assert len(set(outs)) == 3
    assert outs[0] == tuple(a["choices"][0]["token_ids"])
    status, multi2 = _post(server.port, {**body, "n": 3})
    assert [tuple(ch["token_ids"]) for ch in multi2["choices"]] == outs
    assert _post(server.port, {**body, "seed": -1})[0] == 400
    assert _post(server.port, {**body, "seed": True})[0] == 400


def test_sampling_penalties_contract(servers):
    want_plain = dense_greedy(PROMPT, 8)
    body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0,
            "repetition_penalty": 1.8, "presence_penalty": 0.5}
    outs = [_greedy_both(servers, body)["choices"][0]["token_ids"]
            for _ in range(2)]
    assert outs[0] == outs[1]
    assert outs[0] != want_plain
    for bad in ({"presence_penalty": 3.0}, {"frequency_penalty": -2.5},
                {"repetition_penalty": 0.0}, {"repetition_penalty": 11.0}):
        status, resp = _post(servers[1].port, {
            "prompt": PROMPT, "max_tokens": 2, **bad,
        })
        assert status == 400, (bad, resp)


def test_logprobs_validation(server):
    for bad in ({"logprobs": 9}, {"logprobs": "x"}, {"logprobs": True},
                {"n": 0}, {"n": 99},
                {"_chat": True, "logprobs": True, "top_logprobs": 8}):
        status, body = _post(server.port, {
            "prompt": PROMPT, "max_tokens": 2, **bad,
        })
        assert status == 400, (bad, body)


def test_streaming_sse_matches_batch(servers):
    req = {"prompt": PROMPT[:7], "max_tokens": 8, "temperature": 0}
    tokens = [t for ev in _sse(servers[1].port, req)
              for t in ev["choices"][0]["token_ids"]]
    assert tokens == dense_greedy(PROMPT[:7], 8)
    assert tokens == _greedy_both(servers, req)["choices"][0]["token_ids"]


def test_concurrent_clients_batched(servers):
    prompts = [PROMPT, PROMPT[:5], PROMPT[:8], list(reversed(PROMPT))]
    want = [dense_greedy(p, 5) for p in prompts]
    got = [None] * len(prompts)
    errs = []

    def worker(i):
        try:
            status, body = _post(servers[1].port, {
                "prompt": prompts[i], "max_tokens": 5, "temperature": 0,
            })
            assert status == 200, body
            got[i] = body["choices"][0]["token_ids"]
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errs, errs
    assert got == want


def test_bad_requests_rejected(server):
    status, body = _post(server.port, {"prompt": "text not ids"})
    assert status == 400 and "token ids" in body["error"]
    status, body = _post(server.port, {"prompt": []})
    assert status == 400
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/v1/completions", b"{not json", {})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    conn.close()


def test_models_and_metrics(server):
    status, data = _get(server.port, "/v1/models")
    assert status == 200
    assert json.loads(data)["data"][0]["id"] == "tiny-test"
    status, data = _get(server.port, "/metrics")
    text = data.decode()
    assert status == 200
    for family in ("istpu_serve_requests_total", "istpu_serve_free_kv_pages",
                   "istpu_serve_ttft_seconds", "istpu_serve_tpot_seconds",
                   "istpu_engine_dispatches_total",
                   "istpu_serve_slo_violations_total"):
        assert family in text, family


def test_metrics_ttft_split(servers):
    """/metrics separates queue-wait from prefill time, so a high TTFT is
    attributable; after a completion both gauges exist with sane values
    (the reference's case, its greedy answer held against the JAX
    server's)."""
    server = servers[1]
    _greedy_both(servers, {"prompt": PROMPT, "max_tokens": 4,
                           "temperature": 0})
    status, data = _get(server.port, "/metrics")
    text = data.decode()
    assert status == 200
    assert "istpu_serve_queue_wait_p50_ms" in text
    assert "istpu_serve_prefill_p50_ms" in text
    vals = {
        line.split()[0]: float(line.split()[1])
        for line in text.splitlines()
        if line and not line.startswith("#")
    }
    assert vals["istpu_serve_prefill_p50_ms"] > 0.0
    assert vals["istpu_serve_queue_wait_p50_ms"] >= 0.0
    assert server.sched.latency_metrics["window"] >= 1


def test_serving_with_store_attached_prefix_reuse(servers):
    """The serving front door composes with the store tier: a port engine
    with a store connection (relaxed durability, the serve default) and
    one-page prefill chunks (the compiled prefill body's K3 chunk, then K2
    over 4- and 8-row prefix buffers) answers the greedy completion the
    JAX server answers; after the durability barrier a SECOND engine on
    the same store reuses the prompt's prefix pages (the reference's
    cross-host prefix cache)."""
    from test_torch_frontdoor import port_store

    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM

    def mk_engine(c):
        return InferenceEngine(
            TPARAMS, TCFG,
            PagedCacheConfig(n_layers=TCFG.n_layers,
                             n_kv_heads=TCFG.n_kv_heads,
                             head_dim=TCFG.head_dim, n_blocks=64,
                             block_tokens=4, dtype=torch.float32),
            conn=c, model_id="serve-store", prefill_chunk=4,
            store_durability="relaxed", device="cpu")

    status, ref = _post(servers[0].port, {"prompt": PROMPT, "max_tokens": 6,
                                          "temperature": 0})
    assert status == 200, ref
    with port_store() as (service, _manage):
        conns = []
        try:
            for _ in range(2):
                c = lib.InfinityConnection(ClientConfig(
                    host_addr="127.0.0.1", service_port=service,
                    connection_type=TYPE_SHM))
                c.connect()
                conns.append(c)
            eng = mk_engine(conns[0])
            srv = ServingServer(eng, port=0, max_batch=2,
                                model_id="serve-store")
            srv.start()
            try:
                status, body = _post(srv.port, {
                    "prompt": PROMPT, "max_tokens": 6, "temperature": 0})
                assert status == 200, body
                toks = body["choices"][0]["token_ids"]
                assert toks == ref["choices"][0]["token_ids"]
                assert toks == dense_greedy(PROMPT, 6)
                eng.store_flush()  # the barrier before the "new host"
            finally:
                srv.close()
            assert {k[0] for k in eng._prefill_graphs} == {"causal",
                                                           "prefix"}
            eng2 = mk_engine(conns[1])
            st = eng2.prefill(PROMPT)
            assert st.reused_chunks == len(PROMPT) // 4
            eng2.release(st)
            for e in (eng, eng2):
                e.transfer.close()
        finally:
            for c in conns:
                c.close()


def test_disconnect_mid_stream_frees_pages(servers):
    server = servers[1]
    free_before = server.engine.free_pages
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt": PROMPT, "max_tokens": 64, "temperature": 0,
        "stream": True,
    }), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read1(16)
    conn.close()
    body = _greedy_both(servers, {"prompt": PROMPT[:5], "max_tokens": 4,
                                  "temperature": 0})
    assert body["choices"][0]["token_ids"] == dense_greedy(PROMPT[:5], 4)
    deadline = 30
    while server.engine.free_pages < free_before and deadline > 0:
        time.sleep(0.5)
        deadline -= 0.5
    assert server.engine.free_pages == free_before


def test_echo_logprobs_scoring_contract(text_servers):
    ref, srv = text_servers
    want = srv.engine.prompt_logprobs(PROMPT, k=2)
    ref_want = ref.engine.prompt_logprobs(PROMPT, k=2)
    for (c, _), (rc, _) in zip(want, ref_want):
        assert c == pytest.approx(rc, abs=1e-5)
    status, body = _post(srv.port, {
        "prompt": PROMPT, "max_tokens": 0, "temperature": 0,
        "echo": True, "logprobs": 2,
    })
    assert status == 200, body
    choice = body["choices"][0]
    assert choice["token_ids"] == PROMPT
    assert body["usage"]["completion_tokens"] == 0
    lp = choice["logprobs"]
    assert len(lp["token_logprobs"]) == len(PROMPT)
    assert lp["token_logprobs"][0] is None and lp["top_logprobs"][0] is None
    for got, (chosen, _top) in zip(lp["token_logprobs"][1:], want):
        assert got == pytest.approx(chosen, abs=1e-5)
    for got_top in lp["top_logprobs"][1:]:
        assert len(got_top) == 2
    status, body = _post(srv.port, {
        "prompt": PROMPT, "max_tokens": 3, "temperature": 0,
        "echo": True, "logprobs": 1,
    })
    assert status == 200, body
    lp = body["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == len(PROMPT) + 3
    assert lp["token_logprobs"][0] is None
    assert all(x is not None for x in lp["token_logprobs"][1:])
    events = _sse(srv.port, {"prompt": PROMPT, "max_tokens": 2,
                             "temperature": 0, "echo": True, "logprobs": 1})
    first_lp = next(ev["choices"][0]["logprobs"] for ev in events
                    if ev["choices"][0].get("logprobs"))
    assert len(first_lp["token_logprobs"]) == len(PROMPT)
    assert first_lp["token_logprobs"][0] is None
    assert _post(srv.port, {"prompt": PROMPT, "max_tokens": 0})[0] == 400


def test_chat_completions(text_servers):
    tok = text_servers[1].tokenizer
    want = dense_greedy(tok.encode("user: hi\nassistant:"), 5)
    body = _greedy_both(text_servers, {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
        "temperature": 0,
    }, path="/v1/chat/completions")
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["message"]["content"] == tok.decode(want)
    assert choice["token_ids"] == want


# ---------------------------------------------------------------------------
# the step profiler (tests/test_stepprof.py's fields, on the port)
# ---------------------------------------------------------------------------


def _prof(**kw):
    from infinistore_tpu_torch.engine.stepprof import StepProfiler

    kw.setdefault("metrics", MetricsRegistry())
    return StepProfiler(**kw)


def test_stepprof_record_shape_with_injected_clock():
    from infinistore_tpu_torch.engine import stepprof

    stamps = [10.0, 11.0, 11.0, 11.25]
    prof = _prof(sample=1, clock=lambda: stamps.pop(0) if stamps else 1e9,
                 block=lambda x: None, sentinel=lambda: object(),
                 mem_reader=lambda: {"live_bytes": 10, "peak_bytes": 20})
    with prof.step(kind_hint=None) as rec:
        stepprof.note_dispatch("decode")
        stepprof.note_dispatch("decode")
        stepprof.note_dispatch("prefill")
        stepprof.note_tokens(16)
        stepprof.note_capture("decode_step(8, 8)", 0.5)
    assert rec["step"] == 1 and rec["sampled"] is True
    assert rec["dur_s"] == pytest.approx(1.0)
    assert rec["host_stall_s"] == pytest.approx(0.25)
    assert rec["dispatches"] == {"decode": 2, "prefill": 1}
    assert rec["tokens"] == 16 and rec["kind"] == "mixed"
    assert rec["mem"] == {"live_bytes": 10, "peak_bytes": 20}
    assert rec["retraces"] == {"decode_step(8, 8)": 1}
    assert rec["compiles"] == 1 and rec["compile_s"] == pytest.approx(0.5)
    s = prof.summary()
    assert s["steps"] == 1 and s["dispatch_total"] == 3
    assert s["host_stall_frac"] == pytest.approx(0.25)
    assert s["compiles"] == 1 and s["retraces_total"] == 1
    stepprof.note_dispatch("decode")  # no active step: a no-op
    assert stepprof.current_step() is None


def test_stepprof_engine_hooks_count_real_dispatches():
    _je, eng = _engines()
    from infinistore_tpu_torch.engine.stepprof import default_mem_reader

    prof = _prof(sample=1, sentinel=lambda: eng.cache,
                 mem_reader=lambda: default_mem_reader(eng))
    with prof.step() as rec:
        st = eng.prefill(list(range(1, 10)))
    assert rec["dispatches"].get("prefill", 0) >= 1
    with prof.step() as rec2:
        eng.decode(st, 8)  # two chunks of 4
    assert rec2["dispatches"].get("decode") == 2
    assert rec2["syncs"] == {"decode_tokens": 2}
    assert rec2["tokens"] == 8 and rec2["kind"] == "decode"
    assert rec2["host_stall_s"] >= 0.0
    assert rec2["mem"]["live_bytes"] == eng.held_bytes() > 0
    eng.release(st)


def test_stepprof_ledger_step_ids_join_debug_engine(monkeypatch):
    """Every /debug/requests row's step_ids resolve against /debug/engine
    records, the sampled probe lands, the istpu_engine_* families ride
    /metrics and ?limit= caps the tail."""
    monkeypatch.setenv("ISTPU_STEPPROF_SAMPLE", "1")
    monkeypatch.setenv("ISTPU_ADMISSION", "0")
    _je, eng = _engines()
    srv = ServingServer(eng, port=0, max_batch=2, model_id="prof-serve")
    srv.start()
    try:
        for i in range(3):
            status, body = _post(srv.port, {
                "prompt": list(range(1 + i, 10 + i)), "max_tokens": 6,
                "temperature": 0,
            })
            assert status == 200, body
        recs = json.loads(_get(srv.port, "/debug/requests")[1])["records"]
        assert len(recs) == 3
        payload = json.loads(_get(srv.port, "/debug/engine")[1])
        assert payload["enabled"] and payload["summary"]["steps"] >= 1
        step_ids = {r["step"] for r in payload["records"]}
        for rec in recs:
            assert rec["step_ids"] and set(rec["step_ids"]) <= step_ids
        assert any(r.get("dispatches") for r in payload["records"])
        assert any("host_stall_s" in r for r in payload["records"])
        assert payload["summary"]["mem"]["cpu_fallback"] == 1
        names = {n for n, _l in parse_prometheus_text(
            _get(srv.port, "/metrics")[1].decode())}
        for family in ("istpu_engine_dispatches_total",
                       "istpu_engine_step_seconds_count",
                       "istpu_engine_host_stall_seconds_count",
                       "istpu_engine_syncs_total"):
            assert family in names, family
        limited = json.loads(_get(srv.port, "/debug/engine?limit=1")[1])
        assert limited["returned"] == 1
    finally:
        srv.close()


def test_device_trace_alias_lands_in_the_plane(tmp_path):
    """``utils.profiling.device_trace`` no longer raises: a span in the
    active trace, and with a directory a ``torch.profiler`` Chrome
    trace."""
    from infinistore_tpu_torch.utils import tracing
    from infinistore_tpu_torch.utils.profiling import device_trace

    with tracing.trace("alias.check") as tr:
        with device_trace():
            pass
        with device_trace(str(tmp_path)):
            torch.ones(4).sum()
    assert sum(ev[0] == "device_trace" for ev in tr.events) == 2
    assert json.loads((tmp_path / "trace.json").read_text())
