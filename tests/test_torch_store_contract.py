"""The store path's engine-side contract, held against the port.

The reference's cases of ``tests/test_{push_parity,integrity,resilience,
stepprof,cache_analytics,trace_wire,observability,usage,store_tier}.py``
that drive an engine, a transfer engine or a serving server on the paper's
main path, run against the port's engine (TINY in float32, the reference's
weights through ``params_from_jax``) and the port's own store server
(``python -m infinistore_tpu_torch.server --backend python``).  Faults are
armed through that server's ``POST /faults`` manage endpoint.  Each case
keeps the reference case's inputs and assertions, and every decode is held
token-exact against ``conftest.make_dense_greedy`` on the JAX weights.
The two step-profiler cases that need no engine run the reference's own
functions with every ``infinistore_tpu`` import pointed at the port.
"""

import http.client
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu_torch import lib as ist
from infinistore_tpu_torch import usage as U
from infinistore_tpu_torch.engine import InferenceEngine, StoreConnector
from infinistore_tpu_torch.kv import (KVTransferEngine, PagedCacheConfig,
                                      chunk_keys, init_cache, read_pages,
                                      write_pages)
from infinistore_tpu_torch.serve import ServingServer
from infinistore_tpu_torch.utils import metrics as m
from infinistore_tpu_torch.utils import tracing
from test_observability import parse_prometheus  # the strict parser
from test_torch_serve import TCFG, TPARAMS, dense_greedy

HERE = pathlib.Path(__file__).parent
REPO = HERE.parent
T = 4
PROMPT = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2]


# ---------------------------------------------------------------------------
# the port's store server and clients
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _boot(port, mport, extra_args=(), extra_env=None):
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.server",
         "--service-port", str(port), "--manage-port", str(mport),
         "--prealloc-size", "1", "--minimal-allocate-size", "16",
         "--log-level", "warning", "--backend", "python", *extra_args],
        env={**os.environ, **(extra_env or {})}, cwd=REPO,
    )
    deadline = time.time() + 30
    for p in (port, mport):
        while True:
            if proc.poll() is not None:
                pytest.fail("store server failed to start")
            try:
                socket.create_connection(("127.0.0.1", p),
                                         timeout=0.5).close()
                break
            except OSError:
                if time.time() >= deadline:
                    proc.kill()
                    pytest.fail(f"store port {p} did not come up")
                time.sleep(0.1)
    return proc


def _stop(proc):
    # SIGTERM: SIGINT leaves either package's asyncio server up while a
    # client is connected (ROADMAP queue 3)
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _mpost(mport, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{mport}{path}", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _mget(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _arm(mport, rules):
    return _mpost(mport, "/faults", rules)


def _metrics_at(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        return m.parse_prometheus_text(r.read().decode())


def _wait_stamped(mport, timeout=10.0):
    """Block until every committed entry carries a checksum, so armed
    corruption is detected deterministically."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        rep = _mget(mport, "/debug/integrity")
        if rep["unverified"] == 0 and rep["stamp_backlog"] == 0:
            return rep
        time.sleep(0.05)
    pytest.fail("stamping backlog did not drain")


def _conn(port, ctype=ist.TYPE_SHM, op_timeout_s=5.0, **kw):
    # op_timeout_s pins the Python client (the integrity plane lives in
    # its channel layer)
    c = ist.InfinityConnection(ist.ClientConfig(
        host_addr="127.0.0.1", service_port=port, connection_type=ctype,
        log_level="error", op_timeout_s=op_timeout_s, **kw))
    c.connect()
    return c


def _failures(cause):
    parsed = m.parse_prometheus_text(
        m.default_registry().to_prometheus_text())
    return parsed.get(
        ("istpu_integrity_failures_total", (("cause", cause),)), 0.0)


def make_pc(n_blocks=64):
    return PagedCacheConfig(
        n_layers=TCFG.n_layers, n_kv_heads=TCFG.n_kv_heads,
        head_dim=TCFG.head_dim, n_blocks=n_blocks, block_tokens=T,
        dtype=torch.float32)


def _engine(conn=None, n_blocks=64, **kw):
    return InferenceEngine(TPARAMS, TCFG, make_pc(n_blocks), conn=conn,
                           device="cpu", **kw)


def _prompt(i):
    """Distinct same-length prompts (first token varies): a repeated
    prompt would hit the engine's local prefix cache, not the store."""
    assert i < 450, i
    return [50 + i] + PROMPT[1:]


def _post(port, body, timeout=180, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _ask_greedy(port, prompt, n):
    status, body = _post(port, {"prompt": prompt, "max_tokens": n,
                                "temperature": 0})
    assert status == 200, body
    assert body["choices"][0]["token_ids"] == dense_greedy(prompt, n), body
    return body


@pytest.fixture(scope="module")
def server():
    port, mport = _free_port(), _free_port()
    proc = _boot(port, mport)
    yield port, mport
    _stop(proc)


@pytest.fixture(autouse=True)
def _clear_faults(request):
    yield
    if "server" in request.fixturenames:
        try:
            _arm(request.getfixturevalue("server")[1], [])
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the push (tests/test_push_parity.py)
# ---------------------------------------------------------------------------


def _tiny_pages(seed):
    """The reference case's pages: jax.random.normal at its seed."""
    pages = jax.random.normal(jax.random.PRNGKey(seed),
                              (2, 2, 2, 2, 16, 16), jnp.float32)
    return torch.from_numpy(np.asarray(pages).copy())


def _tiny_pc():
    return PagedCacheConfig(n_layers=2, n_kv_heads=2, head_dim=16,
                            n_blocks=8, block_tokens=16, dtype=torch.float32)


@pytest.mark.parametrize("transport", ["shm", "tcp"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_push_path_parity_new_vs_legacy(server, transport, quant,
                                        monkeypatch):
    """Pages pushed by the alloc-first path and by the legacy path restore
    IDENTICAL bytes, integrity verification on end to end."""
    port, _ = server
    monkeypatch.setenv("ISTPU_CLIENT", "python")
    ctype = ist.TYPE_SHM if transport == "shm" else ist.TYPE_TCP
    pc = _tiny_pc()
    pages = _tiny_pages(11)
    cache = init_cache(pc, "cpu")
    write_pages(cache, torch.tensor([0, 1]), pages)
    restored = {}
    for mode in ("auto", "legacy"):
        wc = _conn(port, ctype, op_timeout_s=None)
        keys = chunk_keys(list(range(32)),
                          f"push-par-{transport}-{quant}-{mode}")
        eng = KVTransferEngine(wc, pc, quant=quant, push_mode=mode,
                               device="cpu")
        eng.save_pages(cache, [0, 1], keys)
        if mode == "auto" and transport == "tcp":
            assert eng.last_push_stages["staged_bands"] >= 1
        cache2 = KVTransferEngine(wc, pc, quant=quant, device="cpu") \
            .load_pages(init_cache(pc, "cpu"), [4, 5], keys)
        restored[mode] = read_pages(cache2, torch.tensor([4, 5])).numpy()
        wc.close()
    np.testing.assert_array_equal(restored["auto"], restored["legacy"])
    if quant is None:
        np.testing.assert_array_equal(restored["auto"], pages.numpy())


def test_staging_growth_does_not_accumulate_mrs(server, monkeypatch):
    """Growing a staging buffer releases the replaced buffer's
    registration: only the live buffers stay registered."""
    port, _ = server
    monkeypatch.setenv("ISTPU_CLIENT", "python")
    conn = _conn(port, op_timeout_s=None)
    try:
        eng = KVTransferEngine(conn, _tiny_pc(), device="cpu")
        for nbytes in (1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10):
            eng._ensure_staging(nbytes)
            eng._ensure_staging(nbytes)
            eng._ensure_push_staging(nbytes)
            eng._ensure_push_staging(nbytes)
        assert len(conn._mrs) == 4, conn._mrs
        assert len(conn.conn._registered) == 4
        live = {buf.data_ptr() for buf in eng._staging + eng._push_staging}
        assert {p for p, _ in conn._mrs} == live
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# integrity (tests/test_integrity.py)
# ---------------------------------------------------------------------------


def test_guarded_load_treats_verification_failure_as_miss(server):
    """A corrupt store prefix degrades to recompute with exact tokens; the
    failed pages are deleted, so the next engine misses cleanly, the
    recompute re-pushes them and a third engine adopts them again."""
    port, mport = server
    prod = _conn(port)
    a = _engine(prod, n_blocks=128, model_id="integ-eng")
    a.release(a.prefill(_prompt(0)))
    a.store_flush()
    _wait_stamped(mport)

    cons = _conn(port)
    b = _engine(cons, n_blocks=128, model_id="integ-eng")
    before = _failures("checksum") + _failures("lease")
    _arm(mport, [{"op": "GET_DESC", "action": "corrupt", "times": 1}])
    st = b.prefill(_prompt(0))
    assert st.reused_chunks == 0
    assert b.decode(st, 8) == dense_greedy(_prompt(0), 8)
    b.release(st)
    assert _failures("checksum") + _failures("lease") >= before + 1
    assert b.breaker.state == "closed"
    _arm(mport, [])
    _wait_stamped(mport)
    c2 = _conn(port)
    eng2 = _engine(c2, n_blocks=128, model_id="integ-eng")
    st2 = eng2.prefill(_prompt(0))
    assert st2.reused_chunks == 2
    assert eng2.decode(st2, 8) == dense_greedy(_prompt(0), 8)
    eng2.release(st2)
    for c in (prod, cons, c2):
        c.close()


@pytest.fixture(scope="module")
def integrity_stack():
    port, mport = _free_port(), _free_port()
    proc = _boot(port, mport)
    conn = _conn(port, op_timeout_s=2.0)
    eng = _engine(conn, n_blocks=128, model_id="integ-serve",
                  store_durability="relaxed")
    eng.decode_chunk = 4
    srv = ServingServer(eng, port=0, max_batch=4, model_id="integ-serve")
    srv.start()
    yield srv, proc, port, mport
    srv.close()
    conn.close()
    _stop(proc)


def test_corruption_chaos_serving_stays_byte_exact(integrity_stack):
    """With bit-flip faults armed against the live store every request
    answers 200 with exact greedy tokens, and the failure counter walks."""
    srv, _proc, port, mport = integrity_stack
    n = [300]

    def ask(prompt=None):
        p = prompt if prompt is not None else _prompt(n[0])
        if prompt is None:
            n[0] += 1
        return _ask_greedy(srv.port, p, 6)

    ask()
    prod_conn = _conn(port)
    prod = _engine(prod_conn, n_blocks=128, model_id="integ-serve")
    victims = [_prompt(400 + i) for i in range(3)]
    for v in victims:
        prod.release(prod.prefill(v))
    prod.store_flush()
    _wait_stamped(mport)

    before = _failures("checksum") + _failures("lease")
    _arm(mport, [{"op": "GET_DESC", "action": "corrupt"}])
    for v in victims:
        ask(v)
    for _ in range(3):
        ask()
    assert _failures("checksum") + _failures("lease") > before
    assert _metrics_at(mport).get(
        ("istpu_store_faults_injected_total",
         (("action", "corrupt"), ("op", "GET_DESC"))), 0) >= 1

    _arm(mport, [])
    for v in victims:
        ask(v)
    st, data = _get(srv.port, "/healthz")
    assert st == 200 and json.loads(data)["status"] == "ok"
    st, data = _get(srv.port, "/metrics")
    parsed = m.parse_prometheus_text(data.decode())
    total_fail = sum(v for (name, _l), v in parsed.items()
                     if name == "istpu_integrity_failures_total")
    assert total_fail >= 1
    prod_conn.close()


# ---------------------------------------------------------------------------
# degradation (tests/test_resilience.py)
# ---------------------------------------------------------------------------


def test_streamer_counts_drops_and_reports_them_at_flush(server):
    """A parked push error does not silently eat the pushes queued behind
    it: they are counted, and the flush-time re-raise names them."""
    port, _ = server
    conn = _conn(port)
    eng = _engine(conn, model_id="drop-count", prefill_chunk=T,
                  store_durability="relaxed")

    def boom(token):
        raise RuntimeError("push failed hard")

    eng.transfer.push_commit = boom
    key = ("istpu_store_push_dropped_total", (("reason", "push_error"),))
    before = m.parse_prometheus_text(
        m.default_registry().to_prometheus_text()).get(key, 0.0)
    st = eng.prefill(PROMPT)  # 2 complete chunks -> 2 failed pushes
    with pytest.raises(RuntimeError, match=r"push failed hard.*2 queued"):
        eng.store_flush()
    eng.store_flush()
    after = m.parse_prometheus_text(
        m.default_registry().to_prometheus_text())[key]
    assert after >= before + 1
    assert eng.decode(st, 4) == dense_greedy(PROMPT, 4)
    eng.release(st)
    conn.close()


def test_engine_degrades_to_recompute_and_circuit_opens(server):
    """A load killed mid-op falls back to recompute with exact tokens; a
    full outage opens the circuit, and then prefills skip the store."""
    port, mport = server
    prod = _conn(port)
    a = _engine(prod, model_id="chaos-eng")
    a.release(a.prefill(_prompt(0)))
    a.store_flush()

    cons = _conn(port, op_timeout_s=1.0)
    b = _engine(cons, model_id="chaos-eng", store_durability="relaxed")
    b.breaker.failure_threshold = 2
    b.breaker.cooldown_s = 30.0
    st = b.prefill(_prompt(1))
    assert b.decode(st, 8) == dense_greedy(_prompt(1), 8)
    b.release(st)
    b.store_flush()

    _arm(mport, [{"op": "GET_DESC", "action": "drop_conn"}])
    st = b.prefill(_prompt(0))
    assert st.reused_chunks == 0
    assert b.decode(st, 8) == dense_greedy(_prompt(0), 8)
    b.release(st)
    assert b.breaker.state == "closed"

    _arm(mport, [{"op": "*", "action": "error"}])
    for i in (2, 3):
        st = b.prefill(_prompt(i))
        assert st.reused_chunks == 0
        assert b.decode(st, 8) == dense_greedy(_prompt(i), 8)
        b.release(st)
    deadline = time.time() + 5
    while b.breaker.state != "open" and time.time() < deadline:
        time.sleep(0.02)
    assert b.breaker.state == "open"

    t0 = time.perf_counter()
    st = b.prefill(_prompt(4))
    skip_dt = time.perf_counter() - t0
    assert st.reused_chunks == 0
    assert skip_dt < 0.9, f"open circuit still paid a store hop ({skip_dt:.2f}s)"
    assert b.decode(st, 8) == dense_greedy(_prompt(4), 8)
    b.release(st)
    _arm(mport, [])
    prod.close()
    cons.close()


def test_connector_degrades_instead_of_raising(server):
    """The connector's lookup/retrieve report a miss and store_kv 0 bytes
    when the store hop dies."""
    port, mport = server
    conn = _conn(port, op_timeout_s=1.0)
    sc = StoreConnector(conn, make_pc(), model_id="conn-degrade",
                        device="cpu")
    sc.breaker.failure_threshold = 1
    cache = init_cache(make_pc(), "cpu")
    _arm(mport, [{"op": "MATCH_LAST_IDX", "action": "drop_conn"}])
    assert sc.lookup(PROMPT) == 0
    assert sc.breaker.state == "open"
    _cache2, got = sc.retrieve_kv(PROMPT, cache, [0, 1])
    assert got == 0
    assert sc.store_kv(PROMPT[:T], cache, [0]) == 0
    _arm(mport, [])
    conn.close()


def test_serve_healthz_without_store():
    """A storeless server is simply ok: no circuit field, nothing
    degraded, no alert firing."""
    eng = _engine()
    eng.decode_chunk = 4
    srv = ServingServer(eng, port=0, max_batch=2, model_id="no-store")
    srv.start()
    try:
        st, data = _get(srv.port, "/healthz")
        body = json.loads(data)
        assert st == 200 and body["status"] == "ok"
        assert "store_circuit" not in body and "reason" not in body
        assert body.get("alerts", {}).get("firing", 0) == 0
        _ask_greedy(srv.port, PROMPT, 4)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the step profiler on the store path (tests/test_stepprof.py)
# ---------------------------------------------------------------------------

_PKG = re.compile(r"\binfinistore_tpu\b(?!_torch)")
_STEPPROF_CASES = ("test_transfer_records_load_stages",
                   "test_note_sync_counts_and_summary_economy")


def _stepprof_cases_against_the_port() -> types.ModuleType:
    path = HERE / "test_stepprof.py"
    src, n = _PKG.subn("infinistore_tpu_torch", path.read_text())
    assert n > 0
    mod = types.ModuleType("port_test_stepprof")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_STEPPROF = _stepprof_cases_against_the_port()
for _name in _STEPPROF_CASES:
    globals()[f"test_stepprof__{_name[5:]}"] = getattr(_STEPPROF, _name)


def test_stepprof_cases_run_against_the_ports_modules():
    import infinistore_tpu_torch.utils.metrics as port_metrics

    assert _STEPPROF.MetricsRegistry is port_metrics.MetricsRegistry
    src = (HERE / "test_stepprof.py").read_text()
    assert not _PKG.search(_PKG.sub("infinistore_tpu_torch", src))


def test_single_stitched_trace_http_to_device(server, monkeypatch):
    """One stitched Perfetto export from a live request shows http.request
    -> engine.step -> kv.load_pages and the device sub-track under ONE
    trace id, and the ledger row joins the engine records by step id."""
    monkeypatch.setenv("ISTPU_STEPPROF_SAMPLE", "1")
    port, _ = server
    prompt = list(range(1, 17))
    prod_conn = _conn(port, op_timeout_s=30.0)
    prod = _engine(prod_conn, model_id="prof-stitch", kv_quant=None)
    prod.release(prod.prefill(prompt))
    prod.store_flush()

    conn = _conn(port, op_timeout_s=30.0)
    eng = _engine(conn, model_id="prof-stitch", kv_quant=None)
    eng.decode_chunk = 4
    srv = ServingServer(eng, port=0, max_batch=2, model_id="prof-stitch")
    srv.start()
    try:
        _ask_greedy(srv.port, prompt, 6)
        _s, data = _get(srv.port, "/debug/requests")
        rec = json.loads(data)["records"][-1]
        assert rec["store"]["store_chunks"] >= 1, rec
        trace_id = rec["trace_id"]
        assert trace_id

        _s, data = _get(srv.port, "/debug/traces")
        events = json.loads(data)["traceEvents"]
        mine = [e for e in events if e.get("ph") == "X"
                and e.get("args", {}).get("trace_id") == trace_id]
        names = {e["name"] for e in mine}
        assert {"http.request", "engine.step", "kv.load_pages"} <= names, \
            sorted(names)
        meta = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
                if e.get("ph") == "M" and e["name"] == "thread_name"}
        dev_tracks = {k for k, v in meta.items() if v == "device"}
        assert dev_tracks, meta
        assert any((e["pid"], e["tid"]) in dev_tracks for e in mine), \
            sorted(names)

        _s, data = _get(srv.port, "/debug/engine")
        step_ids = {r["step"] for r in json.loads(data)["records"]}
        assert rec["step_ids"] and set(rec["step_ids"]) <= step_ids
        stores = [r.get("store") for r in json.loads(data)["records"]
                  if r.get("store")]
        assert any("load" in s for s in stores), stores
    finally:
        srv.close()
        conn.close()
        prod_conn.close()


# ---------------------------------------------------------------------------
# attribution and traces (tests/test_cache_analytics.py,
# tests/test_trace_wire.py, tests/test_observability.py)
# ---------------------------------------------------------------------------


def test_engine_prefix_provenance_counters(server, monkeypatch):
    """A prompt whose prefix lives in the store counts store tokens on the
    consumer; a repeat counts local tokens; fresh prompts count computed."""
    monkeypatch.setenv("ISTPU_CLIENT", "python")
    port, _ = server

    def counters():
        fams = m.parse_prometheus_text(
            m.default_registry().to_prometheus_text())
        return {src: fams.get(("istpu_engine_prefix_tokens_total",
                               (("source", src),)), 0.0)
                for src in ("local", "store", "computed")}

    prompt = [9, 3, 7, 1, 5, 2, 8, 6, 4, 11, 13]
    prod_conn = _conn(port, op_timeout_s=None)
    producer = _engine(prod_conn, model_id="prov-test")
    before = counters()
    producer.release(producer.prefill(prompt))
    producer.store_flush()
    after_prod = counters()
    assert after_prod["computed"] - before["computed"] == len(prompt)

    cons_conn = _conn(port, op_timeout_s=None)
    consumer = _engine(cons_conn, model_id="prov-test")
    st = consumer.prefill(prompt)
    after_store = counters()
    assert after_store["store"] - after_prod["store"] == 2 * T
    assert after_store["computed"] - after_prod["computed"] == \
        len(prompt) - 2 * T
    assert consumer.decode(st, 6) == dense_greedy(prompt, 6)
    consumer.release(st)

    st = consumer.prefill(prompt)
    after_local = counters()
    assert after_local["local"] - after_store["local"] == 2 * T
    assert after_local["store"] == after_store["store"]
    consumer.release(st)
    prod_conn.close()
    cons_conn.close()


def _x_events(chrome):
    return [e for e in chrome["traceEvents"] if e.get("ph") == "X"]


def _contained(child, parent, slack_us=2000.0):
    return (parent["ts"] - slack_us <= child["ts"]
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + slack_us)


def test_serve_debug_traces_is_stitched_end_to_end(server, monkeypatch):
    """Client AND store-server spans under one trace id: the server's
    GET_DESC nests inside the client's kv.load_pages window."""
    monkeypatch.setenv("ISTPU_CLIENT", "python")
    port, _ = server
    prompt = [21, 3, 7, 1, 5, 2, 8, 6, 4, 11, 13]
    prod_conn = _conn(port, op_timeout_s=10.0)
    producer = _engine(prod_conn, model_id="stitch-serve")
    producer.release(producer.prefill(prompt))
    producer.store_flush()
    conn = _conn(port, op_timeout_s=10.0)
    eng = _engine(conn, model_id="stitch-serve")
    eng.decode_chunk = 4
    srv = ServingServer(eng, port=0, max_batch=2, model_id="stitch-serve")
    srv.start()
    try:
        _ask_greedy(srv.port, prompt, 4)
        _s, data = _get(srv.port, "/debug/traces")
        chrome = json.loads(data)
        evs = _x_events(chrome)
        assert evs, "empty stitched export"
        my_pid = os.getpid()
        assert "http.request" in {e["name"] for e in evs}
        by_trace = {}
        for e in evs:
            by_trace.setdefault(e["args"].get("trace_id"), []).append(e)
        stitched = {tid: grp for tid, grp in by_trace.items()
                    if {e["pid"] for e in grp} - {my_pid}
                    and my_pid in {e["pid"] for e in grp}}
        assert stitched, "no trace id carries spans from BOTH processes"
        for tid, grp in stitched.items():
            srv_desc = [e for e in grp if e["name"] == "store.GET_DESC"
                        and e["pid"] != my_pid]
            cli_load = [e for e in grp if e["name"] == "kv.load_pages"
                        and e["pid"] == my_pid]
            if srv_desc and cli_load:
                assert any(_contained(s, c)
                           for s in srv_desc for c in cli_load)
                break
        else:
            pytest.fail("no stitched trace pairs store.GET_DESC with "
                        "kv.load_pages")
        meta = [e for e in chrome["traceEvents"]
                if e.get("ph") == "M" and e.get("name") == "process_name"]
        assert any(e["args"]["name"] == "store-server" for e in meta)
    finally:
        srv.close()
        conn.close()
        prod_conn.close()


def test_trace_nests_request_through_transfer_to_pool_copy(server,
                                                           monkeypatch):
    """One trace id from the request root through ``kv.push_pages`` down
    to the client's pool fill stage, spans properly contained."""
    monkeypatch.setenv("ISTPU_CLIENT", "python")
    port, _ = server
    conn = _conn(port, op_timeout_s=None)
    pc = _tiny_pc()
    eng = KVTransferEngine(conn, pc, device="cpu")
    cache = init_cache(pc, "cpu")
    write_pages(cache, torch.tensor([0, 1]), _tiny_pages(1))
    keys = chunk_keys(list(range(32)), "tracemodel")
    tracer = tracing.TRACER
    with tracer.trace("request") as tr:
        trace_id = tr.trace_id
        eng.save_pages(cache, [0, 1], keys)
    conn.close()

    done = next(t for t in reversed(tracer.recent())
                if t.trace_id == trace_id)
    out = tracer.export_chrome([done])
    events = [e for e in out["traceEvents"] if e.get("ph") == "X"]
    assert all(e["args"]["trace_id"] == trace_id for e in events)
    by = {e["name"]: e for e in events}
    assert {"request", "kv.push_pages", "write_cache.fill"} <= set(by), \
        sorted(by)

    def contained(child, parent):
        c, p = by[child], by[parent]
        return (p["ts"] <= c["ts"] + 1e-6
                and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-6)

    assert contained("kv.push_pages", "request")
    assert contained("write_cache.fill", "kv.push_pages")


@pytest.fixture(scope="module")
def serving():
    eng = _engine()
    eng.decode_chunk = 4
    srv = ServingServer(eng, port=0, max_batch=4, model_id="obs-test")
    srv.start()
    yield srv
    srv.close()


def _scrape(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.headers, r.read().decode()


def test_serve_metrics_prometheus(serving):
    _ask_greedy(serving.port, [5, 9, 2, 14, 3], 4)
    deadline = time.time() + 10
    while True:
        headers, text = _scrape(serving.port, "/metrics")
        fams = parse_prometheus(text)
        if (fams["istpu_serve_completed_total"]["samples"][0][2] >= 1
                or time.time() > deadline):
            break
        time.sleep(0.05)
    assert headers["Content-Type"] == "text/plain; version=0.0.4"
    for name in ("istpu_serve_requests_total", "istpu_serve_completed_total",
                 "istpu_serve_tokens_total", "istpu_serve_free_kv_pages",
                 "istpu_serve_queue_wait_p50_ms", "istpu_serve_prefill_p99_ms"):
        assert name in fams, f"missing {name}"
    assert fams["istpu_serve_requests_total"]["samples"][0][2] >= 1
    assert fams["istpu_serve_completed_total"]["samples"][0][2] >= 1
    for name in ("istpu_serve_queue_wait_seconds",
                 "istpu_serve_prefill_seconds",
                 "istpu_serve_decode_step_seconds"):
        assert fams[name]["type"] == "histogram", name
        count = [v for n, _, v in fams[name]["samples"]
                 if n == f"{name}_count"]
        assert count and count[0] >= 1, (name, fams[name]["samples"])


def test_serve_debug_traces(serving):
    _ask_greedy(serving.port, [8, 1, 6], 4)
    headers, text = _scrape(serving.port, "/debug/traces")
    assert headers["Content-Type"] == "application/json"
    events = [e for e in json.loads(text)["traceEvents"]
              if e.get("ph") == "X"]
    assert events, "trace ring is empty after a served request"
    for e in events:
        assert {"ph", "ts", "pid", "tid", "name", "dur"} <= set(e)
    names = {e["name"] for e in events}
    assert "engine.step" in names
    assert "sched.decode_chunk" in names or "sched.prefill_step" in names
    assert "http.request" in names


# ---------------------------------------------------------------------------
# tenants and the disk tier (tests/test_usage.py, tests/test_store_tier.py)
# ---------------------------------------------------------------------------


def test_two_tenant_attribution_end_to_end():
    """Tenants acme and bob share a system prefix; acme also writes
    private chunks.  The store's ledger, its /metrics and the serve plane's
    joined /debug/usage attribute bytes, byte-seconds, hits and token
    provenance per tenant as the requests sent."""
    port, mport = _free_port(), _free_port()
    proc = _boot(port, mport)
    conn = _conn(port)
    eng = _engine(conn, n_blocks=128, model_id="usage-serve",
                  store_durability="strict")
    eng.decode_chunk = 4
    srv = ServingServer(eng, port=0, max_batch=4, model_id="usage-serve",
                        store_manage_endpoints=[f"127.0.0.1:{mport}"])
    srv.start()
    prod_conn = _conn(port)
    try:
        shared = [11, 42, 7, 99, 5, 3, 17, 28]
        prompt_a = shared + [60 + i for i in range(16)]
        prompt_b = shared + [90, 91, 92, 93]
        prod = _engine(prod_conn, n_blocks=128, model_id="usage-serve",
                       store_durability="strict")
        with U.bind_account("acme"):
            prod.release(prod.prefill(prompt_a))
            prod.store_flush()
        vm0 = _metrics_at(srv.port)

        status, body = _post(srv.port, {
            "prompt": prompt_b, "max_tokens": 4, "temperature": 0,
            "priority": "bob"})
        assert status == 200, body
        assert body["choices"][0]["token_ids"] == dense_greedy(prompt_b, 4)
        status, body = _post(srv.port, {
            "prompt": prompt_a, "max_tokens": 4, "temperature": 0,
            "priority": 1, "tenant": "acme"})
        assert status == 200, body
        assert body["choices"][0]["token_ids"] == dense_greedy(prompt_a, 4)
        srv.engine.store_flush()
        time.sleep(0.4)  # byte-seconds need wall time to accrue

        rep = _mget(mport, "/debug/usage")
        acme = rep["accounts"]["acme"]
        bob = rep["accounts"]["bob"]
        pb = srv.engine.transfer.wire_page_bytes
        L = TCFG.n_layers
        assert bob["resident_bytes"]["dram"] == pytest.approx(2 * L * pb)
        assert acme["resident_bytes"]["dram"] == pytest.approx(5 * L * pb)
        assert acme["byte_seconds"]["dram"] > bob["byte_seconds"]["dram"] > 0
        assert bob["hits"] >= 2 * L
        assert rep["sharer_overflow"] == 0

        sm = _metrics_at(mport)

        def usage_metric(name, **labels):
            return sm.get((name, tuple(sorted(labels.items()))))

        assert usage_metric("istpu_store_usage_resident_bytes",
                            account="bob", tier="dram") == \
            pytest.approx(2 * L * pb)
        bs_acme = usage_metric("istpu_store_usage_byte_seconds_total",
                               account="acme", tier="dram")
        bs_bob = usage_metric("istpu_store_usage_byte_seconds_total",
                              account="bob", tier="dram")
        assert bs_acme is not None and bs_bob is not None
        assert bs_acme > bs_bob > 0
        assert usage_metric("istpu_store_usage_hits_total",
                            account="bob") >= 2 * L

        vm = _metrics_at(srv.port)

        def tok(tenant, source):
            key = ("istpu_engine_tenant_prefix_tokens_total",
                   (("source", source), ("tenant", tenant)))
            return vm.get(key, 0.0) - vm0.get(key, 0.0)

        assert tok("bob", "store") == 8.0
        assert tok("bob", "computed") == 4.0
        assert tok("acme", "local") == 8.0
        assert tok("acme", "store") == 12.0
        assert tok("acme", "computed") == 4.0

        joined = _mget(srv.port, "/debug/usage")
        assert joined["enabled"] and joined["nodes"] == 1
        ja = joined["tenants"]["acme"]
        jb = joined["tenants"]["bob"]
        assert ja["tokens"]["store"] == 12.0 and jb["tokens"]["store"] == 8.0
        assert ja["byte_seconds"]["dram"] > jb["byte_seconds"]["dram"]
        assert jb["reuse_ratio"] == pytest.approx(8 / 12, abs=1e-3)
        occupants = [r["tenant"] for r in joined["top_occupants"]]
        assert occupants and occupants[0] == "acme"
        savers = [r["tenant"] for r in joined["top_savers"]]
        assert "acme" in savers and "bob" in savers

        recs = _mget(srv.port, "/debug/requests")["records"]
        assert {"acme", "bob"} <= {r["lane"] for r in recs}
    finally:
        srv.close()
        conn.close()
        prod_conn.close()
        _stop(proc)


def _boot_tiered(port, mport, tier_dir):
    return _boot(port, mport,
                 extra_args=("--disk-tier-path", tier_dir,
                             "--disk-tier-size", "1"),
                 extra_env={"ISTPU_DISK_COOLDOWN_S": "1"})


def _tier_engine(port):
    conn = ist.InfinityConnection(ist.ClientConfig(
        host_addr="127.0.0.1", service_port=port,
        connection_type=ist.TYPE_TCP, log_level="warning", op_timeout_s=15))
    conn.connect()
    return _engine(conn, model_id="tier-serve", kv_quant=None)


def _epoch_fences():
    return m.default_registry().family_value(
        "istpu_integrity_failures_total", where={"cause": "epoch"}) or 0.0


def test_warm_restart_serves_persisted_prefixes_without_recompute(tmp_path):
    """Push a prefix, spill it to disk, SIGKILL the store, restart it on
    the same port and spill path: the surviving connection counts an epoch
    fence, and a fresh engine adopts the whole persisted prefix off disk
    (and decodes the greedy tokens)."""
    port, mport = _free_port(), _free_port()
    proc = _boot_tiered(port, mport, str(tmp_path))
    try:
        producer = _tier_engine(port)
        st = producer.prefill(PROMPT)
        producer.release(st)
        producer.store_flush()
        demoted = _mpost(mport, "/spill", {})
        assert demoted["demoted"] > 0
        assert _mget(mport, "/stats")["disk_entries"] > 0

        proc.send_signal(signal.SIGKILL)
        proc.wait()
        proc = _boot_tiered(port, mport, str(tmp_path))
        stats = _mget(mport, "/stats")
        assert stats["disk_warm_entries"] > 0
        assert stats["kvmap_len"] == 0

        before_fence = _epoch_fences()
        assert producer.transfer._call("check_exist", "remap-probe") == 1
        assert _epoch_fences() > before_fence, \
            "reconnect across the restart must count an epoch fence"
        consumer = _tier_engine(port)
        st2 = consumer.prefill(PROMPT)
        complete = (len(PROMPT) - 1) // T
        assert st2.store_chunks == complete and st2.reused_chunks == complete
        assert st2.local_chunks == 0
        stats = _mget(mport, "/stats")
        assert stats["disk_promoted"] > 0
        assert stats["disk_verify_failures"] == 0
        assert consumer.decode(st2, 6) == dense_greedy(PROMPT, 6)
        consumer.release(st2)
    finally:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# a dead store (the CPU counterpart of the smoke's degraded case (b))
# ---------------------------------------------------------------------------


def test_dead_store_degrades_to_recompute_and_opens_the_breaker():
    """A pushes a prompt, the store server is stopped: B's prefill of that
    prompt degrades to recompute with the greedy tokens, one more prefill
    makes the breaker's third failure and opens it, the failed pushes are
    counted and ``store_flush`` re-raises with their count."""
    port, mport = _free_port(), _free_port()
    proc = _boot(port, mport)
    conns = [_conn(port), _conn(port, op_timeout_s=1.0)]
    try:
        a = _engine(conns[0], model_id="dead-store")
        b = _engine(conns[1], model_id="dead-store",
                    store_durability="relaxed")
        a.release(a.prefill(_prompt(0)))
        _stop(proc)
        key = "istpu_store_push_dropped_total"
        before = sum(v for (n, _l), v in m.parse_prometheus_text(
            m.default_registry().to_prometheus_text()).items() if n == key)
        st = b.prefill(_prompt(0))
        assert st.reused_chunks == 0
        assert b.decode(st, 8) == dense_greedy(_prompt(0), 8)
        b.release(st)
        st = b.prefill(_prompt(1))
        assert st.reused_chunks == 0
        b.release(st)
        deadline = time.time() + 5
        while b.breaker.state != "open" and time.time() < deadline:
            time.sleep(0.02)
        assert b.breaker.state == "open"
        assert b.breaker.failure_threshold == 3
        with pytest.raises(OSError) as err:
            b.store_flush()
        assert re.search(r"\[\d+ queued store pushes dropped",
                         err.value.args[0]), err.value.args
        after = sum(v for (n, _l), v in m.parse_prometheus_text(
            m.default_registry().to_prometheus_text()).items() if n == key)
        assert after >= before + 2
    finally:
        if proc.poll() is None:
            _stop(proc)
        for c in conns:
            c.close()


@pytest.mark.parametrize("pkg", ["infinistore_tpu", "infinistore_tpu_torch"])
def test_flush_names_the_drops_in_args_not_in_an_oserrors_str(pkg):
    """Both packages' streamers re-raise the first push error at flush with
    the dropped count appended to its ``args``; for an ``OSError`` (a dead
    store's ``ConnectionRefusedError``) ``str()`` shows its errno and
    strerror, not ``args``, so the count is in ``args[0]`` only (the
    reference's behaviour, which the port keeps; ROADMAP queue 3)."""
    import importlib

    eng_mod = importlib.import_module(f"{pkg}.engine.engine")
    res_mod = importlib.import_module(f"{pkg}.utils.resilience")

    class Transfer:
        breaker = res_mod.CircuitBreaker(failure_threshold=99)

        def push_begin(self, pages, keys):
            return keys

        def push_commit(self, token):
            raise ConnectionRefusedError(111, "Connection refused")

    streamer = eng_mod._StoreStreamer(Transfer(), maxsize=8,
                                      durability="relaxed")
    for i in range(3):
        streamer.submit(None, [f"k{i}"])
    with pytest.raises(ConnectionRefusedError) as err:
        streamer.flush()
    assert err.value.args[0].endswith(
        "[3 queued store pushes dropped with this error]")
    assert str(err.value) == "[Errno 111] Connection refused"
    streamer.flush()  # the parked state cleared
