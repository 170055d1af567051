"""The port's disaggregated fleet (``infinistore_tpu_torch.frontdoor``)
against the reference's fleet contract (``tests/test_frontdoor.py``) on
the CPU.

Logic half (no sockets): the placement policy and the stitcher on the
port's ``frontdoor`` and ``health``; where the reference's answer is plain
data (a rendezvous order, a candidate list, an affinity stem, a rollup),
the port's answer is held equal to it on the same inputs.

Live half: the port's store server in a subprocess under the port's
``local_fleet(..., device="cpu")`` — handoff, store adoption and byte
parity with the prefill worker's local answer, roles and rollups, the
``/v1/prefill`` contract, the single-trace stitched chain, the serve-plane
FaultInjector, and the prefill-worker kill mid-flood.

Mixed fleets: a JAX worker and a torch worker over one store, behind
either package's ``FrontDoor``; TINY in float32 with the reference's
weights carried over by ``params_from_jax`` and ``kv_quant=None``, so the
routed greedy tokens equal the JAX monolith's exactly.

Two engines capturing decode graphs at once in one process (the in-process
fleet on a card) count only their own kernel calls: held here through a
stub of the CUDA capture.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu.frontdoor as rfd
import infinistore_tpu.health as rhealth
from infinistore_tpu.utils.metrics import MetricsRegistry as RRegistry
import infinistore_tpu_torch.frontdoor as pfd
import infinistore_tpu_torch.health as phealth
from infinistore_tpu_torch.utils.metrics import (MetricsRegistry,
                                                 parse_prometheus_text)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SLO_ENV = {"ISTPU_SLO_TTFT_S": "60", "ISTPU_SLO_TPOT_S": "10"}


# ---------------------------------------------------------------------------
# placement policy (pure), the port against the reference's answers
# ---------------------------------------------------------------------------


def _worker(endpoint, role="decode", inflight=0, shedding=False,
            reachable=True, circuit="closed", fd=pfd, registry=MetricsRegistry):
    """A WorkerState stand-in with scripted placement inputs (the port's
    by default, the reference's with ``fd=rfd, registry=RRegistry``)."""
    w = fd.WorkerState(f"http://{endpoint}", role, registry())
    w.reachable = reachable
    w._inflight = inflight
    if shedding:
        w.healthz = {"admission": {"mode": "shed"}}
    if circuit == "open":
        for _ in range(w.breaker.failure_threshold):
            w.breaker.record_failure()
        assert w.breaker.state == "open"
    return w


def _ref_worker(endpoint, **kw):
    return _worker(endpoint, fd=rfd, registry=RRegistry, **kw)


def test_rendezvous_affinity_sticky_and_minimal_rebalance():
    pool = [_worker(f"10.0.0.{i}:80") for i in range(4)]
    ref_pool = [_ref_worker(f"10.0.0.{i}:80") for i in range(4)]
    stems = [f"stem-{i}" for i in range(64)]
    first = {s: pfd.rendezvous_order(pool, s)[0].endpoint for s in stems}
    # the whole order equals the reference's, stem by stem
    for s in stems:
        assert [w.endpoint for w in pfd.rendezvous_order(pool, s)] == \
            [w.endpoint for w in rfd.rendezvous_order(ref_pool, s)], s
    # sticky: same pool, same answer
    assert first == {s: pfd.rendezvous_order(pool, s)[0].endpoint
                     for s in stems}
    # removing one worker moves ONLY that worker's stems
    gone = pool[1]
    shrunk = [w for w in pool if w is not gone]
    for s in stems:
        head = pfd.rendezvous_order(shrunk, s)[0].endpoint
        if first[s] != gone.endpoint:
            assert head == first[s], s
    moved = sum(1 for s in stems if first[s] == gone.endpoint)
    assert 0 < moved < len(stems) // 2, moved


def test_rendezvous_demotes_shedding_but_keeps_affinity_within_group():
    ok = [_worker(f"10.0.1.{i}:80") for i in range(2)]
    shed = _worker("10.0.1.9:80", shedding=True)
    order = pfd.rendezvous_order(ok + [shed], "stem-x")
    assert order[-1] is shed  # shedding sorts last
    assert [w.endpoint for w in order[:2]] == \
        [w.endpoint for w in pfd.rendezvous_order(ok, "stem-x")]
    ref = [_ref_worker(f"10.0.1.{i}:80") for i in range(2)] + [
        _ref_worker("10.0.1.9:80", shedding=True)]
    assert [w.endpoint for w in order] == \
        [w.endpoint for w in rfd.rendezvous_order(ref, "stem-x")]


def _candidates(fd, make):
    door = fd.FrontDoor.__new__(fd.FrontDoor)  # placement needs the pool
    busy = make("10.0.2.1:80", role="prefill", inflight=5)
    idle = make("10.0.2.2:80", role="prefill", inflight=0)
    shed = make("10.0.2.3:80", role="prefill", shedding=True)
    opened = make("10.0.2.4:80", role="prefill", circuit="open")
    down = make("10.0.2.5:80", role="prefill", reachable=False)
    door.prefill = [busy, shed, opened, idle, down]
    return [w.endpoint for w in door.prefill_candidates()], (busy, idle, shed)


def test_prefill_candidates_least_loaded_shedding_last_circuit_skipped():
    got, (busy, idle, shed) = _candidates(pfd, _worker)
    assert got == [idle.endpoint, busy.endpoint, shed.endpoint]
    assert got == _candidates(rfd, _ref_worker)[0]


def test_affinity_stem_shapes():
    ids = pfd.affinity_stem({"prompt": list(range(40))}, tokens=16)
    assert ids == ",".join(str(t) for t in range(16))
    # same leading stem, different tails -> same key
    assert ids == pfd.affinity_stem({"prompt": list(range(16)) + [9, 9]},
                                    tokens=16)
    assert pfd.affinity_stem({"prompt": "x" * 100}) == "x" * 64
    assert pfd.affinity_stem({"messages": [{"role": "user",
                                            "content": "hi"}]}) == "hi"
    assert pfd.affinity_stem({}) is None
    bodies = [{"prompt": list(range(40))}, {"prompt": [3, 1, 4]},
              {"prompt": "y" * 7}, {"prompt": "z" * 300},
              {"messages": [{"role": "system", "content": "be brief"},
                            {"role": "user", "content": "hi"}]}, {}]
    for body in bodies:
        for n in (4, 16):
            assert pfd.affinity_stem(body, tokens=n) == \
                rfd.affinity_stem(body, tokens=n), (body, n)


def test_cluster_rollup_groups_roles():
    """Role labels on /healthz group the rollup; pure-store rollups keep
    their pre-fleet shape (no ``roles`` block); the port's rollup equals
    the reference's over the same payloads."""
    payloads = {
        "http://a:1/healthz": {"status": "ok", "role": "prefill"},
        "http://b:2/healthz": {"status": "ok", "role": "decode"},
        "http://c:3/healthz": {"status": "ok"},
    }

    def fake_fetch(url, timeout=2.0):
        return payloads.get(url)

    outs = {}
    for mod in (phealth, rhealth):
        orig = mod.fetch_json
        mod.fetch_json = fake_fetch
        try:
            outs[mod] = (mod.cluster_rollup(["a:1", "b:2", "c:3"]),
                         mod.cluster_rollup(["c:3"]))
        finally:
            mod.fetch_json = orig
    out, out2 = outs[phealth]
    assert out["roles"]["prefill"]["ok"] == 1
    assert out["roles"]["decode"]["ok"] == 1
    assert out["roles"]["store"]["nodes"] == 1  # unlabeled = store
    assert out["nodes"][0]["role"] == "prefill"
    assert "roles" not in out2  # pure-store fleet: no roles block at all
    assert outs[phealth] == outs[rhealth]


def test_stitch_maps_remote_worker_dump(monkeypatch):
    """The router's cross-process gather: a worker dump with its own pid
    and a skewed clock lands in the export on its own process row, mapped
    onto the router timeline by the round-trip-midpoint offset."""
    fd = pfd.FrontDoor.__new__(pfd.FrontDoor)
    w = pfd.WorkerState("http://127.0.0.1:1", "prefill", MetricsRegistry())
    w.reachable = True
    fd.prefill, fd.decode = [w], []

    now = time.perf_counter()
    skew = 1234.5  # worker clock runs far ahead of the router's
    dump = {
        "pid": 99999, "clock": now + skew, "dropped": 0,
        "traces": [{"trace_id": "tr-x", "name": "http.request",
                    "events": [["kv.push_pages", now + skew - 0.010,
                                now + skew - 0.004, 7, {}]]}],
    }
    monkeypatch.setattr(pfd.FrontDoor, "_fetch_json",
                        classmethod(lambda cls, _w, _p, timeout: dump))
    export = json.loads(fd.stitched_traces_json())
    remote = [e for e in export["traceEvents"] if e.get("ph") == "X"
              and e["pid"] == 99999]
    assert remote and remote[0]["name"] == "kv.push_pages"
    assert remote[0]["args"]["trace_id"] == "tr-x"
    meta_pids = {e["pid"] for e in export["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
    assert 99999 in meta_pids
    assert remote[0]["dur"] == pytest.approx(6000, rel=0.05)  # µs


# ---------------------------------------------------------------------------
# live fleet over the port's store server
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextmanager
def port_store(extra=()):
    """The port's store server in a subprocess; yields (service port,
    manage port)."""
    port, mport = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.server",
         "--service-port", str(port), "--manage-port", str(mport),
         "--prealloc-size", "1", "--minimal-allocate-size", "16",
         "--log-level", "warning", "--backend", "python", *extra],
        cwd=REPO,
    )
    try:
        deadline = time.time() + 25
        while True:
            if proc.poll() is not None:
                pytest.fail("store server failed to start")
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=0.5).close()
                break
            except OSError:
                if time.time() >= deadline:
                    pytest.fail("store server did not come up")
                time.sleep(0.1)
        yield port, mport
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@contextmanager
def env_set(values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def live_store():
    with port_store() as (port, _mport):
        yield port


@pytest.fixture(scope="module")
def fleet(live_store):
    """1 prefill + 1 decode behind a front door, on the CPU.  SLO targets
    loosened for the whole module so no burn watchdog sheds: these tests
    assert behavior, not latency."""
    with env_set(_SLO_ENV):
        fd, workers, close = pfd.local_fleet(live_store, 1, 1, poll_s=0.3,
                                             device="cpu")
        try:
            status, _ = _post(fd.port, "/v1/completions",
                              {"prompt": [7, 7, 7, 7, 7], "max_tokens": 2,
                               "temperature": 0})
            assert status == 200
            yield fd, workers
        finally:
            close()


def _post(port, path, body, headers=None, timeout=120.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _get(port, path, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _metric(prom_text, family, **labels):
    parsed = parse_prometheus_text(prom_text)
    key = (family, tuple(sorted((k, str(v)) for k, v in labels.items())))
    return parsed.get(key)


def _last_record(port):
    _s, data = _get(port, "/debug/requests")
    return json.loads(data)["records"][-1]


def test_local_fleet_runs_the_ports_engines_on_the_device(fleet):
    """The fleet's workers are the port's engines on the asked device,
    over TINY in float32, with lossless pages (byte-exact handoff)."""
    from infinistore_tpu_torch.engine import InferenceEngine

    _fd, workers = fleet
    for srv in workers["prefill"] + workers["decode"]:
        eng = srv.engine
        assert isinstance(eng, InferenceEngine)
        assert eng.device == torch.device("cpu")
        assert eng.cfg.dtype == torch.float32 and eng.transfer.quant is None


def test_fleet_adoption_and_byte_parity(fleet):
    """A routed request completes with store-adoption provenance, and its
    greedy tokens byte-match the same prompt computed on the prefill
    worker (its own completions path reuses its local pages: the oracle)."""
    fd, workers = fleet
    prompt = list(range(3, 19))  # 4 complete chunks at block_tokens=4
    status, routed = _post(fd.port, "/v1/completions",
                           {"prompt": prompt, "max_tokens": 6,
                            "temperature": 0})
    assert status == 200, routed
    routed_ids = routed["choices"][0]["token_ids"]
    assert len(routed_ids) == 6

    dec = workers["decode"][0]
    rec = _last_record(dec.port)
    st = rec.get("store") or {}
    # the adoption rule: every stored chunk but the one holding the last
    # prompt token, which is computed
    assert st.get("store_chunks") == (len(prompt) - 1) // 4, rec
    assert rec["trace_id"], rec

    pre = workers["prefill"][0]
    status, local = _post(pre.port, "/v1/completions",
                          {"prompt": prompt, "max_tokens": 6,
                           "temperature": 0})
    assert status == 200, local
    assert local["choices"][0]["token_ids"] == routed_ids

    _s, data = _get(fd.port, "/debug/fleet")
    fleet_rep = json.loads(data)
    assert fleet_rep["enabled"]
    assert {w["role"] for w in fleet_rep["workers"]} == {"prefill", "decode"}
    assert fleet_rep["handoff"]["count"] >= 1
    deadline = time.time() + 5  # poller refresh
    while time.time() < deadline:
        _s, data = _get(fd.port, "/debug/fleet")
        if json.loads(data)["adoption"]["store_tokens"] > 0:
            break
        time.sleep(0.2)
    assert json.loads(data)["adoption"]["store_tokens"] > 0


def test_roles_on_healthz_and_rollup(fleet):
    fd, workers = fleet
    _s, data = _get(workers["prefill"][0].port, "/healthz")
    assert json.loads(data)["role"] == "prefill"
    _s, data = _get(workers["decode"][0].port, "/healthz")
    assert json.loads(data)["role"] == "decode"
    _s, data = _get(fd.port, "/healthz")
    hz = json.loads(data)
    assert hz["role"] == "router"
    assert hz["rollup"]["prefill"]["workers"] == 1
    assert hz["rollup"]["decode"]["ok"] == 1
    out = phealth.cluster_rollup([f"127.0.0.1:{workers['prefill'][0].port}",
                                  f"127.0.0.1:{workers['decode'][0].port}"])
    assert out["roles"]["prefill"]["nodes"] == 1
    assert out["roles"]["decode"]["nodes"] == 1
    _s, data = _get(workers["prefill"][0].port, "/metrics")
    assert _metric(data.decode(), "istpu_serve_role",
                   role="prefill") == 1.0


def test_v1_prefill_contract(fleet):
    """The handoff endpoint: scheduler-path prefill + flush barrier; the
    pushed prefix is discoverable by the decode pool at once, under the
    same chunk keys the reference derives."""
    from infinistore_tpu.kv.hashing import chunk_keys as ref_chunk_keys
    from infinistore_tpu_torch.kv.hashing import chunk_keys

    fd, workers = fleet
    pre = workers["prefill"][0]
    prompt = list(range(100, 112))  # fresh prefix, 3 complete chunks
    status, out = _post(pre.port, "/v1/prefill", {"prompt": prompt})
    assert status == 200, out
    assert out["object"] == "prefill" and out["role"] == "prefill"
    assert out["chunks"] == 3 and out["block_tokens"] == 4
    assert out["store"] and out["flushed"]
    dec = workers["decode"][0]
    keys = chunk_keys(prompt, dec.engine.model_id, chunk_tokens=4)
    assert keys == ref_chunk_keys(prompt, dec.engine.model_id,
                                  chunk_tokens=4)
    assert dec.engine.transfer.guarded_lookup_prefix(keys) == 3
    status, out = _post(pre.port, "/v1/prefill", {"prompt": []})
    assert status == 400


def test_stitched_single_trace_chain(fleet):
    """The router's /debug/traces export carries http.request -> prefill
    handoff -> store push -> decode adoption under ONE trace id."""
    fd, workers = fleet
    status, _body = _post(fd.port, "/v1/completions",
                          {"prompt": list(range(40, 56)), "max_tokens": 4,
                           "temperature": 0})
    assert status == 200
    trace_id = _last_record(workers["decode"][0].port)["trace_id"]
    assert trace_id
    _s, data = _get(fd.port, "/debug/traces")
    mine = [e for e in json.loads(data)["traceEvents"] if e.get("ph") == "X"
            and e.get("args", {}).get("trace_id") == trace_id]
    names = {e["name"] for e in mine}
    assert {"http.request", "fd.prefill_handoff", "fd.decode_dispatch",
            "engine.prefill", "store.push_async",
            "kv.load_pages"} <= names, sorted(names)
    assert sum(1 for e in mine if e["name"] == "http.request") >= 3


def test_worker_fault_injector_delay_and_clear(fleet):
    """The serve-plane FaultInjector hook: an armed delay rule slows the
    matched path, clear() restores it."""
    _fd, workers = fleet
    pre = workers["prefill"][0]
    status, out = _post(pre.port, "/debug/faults",
                        [{"op": "/v1/prefill", "action": "delay",
                          "delay_s": 0.4, "times": 1}])
    assert status == 200 and out["armed"] == 1
    t0 = time.perf_counter()
    status, _ = _post(pre.port, "/v1/prefill",
                      {"prompt": list(range(60, 72))})
    assert status == 200
    assert time.perf_counter() - t0 >= 0.4
    status, out = _post(pre.port, "/debug/faults", [])
    assert status == 200 and out["armed"] == 0


def test_serve_role_router_starts_the_ports_front_door(fleet):
    """``serve --role router`` hands its command line to the port's
    front door (no engine, no model flags), which routes to the fleet."""
    _fd, workers = fleet
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.serve",
         "--role", "router", "--port", str(port),
         "--prefill-workers", f"127.0.0.1:{workers['prefill'][0].port}",
         "--decode-workers", f"127.0.0.1:{workers['decode'][0].port}",
         "--poll-interval", "0.3", "--log-level", "warning"], cwd=REPO)
    try:
        deadline = time.time() + 30
        while True:
            assert proc.poll() is None, proc.returncode
            try:
                status, data = _get(port, "/healthz", timeout=1.0)
                break
            except OSError:
                assert time.time() < deadline, "router did not come up"
                time.sleep(0.2)
        assert json.loads(data)["role"] == "router"
        status, out = _post(port, "/v1/completions",
                            {"prompt": list(range(70, 86)), "max_tokens": 3,
                             "temperature": 0})
        assert status == 200 and len(out["choices"][0]["token_ids"]) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# the chaos walk: prefill-worker kill mid-flood
# ---------------------------------------------------------------------------


def test_chaos_prefill_worker_kill_mid_flood(live_store):
    """FaultInjector action first: every handoff to the victim dies at the
    socket, then its httpd is killed.  Mid-flood: zero errors and zero
    5xx, ONLY the victim's breaker opens, and afterwards adoption hits
    keep being served — all asserted from the router's /metrics."""
    from infinistore_tpu_torch.loadgen import LoadConfig, run_load, summarize

    with env_set(_SLO_ENV):
        fd, workers, close = pfd.local_fleet(live_store, 2, 1, poll_s=0.3,
                                             device="cpu")
        try:
            victim, survivor = workers["prefill"]
            v_ep = f"prefill@127.0.0.1:{victim.port}"
            s_ep = f"prefill@127.0.0.1:{survivor.port}"
            for w in (victim, survivor):
                status, _ = _post(w.port, "/v1/prefill",
                                  {"prompt": [1, 2, 3, 4, 5]})
                assert status == 200
            status, _ = _post(fd.port, "/v1/completions",
                              {"prompt": [1, 2, 3, 4, 5], "max_tokens": 2,
                               "temperature": 0})
            assert status == 200

            status, out = _post(victim.port, "/debug/faults",
                                [{"op": "/v1/prefill",
                                  "action": "drop_conn", "times": -1}])
            assert status == 200 and out["armed"] == 1
            victim_state = next(w for w in fd.prefill
                                if w.port == victim.port)
            victim_state.breaker.cooldown_s = 300.0
            # a drop_conn rule leaves the handoff's socket open until the
            # router's deadline (ROADMAP.md queue 3), so the deadline
            # bounds each handoff to the victim: a short one lets the
            # flood reach it three times, as the slower reference workers
            # do within their longer one
            fd.handoff_timeout_s = 0.75

            results, makespan = run_load(f"http://127.0.0.1:{fd.port}",
                                         LoadConfig(rate=6.0, n_requests=16,
                                                    vocab=256,
                                                    mix=[(1.0, 16, 4)],
                                                    timeout_s=300.0))
            point = summarize(results, makespan, 60.0, 10.0, rate=6.0)
            assert point["completed"] == 16, point
            assert point["errors"] == 0 and point["rejected"] == 0, point

            _s, data = _get(fd.port, "/metrics")
            prom = data.decode()
            assert _metric(prom, "istpu_fd_requests_total",
                           **{"class": "5xx"}) == 0.0
            assert _metric(prom, "istpu_store_circuit_state",
                           name=v_ep) == 1.0
            assert _metric(prom, "istpu_store_circuit_state",
                           name=s_ep) == 0.0

            victim.httpd.shutdown()
            victim.httpd.server_close()
            deadline = time.time() + 5
            while time.time() < deadline:
                _s, data = _get(fd.port, "/healthz")
                hz = json.loads(data)
                if hz["rollup"]["prefill"]["unreachable"] == 1:
                    break
                time.sleep(0.2)
            assert hz["status"] == "degraded" and \
                hz["rollup"]["prefill"]["unreachable"] == 1, hz

            ok_before = _metric(prom, "istpu_fd_handoff_total",
                                outcome="ok") or 0.0
            status, _body = _post(fd.port, "/v1/completions",
                                  {"prompt": list(range(200, 216)),
                                   "max_tokens": 4, "temperature": 0})
            assert status == 200
            rec = _last_record(workers["decode"][0].port)
            assert ((rec.get("store") or {}).get("store_chunks")
                    or 0) >= 1, rec
            _s, data = _get(fd.port, "/metrics")
            assert (_metric(data.decode(), "istpu_fd_handoff_total",
                            outcome="ok") or 0.0) > ok_before
        finally:
            close()


# ---------------------------------------------------------------------------
# mixed fleets: a JAX worker and a torch worker over one store
# ---------------------------------------------------------------------------


_MIXED_PROMPTS = [list(range(3, 19)), [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2],
                  [5 * i % 500 + 1 for i in range(23)]]
_MIXED_STEPS = 6


@pytest.fixture(scope="module")
def mixed_parts():
    """TINY in float32: the reference's weights and the port's copy of
    them, and the JAX monolith's greedy tokens for each prompt."""
    from infinistore_tpu.engine import InferenceEngine as JEngine
    from infinistore_tpu.kv import PagedCacheConfig as JPC
    from infinistore_tpu.models import TINY, init_params, scaled
    from infinistore_tpu_torch.models import TINY as TTINY
    from infinistore_tpu_torch.models import params_from_jax
    from infinistore_tpu_torch.models import scaled as tscaled

    cfg = scaled(TINY, dtype=jnp.float32)
    params = init_params(cfg, jax.random.PRNGKey(5))
    tcfg = tscaled(TTINY, dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    mono = JEngine(params, cfg, JPC(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=128, block_tokens=4,
        dtype=cfg.dtype))
    want = []
    for p in _MIXED_PROMPTS:
        st = mono.prefill(p)
        want.append(mono.decode(st, _MIXED_STEPS))
        mono.release(st)
    return cfg, params, tcfg, tparams, want


def _jax_server(cfg, params, store_port, role, model_id):
    from infinistore_tpu import lib as jlib
    from infinistore_tpu.engine import InferenceEngine as JEngine
    from infinistore_tpu.kv import PagedCacheConfig as JPC
    from infinistore_tpu.serve import ServingServer as JServer

    conn = jlib.InfinityConnection(jlib.ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=jlib.TYPE_SHM, op_timeout_s=30.0,
        log_level="warning"))
    conn.connect()
    eng = JEngine(params, cfg, JPC(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=128, block_tokens=4,
        dtype=cfg.dtype), conn=conn, model_id=model_id, kv_quant=None)
    eng.decode_chunk = 4
    srv = JServer(eng, port=0, max_batch=4, model_id=model_id, role=role)
    srv.start()
    return srv, conn, eng


def _torch_server(tcfg, tparams, store_port, role, model_id):
    from infinistore_tpu_torch import lib as tlib
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.serve import ServingServer

    conn = tlib.InfinityConnection(tlib.ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=tlib.TYPE_SHM, op_timeout_s=30.0,
        log_level="warning"))
    conn.connect()
    eng = InferenceEngine(tparams, tcfg, PagedCacheConfig(
        n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
        head_dim=tcfg.head_dim, n_blocks=128, block_tokens=4,
        dtype=torch.float32), conn=conn, model_id=model_id, kv_quant=None,
        decode_chunk=4, device="cpu")
    srv = ServingServer(eng, port=0, max_batch=4, model_id=model_id,
                        role=role)
    srv.start()
    return srv, conn, eng


@pytest.mark.parametrize("layout", ["jax_prefill_torch_decode_ref_router",
                                    "torch_prefill_jax_decode_port_router"])
def test_mixed_fleet_tokens_equal_the_jax_monolith(live_store, mixed_parts,
                                                   layout):
    """One store, one JAX and one torch worker behind a front door (the
    reference's for a JAX prefill + torch decode, the port's for the
    reverse): each routed greedy completion equals the JAX monolith's, and
    the decode worker adopted the prompt from the store."""
    cfg, params, tcfg, tparams, want = mixed_parts
    model_id = f"mixed-{layout}"
    jax_role, fd_mod = (("prefill", rfd) if layout.startswith("jax_prefill")
                        else ("decode", pfd))
    torch_role = "decode" if jax_role == "prefill" else "prefill"
    with env_set(_SLO_ENV):
        jsrv, jconn, _je = _jax_server(cfg, params, live_store, jax_role,
                                       model_id)
        tsrv, tconn, te = _torch_server(tcfg, tparams, live_store,
                                        torch_role, model_id)
        pre, dec = (jsrv, tsrv) if jax_role == "prefill" else (tsrv, jsrv)
        door = fd_mod.FrontDoor([f"http://127.0.0.1:{pre.port}"],
                                [f"http://127.0.0.1:{dec.port}"],
                                port=0, poll_s=0.3)
        door.start()
        try:
            for prompt, toks in zip(_MIXED_PROMPTS, want):
                status, out = _post(door.port, "/v1/completions",
                                    {"prompt": prompt,
                                     "max_tokens": _MIXED_STEPS,
                                     "temperature": 0})
                assert status == 200, out
                assert out["choices"][0]["token_ids"] == toks, prompt
                rec = _last_record(dec.port)
                assert ((rec.get("store") or {}).get("store_chunks")
                        or 0) >= 1, rec
            _s, data = _get(door.port, "/metrics")
            assert (_metric(data.decode(), "istpu_fd_handoff_total",
                            outcome="ok") or 0.0) == len(_MIXED_PROMPTS)
        finally:
            door.close()
            jsrv.close()
            tsrv.close()
            te.transfer.close()
            jconn.close()
            tconn.close()


# ---------------------------------------------------------------------------
# two engines capturing decode graphs at once (a stub of the CUDA capture)
# ---------------------------------------------------------------------------


def test_two_concurrent_captures_count_only_their_own_launches(monkeypatch):
    """Two engines capture on two threads at once, their calls interleaved
    step by step: each graph records only its own thread's kernel calls
    (not the global ``CAPTURED`` delta, which holds both), and replays add
    them to the replaying thread's ``BY_THREAD``, which ``LAUNCHES``
    sums."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import TINY, init_params
    from infinistore_tpu_torch.ops import cuda_attention as ca

    capturing = threading.local()

    class FakeGraph:
        def capture_begin(self, pool=None, capture_error_mode="global"):
            assert capture_error_mode == "thread_local"
            capturing.on = True

        def capture_end(self):
            capturing.on = False

    @contextmanager
    def fake_stream(_stream):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "stream", fake_stream)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))

    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    pc = PagedCacheConfig(n_layers=TINY.n_layers, n_kv_heads=TINY.n_kv_heads,
                          head_dim=TINY.head_dim, n_blocks=16,
                          block_tokens=4, dtype=TINY.dtype)
    engines = [InferenceEngine(params, TINY, pc, device="cpu")
               for _ in range(2)]
    rounds, per_round = 40, (1, 2)  # engine i calls per_round[i] K1s a round
    barrier = threading.Barrier(2, timeout=30)

    def step_for(i):
        def step(_g):
            for _ in range(rounds):
                barrier.wait()
                for _ in range(per_round[i]):
                    ca._count("paged_decode")
                ca._count("flash_causal" if i else "flash_prefix")
        return step

    class G:
        key = ("stub",)

    graphs = [G(), G()]
    replays = (3, 5)
    errors = []

    def run(i):
        try:
            engines[i]._step = step_for(i)
            engines[i]._capture(graphs[i])
            for _ in range(replays[i]):
                ca.count_replay(graphs[i].captured)
        except BaseException as e:  # reported below
            errors.append(e)

    ca.reset_launches()
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        by_thread = {k: dict(v) for k, v in ca.BY_THREAD.items()}
        launches = dict(ca.LAUNCHES)
    finally:
        sys.setswitchinterval(old_switch)
        ca.reset_launches()  # leave no counts behind for other tests
    assert not errors, errors
    assert graphs[0].captured == {"paged_decode": rounds,
                                  "flash_prefix": rounds}
    assert graphs[1].captured == {"paged_decode": 2 * rounds,
                                  "flash_causal": rounds}
    for t, g, n in zip(threads, graphs, replays):
        mine = {k: v for k, v in by_thread[t.ident].items() if v}
        assert mine == {k: n * v for k, v in g.captured.items()}
    assert launches == {k: sum(c[k] for c in by_thread.values())
                        for k in launches}


def test_launch_counts_add_up_per_thread(monkeypatch):
    """The global counts are the sum of the per-thread counts, under
    concurrent launches and replays from many threads."""
    from infinistore_tpu_torch.ops import cuda_attention as ca

    # launches are counted on the card only; no stream captures here
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    ca.reset_launches()
    n_threads, n = 8, 500
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    start = threading.Barrier(n_threads, timeout=30)  # all alive at once

    def run(i):
        start.wait()
        for _ in range(n):
            ca._count("paged_decode")
            ca.count_replay({"paged_decode": i, "flash_prefix": 1})

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        launches = dict(ca.LAUNCHES)
        by_thread = {k: dict(v) for k, v in ca.BY_THREAD.items()}
    finally:
        sys.setswitchinterval(old_switch)
        ca.reset_launches()
    want_k1 = n * n_threads + n * sum(range(n_threads))
    assert launches["paged_decode"] == want_k1
    assert launches["flash_prefix"] == n * n_threads
    assert len(by_thread) == n_threads
    for k in launches:
        assert sum(c[k] for c in by_thread.values()) == launches[k]


def test_kernel_build_from_many_threads_compiles_each_library_once(
        monkeypatch, tmp_path):
    """Engines on several threads of one process may launch their first
    kernel at once: the build runs one compiler per library and every
    caller gets the built libraries (a stand-in compiler writes each
    output after a pause, so the callers overlap)."""
    from infinistore_tpu_torch.ops import build

    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        "sleep 0.3\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    results, errors = [], []

    def run():
        try:
            results.append(build.build_all())
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(calls.read_text().split()) == len(build.SOURCES)
    for paths in results:
        assert paths == results[0]
        assert all(p.read_text() == "built\n" for p in paths.values())
