"""Mid-stream resumption, replicated routers and rolling restarts on the
port's fleet (the fleet cases of ``tests/test_resume.py``) on the CPU.

The reference's settings: the port's store server with a disk tier (so
``POST /spill`` is live), the port's ``local_fleet(..., device="cpu")``
with 1 prefill + 2 decode workers behind 2 router replicas, and
``ISTPU_RESUME_CKPT_TOKENS=4``.  Each case holds the reference's
assertions: a decode worker killed mid-stream is spliced onto the survivor
byte-exact, the resume contract refuses multi-choice and logprobs, each
router counts its replicas and merges the fleet view, a dead router
replica fails over with zero client errors, and every role restarts in
turn under a swarm with zero 5xx.
"""

import http.client
import json
import threading
import time

import pytest
import torch

from infinistore_tpu_torch import loadgen
from test_torch_frontdoor import (_SLO_ENV, _get, _last_record, _metric,
                                  _post, env_set, port_store)

torch.set_num_threads(2)


def _stream(port, body, headers=None, timeout=120.0):
    """POST a streaming completion; return (status, token_ids,
    resume_comment_count)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, [], 0
        toks, resumes = [], 0
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b": istpu-resume"):
                resumes += 1
            if line.startswith(b"data: "):
                data = line[6:].strip()
                if data == b"[DONE]":
                    break
                ev = json.loads(data)
                if "error" in ev:
                    return resp.status, toks, resumes
                ch = (ev.get("choices") or [{}])[0]
                toks.extend(ch.get("token_ids") or ())
        return resp.status, toks, resumes
    finally:
        conn.close()


@pytest.fixture(scope="module")
def live_store(tmp_path_factory):
    spill = tmp_path_factory.mktemp("spill")
    with port_store(("--disk-tier-path", str(spill),
                     "--disk-tier-size", "1")) as ports:
        yield ports


@pytest.fixture(scope="module")
def fleet(live_store):
    """1 prefill + 2 decode behind TWO router replicas, on the CPU; a
    tight checkpoint cadence so short streams cross it."""
    from infinistore_tpu_torch.frontdoor import local_fleet

    with env_set({**_SLO_ENV, "ISTPU_RESUME_CKPT_TOKENS": "4"}):
        fd, workers, close = local_fleet(live_store[0], 1, 2, poll_s=0.3,
                                         n_routers=2, device="cpu")
        try:
            status, _ = _post(fd.port, "/v1/completions",
                              {"prompt": [7, 7, 7, 7, 7], "max_tokens": 2,
                               "temperature": 0})
            assert status == 200
            yield fd, workers
        finally:
            close()


def _clear_faults(workers):
    for srv in workers["decode"] + workers["prefill"]:
        _post(srv.port, "/debug/faults", [])
    for r in workers["router"]:
        _post(r.port, "/debug/faults", [])


def _restores(port):
    _s, data = _get(port, "/metrics")
    prom = data.decode()
    return sum(_metric(prom, "istpu_serve_resume_restores_total",
                       result=r) or 0.0 for r in ("ok", "miss"))


def test_decode_death_mid_stream_resumes_byte_exact(fleet):
    """The scenario armed on the serving decode worker, the stream dies
    after 2 chunks, the router splices onto the survivor, and the client's
    token ids equal the no-fault baseline."""
    from infinistore_tpu_torch.frontdoor import affinity_stem

    fd, workers = fleet
    body = {"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_tokens": 12,
            "temperature": 0, "stream": True}

    status, baseline, res = _stream(fd.port, dict(body))
    assert status == 200 and len(baseline) == 12 and res == 0

    stem = affinity_stem(body, fd.affinity_tokens)
    victim = fd.decode_candidates(stem)[0]
    survivor_srv = next(s for s in workers["decode"]
                        if s.port != victim.port)
    victim_srv = next(s for s in workers["decode"]
                      if s.port == victim.port)
    restores_before = _restores(survivor_srv.port)

    status, out = _post(victim.port, "/debug/faults",
                        {"scenario": "decode_death_mid_stream"})
    assert status == 200 and out["armed"] == 1
    try:
        status, toks, res = _stream(fd.port, dict(body))
        assert status == 200
        assert res == 1, f"expected exactly one splice, saw {res}"
        assert toks == baseline, \
            f"splice not byte-exact:\n  want {baseline}\n  got  {toks}"

        _s, data = _get(fd.port, "/metrics")
        prom = data.decode()
        assert (_metric(prom, "istpu_fd_stream_resumes_total",
                        result="ok") or 0.0) >= 1.0
        assert (_metric(prom, "istpu_fd_stream_resumes_total",
                        result="failed") or 0.0) == 0.0

        assert _restores(survivor_srv.port) >= restores_before + 1.0

        _s, data = _get(victim_srv.port, "/metrics")
        vprom = data.decode()
        assert (_metric(vprom, "istpu_serve_resume_ckpt_writes_total")
                or 0.0) >= 1.0
        assert (_metric(vprom, "istpu_serve_resume_ckpt_tokens_total")
                or 0.0) >= 4.0

        rec = _last_record(survivor_srv.port)
        assert ((rec.get("store") or {}).get("store_chunks") or 0) >= 1, \
            rec
    finally:
        _clear_faults(workers)


def test_resume_rejects_multi_choice_and_logprobs(fleet):
    """The resume contract is single-choice, no logprobs: anything else
    409s at the worker instead of emitting a misaligned splice."""
    _fd, workers = fleet
    dec = workers["decode"][0]
    status, out = _post(dec.port, "/v1/completions",
                        {"prompt": [1, 2, 3, 4], "max_tokens": 2,
                         "temperature": 0, "stream": True, "n": 2},
                        headers={"X-Istpu-Resume": "1"})
    assert status == 409, out
    status, out = _post(dec.port, "/v1/completions",
                        {"prompt": [1, 2, 3, 4], "max_tokens": 2,
                         "temperature": 0, "stream": True, "logprobs": 2},
                        headers={"X-Istpu-Resume": "1"})
    assert status == 409, out


def test_router_replica_metrics_and_merged_fleet_view(fleet):
    fd, workers = fleet
    routers = workers["router"]
    assert len(routers) == 2
    for r in routers:
        _s, data = _get(r.port, "/metrics")
        assert (_metric(data.decode(), "istpu_fd_router_replicas")
                or 0.0) == 2.0
    _s, data = _get(fd.port, "/debug/fleet?merged=1")
    merged = json.loads(data)
    assert merged["role"] == "router-fleet"
    assert merged["replicas"] == 2
    assert merged["reachable"] == 2
    assert len(merged["routers"]) == 2
    assert merged["requests"]["2xx"] >= 1
    _s, data = _get(fd.port, "/debug/fleet")
    rep = json.loads(data)
    assert rep["router"]["replicas"] == 2
    assert "resumes" in rep["router"]["stream"]


def test_router_death_swarm_fails_over_with_zero_errors(fleet):
    """Scenario ``router_death`` on replica 2: a swarm whose start indices
    spread across the replica list fails over with zero client errors."""
    _fd, workers = fleet
    routers = workers["router"]
    dead = routers[1]
    status, out = _post(dead.port, "/debug/faults",
                        {"scenario": "router_death"})
    assert status == 200 and out["armed"] == 1
    try:
        urls = [f"http://127.0.0.1:{r.port}" for r in routers]
        cfg = loadgen.LoadConfig(rate=4.0, n_requests=8,
                                 process="deterministic", seed=3,
                                 mix=((1.0, 10, 3),), timeout_s=90.0)
        results, makespan = loadgen.run_load(urls, cfg)
        s = loadgen.summarize(results, makespan, 60, 10)
        assert s["completed"] == 8, s
        assert s["errors"] == 0, s
    finally:
        _clear_faults(workers)
    _s, data = _get(dead.port, "/debug/fleet")
    assert json.loads(data)["router"]["replicas"] == 2


def test_rolling_restart_every_role_zero_5xx(fleet, live_store):
    """Under an open-loop swarm across both routers, restart the store
    (``POST /spill`` warm drain), a decode worker, a prefill worker and a
    router replica in sequence: zero client-visible errors, zero 5xx from
    any router's ledger."""
    from infinistore_tpu_torch import lib as ist
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.frontdoor import FrontDoor
    from infinistore_tpu_torch.serve import ServingServer

    fd, workers = fleet
    store_port, store_mport = live_store
    routers = workers["router"]
    urls = [f"http://127.0.0.1:{r.port}" for r in routers]

    def fd_5xx(r):
        # the family's label is ``class`` (the reference's case reads a
        # ``code`` label, which no series carries)
        _s, data = _get(r.port, "/metrics")
        value = _metric(data.decode(), "istpu_fd_requests_total",
                        **{"class": "5xx"})
        assert value is not None, "no 5xx series on the router"
        return value

    before_5xx = [fd_5xx(r) for r in routers]

    cfg = loadgen.LoadConfig(rate=1.5, n_requests=18,
                             process="deterministic", seed=11,
                             mix=((1.0, 10, 8),), timeout_s=120.0)
    box = {}

    def drive():
        box["out"] = loadgen.run_load(urls, cfg)

    t = threading.Thread(target=drive, daemon=True)
    t.start()

    def restart_worker(role, idx):
        """Close one in-process worker and boot a fresh one (new store
        connection, the same weights, the SAME port)."""
        old = workers[role][idx]
        port = old.port
        eng0 = old.engine
        old.close()
        eng0.transfer.close()
        conn = ist.InfinityConnection(ist.ClientConfig(
            host_addr="127.0.0.1", service_port=store_port,
            connection_type=ist.TYPE_SHM, op_timeout_s=30.0,
            log_level="warning"))
        conn.connect()
        eng = InferenceEngine(eng0.params, eng0.cfg, eng0.pc, conn=conn,
                              model_id="fleet-tiny", kv_quant=None,
                              decode_chunk=4, device="cpu")
        srv = ServingServer(eng, port=port, max_batch=8,
                            model_id="fleet-tiny", role=role)
        srv.start()
        workers[role][idx] = srv
        return srv

    try:
        time.sleep(1.0)
        st, rep = _post(store_mport, "/spill", {})
        assert st == 200, rep

        time.sleep(1.5)
        restart_worker("decode", 1)

        time.sleep(1.5)
        restart_worker("prefill", 0)

        time.sleep(1.5)
        old = routers[1]
        rport = old.port
        peers = list(old.peers)
        old.close()
        nr = FrontDoor([f"http://127.0.0.1:{s.port}"
                        for s in workers["prefill"]],
                       [f"http://127.0.0.1:{s.port}"
                        for s in workers["decode"]],
                       port=rport, poll_s=0.3, peers=peers)
        nr.start()
        routers[1] = nr

        t.join(timeout=300)
        assert not t.is_alive(), "swarm did not drain"
        results, makespan = box["out"]
        s = loadgen.summarize(results, makespan, 60, 10)
        bad = [r for r in results if not r.get("ok")]
        assert s["completed"] == cfg.n_requests, (s, bad)
        assert s["errors"] == 0, (s, bad)
        for i, r in enumerate(routers):
            assert fd_5xx(r) - (before_5xx[i] if r is not nr else 0.0) \
                == 0.0, f"router {i} served a 5xx"
    finally:
        _clear_faults(workers)
