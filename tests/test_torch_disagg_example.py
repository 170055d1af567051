"""The port's deployable PD-disaggregation workflow (the counterpart of
``tests/test_disagg_example.py``) on the CPU: a prefill-node process and
a decode-node process (``python -m infinistore_tpu_torch.examples.
disagg_prefill`` / ``disagg_decode``), separate engines, the port's store
server, TCP transport — the decode node's greedy tokens equal the port's
in-process monolith (TINY, float32, exact), and it pulled every prompt
chunk it may adopt from the store.  Then the four-process fleet (store,
prefill worker, decode worker, router: ``examples.fleet_processes
--smoke``) serves 25 completions with zero 5xx."""

import json
import os
import subprocess
import sys

import torch

from test_torch_frontdoor import port_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2]
T = 4
STEPS = 8

torch.set_num_threads(2)


def _run_node(module: str, service: int, extra=()) -> dict:
    """Spawn a node process exactly as an operator would."""
    r = subprocess.run(
        [sys.executable, "-m", f"infinistore_tpu_torch.examples.{module}",
         "--service-port", str(service), "--connection", "tcp",
         "--prompt", ",".join(map(str, PROMPT)),
         "--block-tokens", str(T), "--device", "cpu", *extra],
        capture_output=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return json.loads(r.stdout.decode().strip().splitlines()[-1])


def test_two_process_pd_disaggregation():
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import TINY, init_params, scaled

    # monolithic reference: the same model (the examples' seed), no store
    cfg = scaled(TINY, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = InferenceEngine(params, cfg, PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, block_tokens=T, n_blocks=256,
        dtype=cfg.dtype,
    ), device="cpu")
    st = eng.prefill(PROMPT)
    want = eng.decode(st, STEPS)

    with port_store() as (service, _manage):
        pre = _run_node("disagg_prefill", service)
        assert pre["chunks_stored"] == len(PROMPT) // T
        assert pre["n_tokens"] == len(PROMPT)

        dec = _run_node("disagg_decode", service,
                        extra=("--steps", str(STEPS)))
    assert dec["reused_chunks"] == len(PROMPT) // T  # no recompute
    assert dec["tokens"] == want  # identical to the monolith


def test_fleet_processes_smoke_25_requests_zero_5xx():
    r = subprocess.run(
        [sys.executable, "-m", "infinistore_tpu_torch.examples.fleet_processes",
         "--smoke", "--device", "cpu", "--requests", "25"],
        capture_output=True, timeout=300, cwd=REPO,
    )
    out = r.stdout.decode()
    assert r.returncode == 0, out[-3000:] + r.stderr.decode()[-2000:]
    assert "[fleet] done: 25/25 completed, 0 failed, router 5xx=0" in out, \
        out[-3000:]
    # every prompt is fresh (16 tokens): the decode worker adopts the
    # (16 - 1) // 4 chunks the adoption rule allows, 12 tokens a request
    adopted = 25 * ((16 - 1) // 4) * 4
    assert ("workers=['prefill', 'decode'], decode worker adopted "
            f"{adopted} prompt tokens from the store") in out, out[-3000:]


def test_fleet_child_starts_again_on_a_port_taken_before_it_bound(
        monkeypatch):
    """The four-process fleet picks each child's port, closes it and hands
    it over; under a loaded test run another process may take the port in
    between, and the child dies with EADDRINUSE.  The example then starts
    that child again on a fresh port."""
    import socket

    from infinistore_tpu_torch.examples import fleet_processes as fp

    taken = socket.socket()  # bound, not listening: as a client's port
    taken.bind(("127.0.0.1", 0))
    picks = iter([taken.getsockname()[1]])
    real = fp.free_port
    monkeypatch.setattr(fp, "free_port", lambda: next(picks, None) or real())
    procs = []
    try:
        child = fp.Listener("listener", lambda port: [
            sys.executable, "-c",
            "import socket, sys, time; s = socket.socket(); "
            "s.bind(('127.0.0.1', int(sys.argv[1]))); s.listen(); "
            "time.sleep(60)", str(port)], 1, dict(os.environ), procs)
        port = child.ready(fp.wait_tcp, 60)
        assert port != taken.getsockname()[1]
        assert len(procs) == 2 and procs[0].returncode not in (None, 0)
        assert procs[1].poll() is None
    finally:
        taken.close()
        for p in procs:
            p.kill()
            p.wait()
