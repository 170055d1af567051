"""Subprocess fleet bring-up: the production shape of PD disaggregation,
on the port.

Boots FOUR separate OS processes — a store node, one prefill worker, one
decode worker, and the front-door router — exactly as a deployment would
(``python -m infinistore_tpu_torch.serve --role prefill|decode|router``;
the in-process ``local_fleet`` used by tests shares one interpreter and is
NOT this), then drives a few completions through the router and verifies
the handoff chain end to end:

    client -> router -> prefill worker --(store push + flush)-->
           -> decode worker --(store adoption)--> SSE tokens back

Usage::

    python -m infinistore_tpu_torch.examples.fleet_processes
        # demo on the GPU: prints progress
    python -m infinistore_tpu_torch.examples.fleet_processes --smoke \\
        --device cpu
        # CI: exit 0 iff every request completed, the router served no
        # 5xx and the decode worker adopted prompt pages from the store
        # (on the card also: both workers launched K3, the decode worker
        # K1 too)

Everything runs on localhost with the tiny random-init model and TCP
store connections; ``--device`` is the workers' torch device (``cuda`` by
default, ``cpu`` for a host without a GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

# the checkout holding the package: the workers start with ``-m`` from it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A port that was free a moment ago.  Another process may take it
    before a child binds it (an outgoing connection's local port, another
    test's listener): ``Listener`` starts the child again on fresh ports
    when that happens."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Listener:
    """A child process that listens on ports picked here.

    ``argv_for(*ports)`` builds its command line from ``n_ports`` fresh
    ports.  Its standard error is passed through to ours, and read for the
    bind error: ``ready`` waits until ``wait(ports[0], deadline, proc)``
    sees it serve, and if the child died because a port was taken between
    the pick and its bind (EADDRINUSE), starts it again on fresh ports, up
    to ``attempts`` times.  Any other failure raises."""

    def __init__(self, label, argv_for, n_ports, env, procs, attempts=5):
        self.label, self.argv_for, self.n_ports = label, argv_for, n_ports
        self.env, self.procs, self.attempts = env, procs, attempts
        self._start()

    def _start(self) -> None:
        self.ports = [free_port() for _ in range(self.n_ports)]
        argv = self.argv_for(*self.ports)
        print(f"[fleet] starting {self.label}: {' '.join(argv[2:])}",
              flush=True)
        self.proc = subprocess.Popen(argv, cwd=REPO, env=self.env,
                                     stderr=subprocess.PIPE)
        self.procs.append(self.proc)
        self.port_taken = False
        self._tee = threading.Thread(target=self._pass_stderr,
                                     args=(self.proc.stderr,), daemon=True)
        self._tee.start()

    def _pass_stderr(self, pipe) -> None:
        for line in iter(pipe.readline, b""):
            sys.stderr.buffer.write(line)
            sys.stderr.buffer.flush()
            if b"address already in use" in line.lower():
                self.port_taken = True

    def ready(self, wait, timeout_s: float) -> int:
        """Wait until the child serves; returns its first port."""
        for attempt in range(self.attempts):
            try:
                wait(self.ports[0], time.time() + timeout_s, self.proc)
                return self.ports[0]
            except RuntimeError:
                if self.proc.poll() is None:
                    raise  # alive but not serving: not a taken port
                self._tee.join(timeout=10)
                if not self.port_taken or attempt == self.attempts - 1:
                    raise
                print(f"[fleet] {self.label}: a port was taken before it "
                      f"bound; starting it again on fresh ports", flush=True)
                self._start()
        raise AssertionError("unreachable")


def wait_http(port: int, path: str, deadline: float, proc=None) -> None:
    while True:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"process died while waiting for :{port}{path} "
                f"(rc={proc.returncode})"
            )
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=1.0
            ):
                return
        except OSError:
            if time.time() >= deadline:
                raise RuntimeError(f"port {port}{path} did not come up")
            time.sleep(0.2)


def wait_tcp(port: int, deadline: float, proc=None) -> None:
    while True:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"process died (rc={proc.returncode})")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return
        except OSError:
            if time.time() >= deadline:
                raise RuntimeError(f"port {port} did not come up")
            time.sleep(0.1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: exit nonzero unless every request "
                         "completes, the router serves zero 5xx, the "
                         "decode worker adopts prompt pages from the "
                         "store and, on the card, the workers launch "
                         "K3 (both) and K1 (decode)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the workers' torch device: 'cuda' (the "
                         "hand-written kernels, CUDA-graph decode) or "
                         "'cpu' (their plain versions)")
    args = ap.parse_args()

    env = {
        **os.environ,
        # a cold fleet's first requests (kernel builds, graph captures)
        # must not trip the burn watchdogs / predictive shed during
        # bring-up
        "ISTPU_SLO_TTFT_S": os.environ.get("ISTPU_SLO_TTFT_S", "60"),
        "ISTPU_SLO_TPOT_S": os.environ.get("ISTPU_SLO_TPOT_S", "10"),
    }
    procs = []

    def http_ready(path):
        return lambda port, deadline, proc: wait_http(port, path, deadline,
                                                      proc)

    try:
        store = Listener("store", lambda port, mport: [
            sys.executable, "-m", "infinistore_tpu_torch.server",
            "--service-port", str(port), "--manage-port", str(mport),
            "--prealloc-size", "1", "--minimal-allocate-size", "16",
            "--log-level", "warning", "--backend", "python",
        ], 2, env, procs)
        # generous deadlines: on a loaded host (a test run in parallel
        # with others) an interpreter takes many seconds to start
        store_port = store.ready(wait_tcp, 120)

        worker_flags = [
            "--model", "tiny", "--block-tokens", "4", "--n-blocks", "128",
            "--device", args.device,
            "--store-host", "127.0.0.1",
            "--store-service-port", str(store_port),
            "--store-connection", "tcp", "--log-level", "warning",
        ]
        workers = {role: Listener(f"{role} worker", lambda port, role=role: [
            sys.executable, "-m", "infinistore_tpu_torch.serve",
            "--role", role, "--port", str(port), *worker_flags,
        ], 1, env, procs) for role in ("prefill", "decode")}
        # workers import torch + build engines before listening: generous
        # deadline, both booting in parallel
        pf_port = workers["prefill"].ready(http_ready("/healthz"), 180)
        dec_port = workers["decode"].ready(http_ready("/healthz"), 180)

        router = Listener("router", lambda port: [
            sys.executable, "-m", "infinistore_tpu_torch.serve",
            "--role", "router", "--port", str(port),
            "--prefill-workers", f"127.0.0.1:{pf_port}",
            "--decode-workers", f"127.0.0.1:{dec_port}",
            "--log-level", "warning",
        ], 1, env, procs)
        router_port = router.ready(http_ready("/healthz"), 120)

        url = f"http://127.0.0.1:{router_port}"
        completed = failed = 0
        for i in range(args.requests):
            body = json.dumps({
                "prompt": [(i * 7 + j) % 200 + 1 for j in range(16)],
                "max_tokens": 4, "temperature": 0,
            }).encode()
            req = urllib.request.Request(
                url + "/v1/completions", data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out = json.load(r)
                toks = out["choices"][0]["token_ids"]
                if r.status != 200 or len(toks) != 4:
                    raise RuntimeError(f"malformed answer: {out}")
                completed += 1
                print(f"[fleet] request {i}: 200, tokens={toks}",
                      flush=True)
            except (OSError, RuntimeError, ValueError, KeyError) as e:
                failed += 1
                print(f"[fleet] request {i} FAILED: {e!r}", flush=True)

        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            prom = r.read().decode()
        m = re.search(r'istpu_fd_requests_total\{class="5xx"\} (\S+)', prom)
        fivexx = float(m.group(1)) if m else 0.0
        with urllib.request.urlopen(url + "/debug/fleet", timeout=10) as r:
            fleet = json.load(r)
        # the handoff's proof: prompt tokens the decode worker adopted
        # from the store instead of computing them
        with urllib.request.urlopen(f"http://127.0.0.1:{dec_port}/metrics",
                                    timeout=10) as r:
            m = re.search(r'istpu_engine_prefix_tokens_total'
                          r'\{source="store"\} (\S+)', r.read().decode())
        adopted = float(m.group(1)) if m else 0.0
        # each worker's hand-written kernel launches: a cold prompt on the
        # prefill worker runs K3, and so does the decode worker's tail over
        # the adopted prefix (with a q_offset); its decode steps run K1.
        # The 16-token prompts fit one prefill chunk, so K2 has no call.
        launches = {}
        for role, port in (("prefill", pf_port), ("decode", dec_port)):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/engine?limit=1",
                    timeout=10) as r:
                launches[role] = json.load(r)["kernel_launches"]
        print(f"[fleet] done: {completed}/{args.requests} completed, "
              f"{failed} failed, router 5xx={fivexx:.0f}, workers="
              f"{[w.get('role') for w in fleet.get('workers', [])]}, "
              f"decode worker adopted {adopted:.0f} prompt tokens from "
              f"the store; kernel launches {json.dumps(launches)}",
              flush=True)
        ok = (completed == args.requests and failed == 0 and fivexx == 0.0
              and adopted > 0)
        if args.device != "cpu":
            ok = ok and (launches["prefill"]["flash_causal"] > 0
                         and launches["decode"]["flash_causal"] > 0
                         and launches["decode"]["paged_decode"] > 0)
        if args.smoke and not ok:
            print("[fleet] SMOKE FAILED", flush=True)
            return 1
        print("[fleet] OK", flush=True)
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())
