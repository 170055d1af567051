"""One run of one cell: set up the served path, open the window, close it,
read the metrics, check the answers.

``run_cell`` is the whole run; ``run.py`` is its command line.  A run:

1. starts the load generator (``loadgen.py``) in a child process;
2. draws the configuration's weights from the seed on the device
   (``families/<family>.py``) and builds the program's served path:
   ``InferenceEngine`` under a ``ServingServer`` on an ephemeral port in
   this process, with ``ISTPU_ADMISSION=0``;
3. warms up: every prefill and decode shape class the traffic's prompts,
   batches and contexts reach, and each tenant's system prompt once;
4. starts the mix's traffic ``warmup_s`` before the window opens and lets
   it run into the window (everything until the window opens is
   ``setup_s``), sends for ``seconds`` more, then waits out the drain;
   with ``--trace 1`` the scheduler steps of the window's last
   ``trace_s`` seconds run under the profiler;
5. reads ``memory_peak_bytes``, frees the program's state, computes the
   cell's metrics (``metrics/<name>.py``) and checks the served tokens of a
   seeded sample of greedy requests against the plain reference
   (``check.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from . import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "infinistore_tpu")

DEFAULTS = {"warmup_s": 12.0, "drain_s": 90.0, "trace_s": 5.0}
# a batch all of whose rows decode greedily, with one request in eight
# greedy, has at most this many rows in practice ((1/8)**4 < 3e-4)
GREEDY_ROWS = 4


def load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start stamp)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def cell_spec(workload: str, bench: Optional[dict] = None) -> Dict[str, Any]:
    """The cell's entry, configuration, traffic mix, limits and the
    metrics it reports, found by name from ``BENCHMARK.json``."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT, conf["file"])
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "checks", workload + ".json")

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class LoadGen:
    """The child process that sends the traffic."""

    def __init__(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.loadgen"], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def run(self, **cmd) -> Dict[str, Any]:
        self.proc.stdin.write(json.dumps({"cmd": "run", **cmd}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the load generator exited")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"cmd": "exit"}) + "\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


class Run:
    """What one window left behind, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_rows(self) -> List[dict]:
        """Requests due in the window."""
        return [r for r in self.rows
                if self.t_open <= r["due"] < self.t_close]

    def finished_rows(self) -> List[dict]:
        """Requests whose last token came inside the window."""
        return [r for r in self.rows if r["ok"]
                and self.t_open <= r["last"] <= self.t_close]

    def window_steps(self) -> List[dict]:
        return [s for s in self.steps
                if s["t0"] >= self.t_open and s["t1"] <= self.t_close]

    def span_steps(self) -> List[dict]:
        """The scheduler steps the device trace covers."""
        if not self.trace:
            return []
        keep = set(self.trace["steps"])
        return [s for s in self.steps if s["n"] in keep]

    def ledger_rows(self) -> List[dict]:
        return [self.ledger[r["trace_id"]] for r in self.window_rows()
                if r["trace_id"] in self.ledger]


def build_server(spec, params, device):
    """The program's served path over ``params``."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.serve import ServingServer

    config, eng = spec["config"], spec["config"]["engine"]
    fam = importlib.import_module("portbench.families." + config["family"])
    cfg = fam.port_config(config["config"])
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=eng["n_blocks"],
                          block_tokens=eng["block_tokens"], dtype=cfg.dtype)
    engine = InferenceEngine(params, cfg, pc, model_id=config["name"],
                             prefill_chunk=eng["prefill_chunk"],
                             decode_chunk=eng["decode_chunk"], device=device,
                             **fam.engine_kwargs())
    return ServingServer(engine, host="127.0.0.1", port=0,
                         max_batch=eng["max_batch"], model_id=config["name"],
                         prefill_concurrency=eng["prefill_concurrency"],
                         ledger_ring=1_000_000)


def _pow2_sizes(lo: int, hi: int, base: int) -> List[int]:
    """``base * 2**k`` from the first at or above ``lo`` to the first at
    or above ``hi``."""
    out, v = [], base
    while True:
        if v >= lo:
            out.append(v)
        if v >= hi:
            return out
        v *= 2


def warm_graphs(server, spec) -> int:
    """Run, before the window, every prefill and decode shape class the
    mix reaches, so that the window replays graphs and captures none.
    Sizes go in powers of two, the classes the engine's graphs are keyed
    by: prompts of ``m`` whole chunks and a tail of each power-of-two
    length (``m`` 0, 1 and 2**k + 1); for a mix whose prompts share
    prefixes, a tail of each length over a cached prefix of each
    power-of-two class from the shortest shared prefix; then one decode
    step at every power-of-two batch up to ``max_batch`` and every
    power-of-two page-table width over the mix's contexts, sampled, and
    all-greedy where a batch that size can be all greedy (at most
    ``GREEDY_ROWS`` rows).  Returns how many graphs were captured."""
    engine = server.engine
    eng, mix = spec["config"]["engine"], spec["mix"]
    T, C = eng["block_tokens"], eng["prefill_chunk"]
    V = spec["config"]["config"]["vocab_size"]
    before = sum(engine.graph_captures.values())
    seq = iter(range(1, 1 << 40))

    def prompt(n):  # never seen before: no prefix hit
        k = next(seq)
        return [(k * 7919 + 104729 * j) % V for j in range(n)]

    lo_p, hi_p = traffic.context_range(mix)[0], traffic.prompt_max(mix)
    tails = _pow2_sizes(T, C, T)
    ms, k = [0, 1], 1
    while C * (k + 1) < hi_p:
        ms.append(k + 1)
        k *= 2
    for m in ms:
        for t in tails:
            if m * C + t <= hi_p and (m or t * 2 > lo_p or t == tails[-1]):
                engine.release(engine.prefill(prompt(m * C + t)))
    if mix["loop"] == "open_sessions":
        # a tail in one chunk over an exact cached prefix replays a graph
        # up to the engine's bound on the prefix, and runs eagerly above
        from infinistore_tpu_torch.engine.engine import TAIL_GRAPH_PREFIX

        shortest = min(mix["tenants"]["system_tokens"])
        for P in _pow2_sizes(shortest, TAIL_GRAPH_PREFIX, T):
            head = prompt(P)
            engine.release(engine.prefill(head))
            for t in tails:
                engine.release(engine.prefill(head + prompt(t)))
    lo_ctx, hi_ctx = traffic.context_range(mix)
    widths = _pow2_sizes(lo_ctx // T, hi_ctx // T + 1, 8)
    batches = _pow2_sizes(1, eng["max_batch"], 1)
    fill = engine.prefill_batch([prompt(T)
                                 for _ in range(eng["max_batch"] - 1)])
    sampling = {"sample": "categorical", "temperature": 0.7, "top_p": 0.95}
    for w in widths:
        long = engine.prefill(prompt((w // 2) * T + 1))  # needs width w
        for b in batches:
            rows = [long] + fill[: b - 1]
            engine.decode_batch(rows, 1, **sampling)
            if b <= GREEDY_ROWS:
                engine.decode_batch(rows, 1, sample="greedy")
        engine.release(long)
    for st in fill:
        engine.release(st)
    return sum(engine.graph_captures.values()) - before


def _sample_backlog(server, stop: threading.Event, out: list) -> None:
    while not stop.wait(0.5):
        out.append((time.monotonic(), len(server.sched.pending)))


def serve_window(server, lg: LoadGen, spec, seed: int, seconds: float,
                 trace: bool, cuda: bool, mix: Optional[dict] = None):
    """One measured window over a running server: returns the loadgen's
    reply, the recorder's steps, the profiler's reduction and the ledger
    and step-profiler records."""
    from . import trace as trace_mod
    from .recorder import StepRecorder

    mix = mix or spec["mix"]
    opts = {**DEFAULTS, **mix.get("harness", {})}
    rec = getattr(server, "_pb_recorder", None)
    if rec is None:
        rec = server._pb_recorder = StepRecorder()
        rec.install(server)
    # the traffic starts ``warmup_s`` before the window and runs straight
    # into it, so the window opens on the mix's steady state: a full batch,
    # sessions at every turn
    lead = opts["warmup_s"]
    t0 = time.monotonic() + 0.5 + lead
    t_close = t0 + seconds
    prof = None
    if trace:
        prof = trace_mod.Profiler(cuda)
        rec.arm(prof, t_close - min(opts["trace_s"], seconds), t_close)
    backlog: list = []
    stop = threading.Event()
    sampler = threading.Thread(target=_sample_backlog,
                               args=(server, stop, backlog), daemon=True)
    sampler.start()
    ledger0 = server.ledger.recorded
    reply = lg.run(host="127.0.0.1", port=server.port, mix=mix, seed=seed,
                   vocab=spec["config"]["config"]["vocab_size"], t0=t0,
                   window_s=seconds, drain_s=opts["drain_s"], lead_s=lead)
    stop.set()
    sampler.join()
    steps = rec.snapshot()
    red = None
    if prof is not None:
        if prof.started and not prof.stopped:
            # the engine idles: a step after the span's end stops it
            time.sleep(max(0.0, t_close - time.monotonic()))
            _wake(server)
        rec.profiler = None
        if prof.started and not prof.stopped:
            raise RuntimeError("the profiled span never reached a step end")
        red = trace_mod.reduce(prof.result) if prof.stopped else None
    n_new = server.ledger.recorded - ledger0
    ledger = {r["trace_id"]: r for r in server.ledger.tail(n_new)}
    # the step profiler stamps wall time: its records back on this clock
    offset = time.time() - time.monotonic()
    stepprof = [{**r, "t_mono": r["t_wall"] - offset}
                for r in server.stepprof.tail() if "t_wall" in r]
    return {"reply": reply, "t0": t0, "t_close": t_close, "steps": steps,
            "trace": red, "ledger": ledger, "stepprof": stepprof,
            "backlog": backlog}


def _wake(server) -> None:
    """One one-token request, so that the engine thread runs a step."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    try:
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": [1, 2, 3], "max_tokens": 1, "temperature": 0}),
            {"Content-Type": "application/json"})
        conn.getresponse().read()
    finally:
        conn.close()


def card(cuda: bool) -> Dict[str, Any]:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def stage(what: str) -> None:
    """A set-up or run stage on standard error, with the process's age."""
    print(f"[stage] {process_age_s():9.3f} s  {what}", file=sys.stderr,
          flush=True)


def _graph_keys(engine) -> set:
    return set(engine._graphs) | set(engine._prefill_graphs)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def setup(spec, seed: int, device: str, lg: LoadGen):
    """Weights, the served path and its warm-up; returns (params, server,
    graphs captured in the warm-up)."""
    import torch

    os.environ["ISTPU_ADMISSION"] = "0"
    os.environ.setdefault("ISTPU_STEPPROF_RING", "1000000")
    fam = importlib.import_module("portbench.families."
                                  + spec["config"]["family"])
    params = fam.draw(spec["config"]["config"], seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    stage("weights drawn")
    server = build_server(spec, params, device)
    server.start()
    stage("server built")
    cuda = device == "cuda"
    captured = warm_graphs(server, spec) if cuda else 0
    stage(f"graphs warmed ({captured} captured)")
    mix = spec["mix"]
    opts = {**DEFAULTS, **mix.get("harness", {})}
    V = spec["config"]["config"]["vocab_size"]
    if mix["loop"] == "open_sessions":
        sysp = lg.run(host="127.0.0.1", port=server.port, mix=mix, seed=seed,
                      vocab=V, t0=time.monotonic(), window_s=1.0,
                      drain_s=opts["drain_s"], system_only=True)
        bad = [r for r in sysp["rows"] if not r["ok"]]
        if bad:
            raise RuntimeError(f"system prompts failed: {bad[:2]}")
        stage("system prompts served")
    return params, server, captured


def free_server(server) -> None:
    import torch

    server.close()
    engine = server.engine
    engine.cache = None
    for held in (engine._graphs, engine._prefill_graphs, engine._pf_shared,
                 engine._pf_prefix):
        held.clear()
    del server, engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[dict] = None,
             fault=None) -> Dict[str, Any]:
    """The whole run; returns the result object (``run.py`` prints it).
    ``spec`` replaces the files' spec (the CPU tests' tiny cells);
    ``fault(server)``, when given, breaks the served path before the
    window (the tests' planted faults)."""
    import torch

    from . import check

    spec = spec or cell_spec(workload)
    cuda = device == "cuda"
    lg = LoadGen()
    try:
        params, server, captured = setup(spec, seed, device, lg)
        if fault is not None:
            fault(server)
        age0, m0 = process_age_s(), time.monotonic()
        keys0 = _graph_keys(server.engine)
        w = serve_window(server, lg, spec, seed, seconds, trace, cuda)
        setup_s = age0 + (w["t0"] - m0)
        new_keys = sorted(map(str, _graph_keys(server.engine) - keys0))
        stage("window closed and drained")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        block_tokens = server.engine.pc.block_tokens
        free_server(server)
        stage("program state freed")
        rows = w["reply"]["rows"]
        run = Run(spec=spec, cell=spec["cell"], config=spec["config"]["config"],
                  mix=spec["mix"], seed=seed, window_s=seconds,
                  t_open=w["t0"], t_close=w["t_close"], rows=rows,
                  steps=w["steps"], trace=w["trace"], ledger=w["ledger"],
                  stepprof=w["stepprof"], setup_s=setup_s,
                  block_tokens=block_tokens,
                  peak=None)
        if cuda:
            from .work import peaks

            run.peak = peaks(torch.cuda.get_device_name(0))
        wanted = spec["per_layer"] if trace else spec["end_to_end"]
        metrics = {}
        for m in wanted:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        due = run.window_rows()
        failed = sum(1 for r in due if not r["ok"])
        ok, checked = check.check(run, params, spec, seed)
        stage("reference check done")
        dev = {**card(cuda), "memory_peak_bytes": int(peak)}
        if cuda:
            dev["count"] = spec["cell"]["chips"]
        result = {"correct": ok, "attempted": len(due), "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace and w["trace"]:
            dev["busy_s"] = w["trace"]["busy_s"]
            dev["window_s"] = w["trace"]["span_s"]
            result["breakdown"] = w["trace"]["breakdown"]
        from . import stats

        ttft = [stats.ttft_s(r) for r in due]
        queue = [r["waterfall"]["queue_s"] for r in run.ledger_rows()]
        info = {"setup_s": setup_s,
                "ttft_p50_p95_s": [stats.percentile(ttft, 0.5),
                                   stats.percentile(ttft, 0.95)],
                "queue_p50_p95_s": [stats.percentile(queue, 0.5),
                                    stats.percentile(queue, 0.95)],
                "graphs_captured_in_setup": captured,
                "graph_keys_new_in_window": new_keys,
                "errors": sorted({str(r["error"]) for r in due
                                  if r["error"]})[:5]}
        result["checked"] = checked
        return {"result": result, "info": info}
    finally:
        lg.close()
