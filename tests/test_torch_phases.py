"""The step profiler's host phases, work counters and the ledger's
first-hold slice on the port (``engine/stepprof.py``'s ``phase`` and
``note_work``, ``scheduler.Request.t_prefilled``), and the benchmark's
readers of them (``portbench/metrics/{prefill_eager_share,decode_prep_ms,
loop_host_ms}.py``).

The shared-clock case runs scheduler steps under a CPU ``torch.profiler``
session: every phase is a CPU range of the Kineto trace nested in its
step's ``engine.step#<n>`` range, and the record's ``t0_ns``/``t1_ns``
are on the clock of the profiler's events (``time.time_ns``): a step's
range holds its record's interval and a phase's range lies inside its
record's, apart by the profiler's own cost, under 1 ms at 95 % of the
ends."""

import dataclasses
import http.client
import json
import threading
import time
import types

import pytest
import torch

from infinistore_tpu_torch.engine import InferenceEngine, Scheduler
from infinistore_tpu_torch.engine import stepprof
from infinistore_tpu_torch.engine.stepprof import StepProfiler, phase
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.ledger import build_record
from infinistore_tpu_torch.models.llama import TINY, init_params
from infinistore_tpu_torch.utils import tracing
from infinistore_tpu_torch.utils.metrics import MetricsRegistry

CFG = dataclasses.replace(TINY, dtype=torch.float32)
PARAMS = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
T = 8  # tokens a page


def _engine(prefill_chunk=None, decode_chunk=4):
    pc = PagedCacheConfig(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
                          head_dim=CFG.head_dim, n_blocks=256,
                          block_tokens=T, dtype=torch.float32)
    return InferenceEngine(PARAMS, CFG, pc, device="cpu",
                           prefill_chunk=prefill_chunk,
                           decode_chunk=decode_chunk)


def _prof(**kw):
    kw.setdefault("metrics", MetricsRegistry())
    kw.setdefault("sample", 10 ** 6)
    return StepProfiler(**kw)


def _spin(seconds):
    """Work this thread's CPU for ``seconds``."""
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------


def test_phase_sums_wall_and_cpu_seconds_on_the_step_record():
    prof = _prof()
    with prof.step() as rec:
        with phase("a"):
            time.sleep(0.05)  # waits: wall, no CPU
        with phase("a"):
            pass
        with phase("b", prof):  # inside a step: the step's, not the loop's
            _spin(0.05)  # works: 0.05 s of this thread's CPU clock
    a, b = rec["phases"]["a"], rec["phases"]["b"]
    assert set(a) == {"n", "wall_s", "cpu_s", "t0_ns", "t1_ns"}
    assert a["n"] == 2 and b["n"] == 1
    assert a["wall_s"] >= 0.05 and a["cpu_s"] < 0.02
    assert b["cpu_s"] >= 0.05
    assert rec["t0_ns"] <= a["t0_ns"] < a["t1_ns"] <= b["t0_ns"] \
        < b["t1_ns"] <= rec["t1_ns"]
    assert a["t1_ns"] - a["t0_ns"] >= 0.05e9
    assert "loop" not in rec and rec["work"] == {}
    assert prof.tail()[-1]["phases"] == rec["phases"]


@pytest.mark.parametrize("timed", [False, True])
def test_phase_without_a_record(timed):
    """No step record and no profiler: a plain phase reads no clock and
    records nothing; a timed one keeps its wall seconds and its span."""
    prof = _prof()
    with tracing.trace("test.phase") as tr:
        with phase("x.alone", timed=timed, k=1) as ph:
            time.sleep(0.005)
    assert (ph.wall_s >= 0.005) is timed
    if not timed:
        assert ph.wall_s == 0.0
    spans = [e for e in tr.events if e[0] == "x.alone"]
    assert len(spans) == int(timed)
    if timed:
        assert spans[0][4] == {"k": 1}
        assert spans[0][2] - spans[0][1] == pytest.approx(ph.wall_s)
    with prof.step() as rec:
        pass
    assert "loop" not in rec and rec["phases"] == {}


def test_phase_spans_into_the_trace_it_names():
    """``trace_id`` sends the span to that trace whatever trace is current
    (the scheduler's ``sched.prefill_step`` opens outside the request's
    binding); an unknown id drops it."""
    with tracing.trace("test.named") as named:
        pass
    prof = _prof()
    with tracing.trace("test.ambient") as ambient:
        with prof.step():
            with phase("x.named", timed=True, trace_id=named.trace_id,
                       k=2):
                pass
            with phase("x.lost", timed=True, trace_id="no-such-trace"):
                pass
    assert [(e[0], e[4]) for e in named.events if e[0].startswith("x.")] \
        == [("x.named", {"k": 2})]
    assert not [e for e in ambient.events if e[0].startswith("x.")]
    assert prof.tail()[-1]["phases"]["x.lost"]["n"] == 1


def test_loop_phases_ride_into_the_next_step():
    prof = _prof()
    with phase("loop.intake", prof):
        time.sleep(0.003)
    with phase("loop.intake", prof):
        pass
    with phase("loop.wait", prof):
        pass
    with prof.step() as rec1:
        with phase("sched.admit", prof):
            pass
    with prof.step() as rec2:
        pass
    assert set(rec1["loop"]) == {"loop.intake", "loop.wait"}
    assert rec1["loop"]["loop.intake"]["n"] == 2
    assert rec1["loop"]["loop.intake"]["wall_s"] >= 0.003
    assert rec1["loop"]["loop.intake"]["t1_ns"] <= rec1["t0_ns"]
    assert set(rec1["phases"]) == {"sched.admit"}
    assert "loop" not in rec2
    # a disabled profiler piles nothing
    off = _prof()
    off.enabled = False
    with phase("loop.intake", off) as ph:
        pass
    assert ph.wall_s == 0.0 and off._loop == {}


@pytest.mark.parametrize("profiling", [False, True])
def test_record_function_only_under_a_profiler_session(profiling,
                                                       monkeypatch):
    stepprof._profiling()  # binds torch's record_function
    made = []
    real = stepprof._RECORD_FUNCTION

    def spy(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(stepprof, "_RECORD_FUNCTION", spy)
    prof = _prof()
    if profiling:
        session = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        session = None
    if session is not None:
        session.__enter__()
    try:
        with prof.step() as rec:
            with phase("x.ranged"):
                torch.ones(4).sum()
    finally:
        if session is not None:
            session.__exit__(None, None, None)
    step = f"engine.step#{rec['step']}"
    assert made == ([step, "x.ranged"] if profiling else [])
    if profiling:
        names = {e.name for e in session.events()}
        assert {step, "x.ranged"} <= names


# ---------------------------------------------------------------------------
# the shared clock: phases in the Kineto trace, nested in their steps
# ---------------------------------------------------------------------------


def test_phases_land_in_the_device_trace_on_the_records_clock():
    from torch.autograd import profiler as P

    eng = _engine(prefill_chunk=None, decode_chunk=4)
    prof = _prof()
    sched = Scheduler(eng, max_batch=4, stepprof=prof,
                      metrics=MetricsRegistry())
    prompt = [(7 * j + 3) % CFG.vocab_size for j in range(24)]
    session = P.profile(use_kineto=True)
    session._prepare_trace()
    session._start_trace()
    try:
        sched.submit(prompt, 8, on_token=lambda toks, done: None)
        sched.step()  # a wave of one: the eager whole-prompt forward
        # beside a decoding batch, a prompt over the cached prefix: its
        # single chunk through the prefill graph's body
        sched.submit(prompt[:16] + [5, 6, 7, 8, 9], 8,
                     on_token=lambda toks, done: None)
        with phase("loop.intake", prof):
            pass
        while sched.has_work:
            sched.step()
    finally:
        result = P._disable_profiler()
    recs = prof.tail()
    seen = set()
    for rec in recs:
        seen |= set(rec["phases"])
    assert {"sched.admit", "sched.book", "sched.prefill_step",
            "sched.decode_chunk", "sched.retire", "sched.stream",
            "prefill.inputs",
            "prefill.eager", "prefill.graph", "prefill.land",
            "prefill.finish", "decode.prep", "decode.replay",
            "decode.sync", "decode.unpack"} <= seen
    assert any("loop.intake" in r.get("loop", {}) for r in recs)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in result.events()
              if str(e.device_type()).endswith("CPU")]
    # a step's range opens just before its first reading and closes just
    # after its last: it holds the record's interval; a phase's range
    # opens just after its first reading and closes just before its last:
    # it lies inside the record's interval.  Both to the clocks' offset
    # (under 50 us), apart by the profiler's own cost, microseconds, now
    # and then a stall of a millisecond or more
    slack, apart = 50e3, []

    def holds(start, end, t0, t1):
        assert start <= t0 + slack and end >= t1 - slack, (start, t0,
                                                          end, t1)
        apart.extend((t0 - start, end - t1))

    def inside(start, end, t0, t1):
        assert start >= t0 - slack and end <= t1 + slack, (start, t0,
                                                          end, t1)
        apart.extend((start - t0, t1 - end))

    for rec in recs:
        (s0, s1), = [(a, b) for n, a, b in events
                     if n == f"engine.step#{rec['step']}"]
        holds(s0, s1, rec["t0_ns"], rec["t1_ns"])
        for name, ph in rec["phases"].items():
            ranges = sorted((a, b) for n, a, b in events
                            if n == name and s0 <= a <= s1)
            assert len(ranges) == ph["n"], (rec["step"], name)
            assert all(b <= s1 for _a, b in ranges)
            inside(ranges[0][0], ranges[-1][1], ph["t0_ns"], ph["t1_ns"])
            ranged = sum(b - a for a, b in ranges)
            assert ranged <= ph["wall_s"] * 1e9 + slack * ph["n"]
            apart.append(ph["wall_s"] * 1e9 - ranged)
    apart.sort()
    assert apart[int(0.95 * len(apart))] < 1e6  # within 1 ms


def test_decode_histogram_times_the_decode_phase():
    """One timer: ``istpu_serve_decode_step_seconds`` observes exactly the
    ``sched.decode_chunk`` phase's readings."""
    eng = _engine(prefill_chunk=16, decode_chunk=4)
    prof = _prof()
    reg = MetricsRegistry()
    sched = Scheduler(eng, max_batch=4, stepprof=prof, metrics=reg)
    for i in range(3):
        sched.submit([(11 * i + j) % CFG.vocab_size + 1
                      for j in range(9 + 7 * i)], 8 + 4 * i)
    sched.run()
    chunks = [r["phases"]["sched.decode_chunk"] for r in prof.tail()
              if "sched.decode_chunk" in r["phases"]]
    count, total = reg.family_hist("istpu_serve_decode_step_seconds")
    assert count == sum(c["n"] for c in chunks) > 0
    assert total == pytest.approx(sum(c["wall_s"] for c in chunks),
                                  abs=1e-6 * count)


def test_top_level_phases_tile_the_step():
    """``sched.admit``, ``sched.book``, ``sched.prefill_step``,
    ``sched.decode_chunk`` and ``sched.retire`` hold all of a step but a
    few statements between them: chunked prefills beside a decoding
    batch, budgets that end mid-chunk."""
    eng = _engine(prefill_chunk=16, decode_chunk=4)
    prof = _prof()
    sched = Scheduler(eng, max_batch=4, stepprof=prof,
                      metrics=MetricsRegistry())
    for i in range(5):
        sched.submit([(3 * i + j) % CFG.vocab_size + 1
                      for j in range(12 + 9 * i)], 5 + 3 * i)
    sched.run()
    top = ("sched.admit", "sched.book", "sched.prefill_step",
           "sched.decode_chunk", "sched.retire")
    recs = prof.tail()
    covered = [sum(r["phases"].get(n, {}).get("wall_s", 0.0) for n in top)
               for r in recs]
    assert len(recs) > 5 and all(
        c <= r["dur_s"] + 1e-5 for c, r in zip(covered, recs))
    assert sum(covered) >= 0.95 * sum(r["dur_s"] for r in recs)


def test_delivery_is_one_phase_a_retirement_and_a_slice_a_request():
    """``sched.stream`` is entered once a retirement, around every
    request's delivery; each request's ledger stream slice holds its own
    callback's time, which the pass holds in turn."""
    eng = _engine(prefill_chunk=None, decode_chunk=4)
    prof = _prof()
    sched = Scheduler(eng, max_batch=4, stepprof=prof,
                      metrics=MetricsRegistry())
    slow = {0: 0.004, 1: 0.0}
    got = {0: [], 1: []}

    def on_token(i):
        def deliver(toks, done):
            time.sleep(slow[i])
            got[i].extend(toks)
        return deliver

    ids = [sched.submit([(5 * i + j) % CFG.vocab_size + 1
                         for j in range(10)], 8, on_token=on_token(i))
           for i in range(2)]
    done = {}
    while sched.has_work:
        done.update((r.req_id, r) for r in sched.step())
    reqs = [done[i] for i in ids]
    retires = [r["phases"] for r in prof.tail()
               if "sched.retire" in r["phases"]]
    assert retires
    for ph in retires:
        assert ph["sched.stream"]["n"] == ph["sched.retire"]["n"] == 1
        assert ph["sched.stream"]["wall_s"] <= ph["sched.retire"]["wall_s"]
    assert [got[i] for i in (0, 1)] == [r.output for r in reqs]
    # request 0 sleeps 4 ms a delivery, request 1 none
    assert reqs[0].t_stream_s >= 0.004 * len(retires) > reqs[1].t_stream_s
    assert sum(ph["sched.stream"]["wall_s"] for ph in retires) \
        >= reqs[0].t_stream_s + reqs[1].t_stream_s


# ---------------------------------------------------------------------------
# work counted at launch, against the benchmark's recorder
# ---------------------------------------------------------------------------


def _complete(port, prompt, max_tokens, out, i):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out[i] = (resp.status, json.loads(resp.read()))
    finally:
        conn.close()


def test_work_counters_match_the_recorder_on_a_served_run(monkeypatch):
    """Budgets that end on decode-chunk boundaries, so nothing is trimmed:
    the prompt positions the engine counts at launch are the recorder's
    prompt ranges; its decode rows and contexts are the recorder's
    delivered tokens plus, per request, the first token (the recorder
    credits it to the prefill) and the step that samples it: the engine's
    step j of a request with prompt P attends over P + j positions and
    makes token j, the recorder's token i was made by the step over
    P + i - 1."""
    from infinistore_tpu_torch.serve import ServingServer
    from portbench.recorder import StepRecorder

    monkeypatch.setenv("ISTPU_ADMISSION", "0")
    eng = _engine(prefill_chunk=16, decode_chunk=4)
    srv = ServingServer(eng, port=0, max_batch=4, prefill_concurrency=2)
    rec = StepRecorder()
    rec.install(srv)
    srv.start()
    jobs = [([(13 * i + 5 * j) % (CFG.vocab_size - 1) + 1
              for j in range(5 + 9 * i)], 4 * (1 + i % 3))
            for i in range(6)]
    out = [None] * len(jobs)
    try:
        threads = [threading.Thread(target=_complete,
                                    args=(srv.port, p, n, out, i))
                   for i, (p, n) in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        records = srv.stepprof.tail()
        ledger = srv.ledger.tail()
    finally:
        srv.close()
    assert all(o[0] == 200 for o in out), out
    steps = rec.snapshot()
    work = {}
    for r in records:
        for k, v in r["work"].items():
            work[k] = work.get(k, 0) + v
    prefilled = sum(b - a for s in steps for a, b, _s, _l in s["prefill"])
    assert work.get("prefill_tokens_graph", 0) \
        + work.get("prefill_tokens_eager", 0) == prefilled \
        == sum(len(p) for p, _n in jobs)
    delivered = sum(hi - lo + 1 for s in steps for _P, lo, hi in s["decode"])
    ctx = sum(P + i - 1 for s in steps for P, lo, hi in s["decode"]
              for i in range(lo, hi + 1))
    assert delivered == sum(n - 1 for _p, n in jobs)
    assert work["decode_rows"] == delivered + len(jobs)
    assert work["decode_ctx_tokens"] == ctx + sum(len(p) + n
                                                  for p, n in jobs)
    # the ledger's split of each served request's prefill
    assert len(ledger) == len(jobs)
    for row in ledger:
        wf, ev = row["waterfall"], dict(map(tuple, row["events"]))
        assert wf["first_hold_s"] > 0
        assert wf["prefill_s"] + wf["first_hold_s"] == pytest.approx(
            ev["first_token"] - ev["admit"] - row["store"]["load_s"],
            abs=3e-6)


# ---------------------------------------------------------------------------
# the ledger's first-hold slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_prefilled", [0.0, 100.55, 100.75, 101.0])
def test_first_hold_splits_the_old_prefill_slice(t_prefilled):
    req = types.SimpleNamespace(
        req_id=1, tokens=[1, 2, 3], max_new_tokens=8, priority=0,
        trace_id=None, tenant=None, t_submit=100.0, t_admit=100.5,
        t_first=101.0, t_done=103.0, t_prefilled=t_prefilled,
        t_stream_s=0.2, output=[7] * 5, stamps=[], step_ids=[],
        state=types.SimpleNamespace(reused_chunks=2, local_chunks=1,
                                    store_chunks=1, store_load_s=0.05))
    wf = build_record(req, "done")["waterfall"]
    old_prefill = (101.0 - 100.5) - 0.05
    assert wf["prefill_s"] + wf["first_hold_s"] == pytest.approx(old_prefill)
    assert wf["first_hold_s"] == pytest.approx(
        101.0 - t_prefilled if t_prefilled else 0.0)
    assert sum(wf.values()) == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def _ph(wall):
    return {"n": 1, "wall_s": wall, "cpu_s": wall, "t0_ns": 0, "t1_ns": 1}


def _run(records):
    return types.SimpleNamespace(
        t_open=10.0, t_close=20.0,
        stepprof=[{"t_mono": t, **r} for t, r in records])


READS = [
    # the share of prompt positions an eager forward computed
    ("prefill_eager_share",
     [(11.0, {"work": {"prefill_tokens_eager": 300,
                       "prefill_tokens_graph": 100}}),
      (12.0, {"work": {"prefill_tokens_graph": 600}}),
      (25.0, {"work": {"prefill_tokens_eager": 5000}})],  # after the window
     30.0),
    ("prefill_eager_share",
     [(11.0, {"work": {"decode_rows": 4}})], None),
    ("prefill_eager_share", [(11.0, {"dispatches": {}})], None),  # parent
    # decode.prep over the decode dispatches
    ("decode_prep_ms",
     [(11.0, {"phases": {"decode.prep": _ph(0.004)},
              "dispatches": {"decode": 1}}),
      (12.0, {"phases": {"decode.prep": _ph(0.002)},
              "dispatches": {"decode": 1, "prefill": 3}}),
      (9.0, {"phases": {"decode.prep": _ph(1.0)},  # before the window
             "dispatches": {"decode": 1}})],
     3.0),
    ("decode_prep_ms", [(11.0, {"dispatches": {"decode": 2}})], None),
    # the loop's host time per step, its wait left out
    ("loop_host_ms",
     [(11.0, {"loop": {"loop.wait": _ph(5.0), "loop.intake": _ph(0.003),
                       "loop.retired": _ph(0.001)}}),
      (12.0, {"loop": {"loop.intake": _ph(0.002)}}),
      (12.5, {"phases": {}})],  # no loop before it: not a step of the mean
     3.0),
    ("loop_host_ms", [(11.0, {"dispatches": {"decode": 1}})], None),
]


@pytest.mark.parametrize("name,records,want", READS)
def test_metric_readers_on_hand_made_records(name, records, want):
    from portbench.core import reader

    got = reader(name)(_run(records))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
