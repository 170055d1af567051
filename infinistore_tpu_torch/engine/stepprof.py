"""Per-step engine/device attribution: the ``StepProfiler``.

Counterpart of the reference's ``engine/stepprof.py``: the same records,
metric families and hooks.  Only its JAX parts change: a "compile" is a
CUDA-graph capture of a decode step (``note_capture``, called by the
engine with the capture's seconds) and a "retrace" a capture counted per
graph key; device memory comes from ``torch.cuda.memory_stats`` (on the
CPU, the bytes of the tensors the engine holds); the stall probe waits on
a CUDA event recorded behind the step's work; ``device_trace`` wraps
``torch.profiler``.

The serving metrics say how the fleet is doing and the request ledger
says where one request's latency went — but the ENGINE STEP LOOP and the
device under it were a black box: no dispatch counts, no compile/retrace
visibility, no host-blocked vs device-busy split, no device-memory
watermarks.  This module makes the step loop emit ONE structured record
per scheduler step:

* **step kind and batch composition** — prefill chunks advanced, decode
  sequences, speculative rounds, pending depth;
* **dispatch counts** — step units launched (decode chunks, prefill
  chunk forwards).  Counted per step unit, not per CUDA kernel;
* **host-stall vs device time** — on SAMPLED steps (1 in
  ``ISTPU_STEPPROF_SAMPLE``, default 16) the profiler times a wait on
  a CUDA event recorded after the step body:
  the measured wait is device work the host did NOT overlap.  High
  stall share ⇒ device-bound; ~0 stall with long steps ⇒ the host loop
  (dispatch overhead, Python) is the bottleneck — read this before
  blaming a kernel.  Sampling keeps the ≤5%
  instrumentation-overhead guard passing: a per-step block would
  serialize the async dispatch pipeline the engine exists to keep full;
* **compile/retrace events** — every CUDA-graph capture of a decode
  step counts as one compile (with its seconds) and as one retrace of
  its graph key (``note_capture``; first capture included);
* **device memory watermarks** — ``torch.cuda.memory_stats()`` on the
  card, the bytes of the engine's own tensors on the CPU; sampled with
  the stall probe;
* **speculation attribution** — per-step deltas of the speculator's
  rounds/proposed/accepted counters next to the dispatch counts, so
  "0.53x despite 0.938 acceptance" reads as tokens-per-dispatch, not a
  mystery;
* **store-hop stages** — when a step moved pages, the transfer's
  ``last_push_stages`` / ``last_load_stages`` breakdown rides along
  (best-effort: pushes commit on the streamer thread, so a stage dict
  may land one step late);
* **host phases** — ``phase(name)`` around the host work of the step
  (``sched.*``, ``prefill.*``, ``decode.*``): wall and engine-thread CPU
  seconds per phase under ``phases``; the engine loop's phases between
  steps (``loop.*``) land in the NEXT step's record as ``loop``.  Each
  phase is also a span of the active request trace and, while
  ``torch.profiler`` records, a ``record_function`` range in the device
  trace; ``t0_ns``/``t1_ns`` (the step's and each phase's) are on the
  profiler's clock (``time.time_ns``), so records join the device
  trace's intervals;
* **work** — what the step's dispatches computed, counted where they are
  launched (``note_work``): ``prefill_tokens_graph`` /
  ``prefill_tokens_eager`` (uncached prompt positions by route, pads
  excluded), ``decode_rows`` (real rows x steps) and
  ``decode_ctx_tokens`` (the context each of those row-steps attends
  over).

Records live in a bounded ring (``ISTPU_STEPPROF_RING``, default 256),
exported at the serving front-end's ``GET /debug/engine`` (``?limit=``),
and feed the ``istpu_engine_*`` metric families on the owning server's
registry.  Sampled steps also add a ``device.drain`` span on a synthetic
**device track** to the engine-step trace AND to every participating
request's own ``http.request`` trace, so one stitched Perfetto file runs
HTTP handler → scheduler → engine.step → kv store hop → device dispatch
under one trace id.

Hooks (``note_dispatch`` / ``note_tokens`` / ``note_work`` /
``count_trace`` / ``phase``) follow the tracing module's contract: with no
active step record they cost one contextvar read and nothing else.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils import metrics as _metrics
from ..utils import tracing

# -- knobs ------------------------------------------------------------------

STEPPROF_SAMPLE_DEFAULT = 16   # 1-in-N steps pay the block+mem probe
STEPPROF_RING_DEFAULT = 256    # records kept for /debug/engine

# step ids a single request accumulates for the ledger join (the newest
# window is what an investigation needs; a 100k-token request must not
# grow its ledger record without bound)
MAX_STEP_IDS = 64


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# -- process-wide trace/compile accounting ----------------------------------

_ACTIVE: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "istpu_stepprof", default=None
)

_TRACE_LOCK = threading.Lock()
_TRACES: Dict[str, int] = {}     # fn name -> traces (first compile included)
_TRACES_TOTAL = 0
_COMPILES = 0                     # CUDA-graph captures (note_capture)
_COMPILE_S = 0.0


def count_trace(name: str) -> None:
    """Count one trace-cache miss of ``name`` (a CUDA-graph capture of
    that graph key; ``note_capture`` calls it).  Also lands on the active
    step record, so a mid-serving capture shows up on the step that paid
    for it."""
    global _TRACES_TOTAL
    with _TRACE_LOCK:
        _TRACES[name] = _TRACES.get(name, 0) + 1
        _TRACES_TOTAL += 1
    rec = _ACTIVE.get()
    if rec is not None:
        r = rec["retraces"]
        r[name] = r.get(name, 0) + 1


def note_capture(name: str, seconds: float) -> None:
    """Count one CUDA-graph capture of graph key ``name`` that took
    ``seconds``: a compile (process-wide count and seconds) and a retrace
    of ``name``."""
    global _COMPILES, _COMPILE_S
    with _TRACE_LOCK:
        _COMPILES += 1
        _COMPILE_S += float(seconds)
    count_trace(name)


def trace_counts() -> Dict[str, int]:
    with _TRACE_LOCK:
        return dict(_TRACES)


def total_traces() -> int:
    """Process-lifetime trace-cache misses across every counted
    function — the cheap monotone series the health plane's
    retrace-regression watchdog samples (deltas over its windows, so
    the process-lifetime baseline cancels out)."""
    with _TRACE_LOCK:
        return _TRACES_TOTAL


# -- step-local hooks (no-ops without an active record) ---------------------

def note_dispatch(kind: str, n: int = 1) -> None:
    """Count ``n`` dispatches of ``kind`` against the active step record
    (a decode chunk, a prefill chunk forward...).  One contextvar read
    when inactive."""
    rec = _ACTIVE.get()
    if rec is not None:
        d = rec["dispatches"]
        d[kind] = d.get(kind, 0) + n


def note_tokens(n: int) -> None:
    """Count ``n`` tokens emitted by the active step's dispatches."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec["tokens"] += n


def note_sync(kind: str, n: int = 1) -> None:
    """Count ``n`` BLOCKING host syncs of ``kind`` against the active
    step record — device→host downloads the step loop actually waited
    on (the decode chunk's token landing, the fused-spec chunk's token
    landing).  Dispatches say how often the host talked to the device;
    syncs say how often it STOPPED for it — the single-sync speculation
    guard asserts exactly one per fused chunk.  One contextvar read
    when inactive."""
    rec = _ACTIVE.get()
    if rec is not None:
        s = rec["syncs"]
        s[kind] = s.get(kind, 0) + n


def note_work(kind: str, n: int) -> None:
    """Count ``n`` units of work ``kind`` (``prefill_tokens_graph``,
    ``prefill_tokens_eager``, ``decode_rows``, ``decode_ctx_tokens``)
    launched by the active step.  One contextvar read when inactive."""
    rec = _ACTIVE.get()
    if rec is not None:
        w = rec["work"]
        w[kind] = w.get(kind, 0) + n


# -- phases: host time inside a step and in the engine loop between steps --

_PROFILING: Optional[Callable[[], bool]] = None
_RECORD_FUNCTION = None


def _profiling() -> bool:
    """Whether ``torch.profiler`` (Kineto) records on this thread."""
    global _PROFILING, _RECORD_FUNCTION
    if _PROFILING is None:
        import torch
        from torch.profiler import record_function

        _RECORD_FUNCTION = record_function
        _PROFILING = torch._C._autograd._profiler_enabled
    return _PROFILING()


def _phase_table(raw: Dict[str, list], off: int) -> Dict[str, dict]:
    """A step's (or the loop's) raw phase sums -> the record's form:
    entries, wall and CPU seconds, first start and last end on the
    profiler's clock."""
    return {name: {"n": n, "wall_s": round(w * 1e-9, 6),
                   "cpu_s": round(c * 1e-9, 6),
                   "t0_ns": t0 + off, "t1_ns": t1 + off}
            for name, (n, w, c, t0, t1) in raw.items()}


class _Bare:
    """What ``phase`` returns where it records nothing."""

    __slots__ = ()
    wall_s = 0.0

    def __enter__(self) -> "_Bare":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_BARE = _Bare()


def phase(name: str, prof: Optional["StepProfiler"] = None,
          timed: bool = False, trace_id: Optional[str] = None, **args):
    """``with phase(name, **args):`` times a host phase once
    (``perf_counter_ns`` and ``thread_time_ns`` on entry and exit) and
    feeds every sink from that one pair of readings:

    * the active step record: ``rec["phases"][name]`` sums entries, wall
      and engine-thread CPU seconds; with no active record but ``prof`` (a
      ``StepProfiler``) given, the phase piles into that profiler's loop
      sums, which the NEXT step's record takes as ``rec["loop"]``;
    * the active request trace (``tracing.add_span_abs``), or the trace
      named by ``trace_id``: the phase is a span there, ``args`` its
      arguments;
    * while ``torch.profiler`` records, a ``record_function(name)`` range
      inside it: the phase shows in the Kineto trace as a CPU range, on
      the device operations' clock.

    The wall readings hold the profiler's range and the lookup of
    ``trace_id``'s trace, so the time those take (they may wait for the
    interpreter lock) counts in the phase rather than between phases.
    CPU seconds are as fine as the host's thread clock, which steps by
    10 ms on some hosts: read them as sums over many entries.

    ``timed=True`` phases stand in for a timer and a span that serving
    keeps with the step profiler off: they read ``perf_counter_ns`` and
    add the span even without a record.  Every other phase with no
    record (and no enabled ``prof``) costs one contextvar read.  The
    returned object's ``wall_s`` holds the phase's wall seconds after
    exit (0.0 when it was not timed)."""
    rec = _ACTIVE.get()
    if rec is not None:
        return _Phase(name, rec["phases"], trace_id, args)
    if prof is not None and prof.enabled:
        return _Phase(name, prof._loop, trace_id, args)
    if timed:
        return _Phase(name, None, trace_id, args)
    return _BARE


class _Phase:
    """One timed phase (see ``phase``); ``into`` is the raw sums it adds
    to, None for a timed phase outside any record."""

    __slots__ = ("name", "into", "trace_id", "args", "wall_s", "_t0",
                 "_c0", "_rf", "_tr")

    def __init__(self, name: str, into: Optional[Dict[str, list]],
                 trace_id: Optional[str], args: Dict[str, Any]):
        self.name = name
        self.into = into
        self.trace_id = trace_id
        self.args = args
        self.wall_s = 0.0

    def __enter__(self) -> "_Phase":
        self._c0 = time.thread_time_ns() if self.into is not None else 0
        self._t0 = time.perf_counter_ns()
        self._rf = None
        if _profiling():
            self._rf = _RECORD_FUNCTION(self.name)
            self._rf.__enter__()
        self._tr = (tracing.TRACER.live(self.trace_id)
                    if self.trace_id else None)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        t0 = self._t0
        into = self.into
        if into is not None:
            cpu = time.thread_time_ns() - self._c0
            e = into.get(self.name)
            if e is None:
                into[self.name] = [1, t1 - t0, cpu, t0, t1]
            else:
                e[0] += 1
                e[1] += t1 - t0
                e[2] += cpu
                e[4] = t1
        self.wall_s = (t1 - t0) * 1e-9
        if self._tr is not None:
            self._tr.add(self.name, t0 * 1e-9, t1 * 1e-9, self.args)
        elif not self.trace_id:
            tracing.add_span_abs(self.name, t0 * 1e-9, t1 * 1e-9,
                                 **self.args)
        return False


def current_step() -> Optional[int]:
    """The active step record's id (None outside a profiled step) — the
    scheduler stamps it onto a request at RETIREMENT, before the ledger
    record snapshots ``step_ids`` (the end-of-step attribution pass runs
    too late for a request that exits mid-step)."""
    rec = _ACTIVE.get()
    return rec["step"] if rec is not None else None


# -- device memory ----------------------------------------------------------

def default_mem_reader(engine=None) -> Optional[Dict[str, int]]:
    """Device memory watermarks: ``torch.cuda.memory_stats()`` of the
    engine's card (of the current card without an engine, once CUDA is
    initialised), else, for an engine on the CPU, the bytes of the
    tensors it holds (``live``) with ``peak`` tracked by the caller.
    Returns None when nothing is measurable."""
    try:
        import torch

        dev = getattr(engine, "device", None)
        if (dev is not None and dev.type == "cuda") or (
                dev is None and torch.cuda.is_initialized()):
            stats = torch.cuda.memory_stats(dev)
            live = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", live))
            out = {"live_bytes": live, "peak_bytes": peak}
            limit = int(torch.cuda.get_device_properties(
                dev if dev is not None else torch.cuda.current_device()
            ).total_memory)
            if limit:
                out["limit_bytes"] = limit
            return out
        if engine is None:
            return None
        live = int(engine.held_bytes())
        return {"live_bytes": live, "peak_bytes": live, "cpu_fallback": 1}
    except Exception:  # noqa: BLE001 — watermarks are best-effort
        return None


def default_block(x: Any) -> None:
    """Wait until the device work queued so far on ``x``'s card is done:
    a CUDA event recorded on the current stream (the engine joins its
    decode stream into it) and waited on.  A CPU tensor has nothing in
    flight."""
    import torch

    if isinstance(x, torch.Tensor) and x.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        ev.synchronize()


# -- the profiler -----------------------------------------------------------

class StepProfiler:
    """One structured record per engine step; see the module docstring.

    ``metrics``: the owning server's registry (defaults to the process
    registry for library/bench use).  ``sentinel``: a no-arg callable
    returning the device tensor the sampled stall probe blocks on
    (typically ``lambda: engine.cache``).  ``clock`` / ``block`` /
    ``mem_reader`` / ``sample`` are injectable so the record shape and
    sampling math are unit-testable without a device or a wall clock.
    """

    def __init__(self, metrics: Optional[_metrics.MetricsRegistry] = None,
                 sentinel: Optional[Callable[[], Any]] = None,
                 sample: Optional[int] = None,
                 ring: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 block: Optional[Callable[[Any], None]] = None,
                 mem_reader: Optional[Callable[[], Optional[dict]]] = None):
        self.enabled = os.environ.get("ISTPU_STEPPROF", "1") != "0"
        self.sample = max(1, sample if sample is not None else _env_int(
            "ISTPU_STEPPROF_SAMPLE", STEPPROF_SAMPLE_DEFAULT))
        cap = max(1, ring if ring is not None else _env_int(
            "ISTPU_STEPPROF_RING", STEPPROF_RING_DEFAULT))
        self._ring: "deque" = deque(maxlen=cap)
        self._lock = threading.Lock()
        # id of the step currently executing (None between steps): a
        # ledger row written MID-step (requests retire inside the step)
        # may name this id before the full record ring-appends at step
        # end — /debug/engine exports it as an in_progress stub so the
        # /debug/requests join can never dangle
        self._current_step: Optional[int] = None
        self._clock = clock
        self._block = block if block is not None else default_block
        self._mem = mem_reader if mem_reader is not None else \
            default_mem_reader
        self._sentinel = sentinel
        # the engine loop's phases since the last step started (raw sums,
        # ``phase(..., prof=self)``): the next step's record takes them
        self._loop: Dict[str, list] = {}
        self.steps = 0
        # lifetime aggregates behind summary()/the metric callbacks
        self._by_kind: Dict[str, int] = {}
        self._dispatch_totals: Dict[str, int] = {}
        self._sync_totals: Dict[str, int] = {}
        # lifetime speculation deltas (summed from per-step ``spec``
        # blocks): accepted tokens PER spec_round DISPATCH is the one
        # number that explains a sub-1x spec speedup at high acceptance
        self._spec_totals = {"rounds": 0, "proposed": 0, "accepted": 0}
        self.tokens = 0
        self._wall_s = 0.0
        self._sampled_wall_s = 0.0
        self._stall_s = 0.0
        self._sampled = 0
        self._mem_last: Optional[dict] = None
        self._peak_live = 0  # running peak for the CPU fallback
        # trace/compile baselines: the summary reports deltas since THIS
        # profiler was built, not process-lifetime noise from warmup
        self._traces0 = dict(_TRACES)
        self._compiles0, self._compile_s0 = _COMPILES, _COMPILE_S
        self.metrics = metrics if metrics is not None else \
            _metrics.default_registry()
        self._register_metrics()

    # -- metrics --

    def _register_metrics(self) -> None:
        reg = self.metrics
        self._h_step = reg.histogram(
            "istpu_engine_step_seconds",
            "One scheduler step, by step kind; phase=wall is the step's "
            "wall time (every step), phase=stall the sampled end-of-step "
            "device drain (see istpu_engine_host_stall_seconds)",
            labelnames=("kind", "phase"),
        )
        self._c_dispatch = reg.counter(
            "istpu_engine_dispatches_total",
            "Compiled step programs launched, by kind (decode scan "
            "chunk, prefill chunk forward, verify/draft forward, fused "
            "speculation round)",
            labelnames=("kind",),
        )
        self._c_sync = reg.counter(
            "istpu_engine_syncs_total",
            "Blocking device->host downloads the step loop waited on, "
            "by kind (decode_tokens: a decode chunk's token landing; "
            "spec_tokens: a fused-spec chunk's token landing) — the "
            "single-sync speculation budget is one per fused chunk",
            labelnames=("kind",),
        )
        self._c_retrace = reg.counter(
            "istpu_engine_retraces_total",
            "CUDA-graph captures per decode graph key (first capture "
            "included) — a climbing series during steady serving means "
            "shape churn (new batch or table-width buckets) is eating "
            "steps",
            labelnames=("fn",),
        )
        self._h_stall = reg.histogram(
            "istpu_engine_host_stall_seconds",
            "Sampled end-of-step device-drain wait: device work "
            "the host loop did not overlap (high = device-bound, ~0 = "
            "host/dispatch-bound)",
        )
        self._g_mem = reg.gauge(
            "istpu_engine_device_mem_bytes",
            "Device memory watermarks from torch.cuda.memory_stats() "
            "(the engine's tensor bytes on CPU), sampled with the stall "
            "probe",
            labelnames=("kind",),
        )
        self._c_compiles = reg.counter(
            "istpu_engine_compiles_total",
            "CUDA-graph captures of decode steps, process-wide",
            fn=lambda: _COMPILES,
        )

    # -- recording --

    @staticmethod
    def _spec_counts(scheduler) -> Optional[tuple]:
        spec = getattr(scheduler, "spec", None) if scheduler else None
        if spec is None:
            return None
        return (int(spec.rounds), int(spec.proposed), int(spec.accepted))

    @staticmethod
    def _stage_ids(scheduler) -> tuple:
        transfer = getattr(getattr(scheduler, "engine", None), "transfer",
                           None) if scheduler else None
        if transfer is None:
            return None, None, None
        return (transfer,
                id(getattr(transfer, "last_push_stages", None)),
                id(getattr(transfer, "last_load_stages", None)))

    @contextlib.contextmanager
    def step(self, scheduler=None, kind_hint: Optional[str] = None):
        """Profile one engine step.  Yields the (mutable) record dict;
        the finished record is ring-appended and metric-fed on exit.
        Usable without a scheduler (``kind_hint`` labels the step) —
        the bench legs and perf smoke wrap raw engine calls this way."""
        if not self.enabled:
            yield None
            return
        with self._lock:
            self.steps += 1
            step_id = self.steps
            self._current_step = step_id
        sampled = step_id % self.sample == 0
        rec: Dict[str, Any] = {
            "step": step_id,
            "t_wall": round(time.time(), 3),
            "trace_id": tracing.current_trace_id(),
            "dispatches": {},
            "tokens": 0,
            "syncs": {},
            "retraces": {},
            "sampled": sampled,
            "phases": {},
            "work": {},
        }
        if scheduler is not None:
            rec["batch"] = {
                "active": len(getattr(scheduler, "active", ())),
                "prefilling": len(getattr(scheduler, "_prefilling", ())),
                "pending": len(getattr(scheduler, "pending", ())),
            }
        spec0 = self._spec_counts(scheduler)
        transfer, push0, load0 = self._stage_ids(scheduler)
        compiles0, compile_s0 = _COMPILES, _COMPILE_S
        loop, self._loop = self._loop, {}
        rf = None
        if _profiling():
            rf = _RECORD_FUNCTION(f"engine.step#{step_id}")
            rf.__enter__()
        p_ns = time.perf_counter_ns()
        # the offset from ``perf_counter_ns`` to the clock the profiler's
        # events use (``time.time_ns``: Kineto stamps CPU ranges on
        # CLOCK_REALTIME), taken anew each step so a step of the wall
        # clock is picked up
        rec["t0_ns"] = w_ns = time.time_ns()
        off = w_ns - p_ns
        if loop:
            rec["loop"] = _phase_table(loop, off)
        token = _ACTIVE.set(rec)
        t0 = self._clock()
        try:
            yield rec
        finally:
            t1 = self._clock()
            rec["t1_ns"] = time.perf_counter_ns() + off
            if rf is not None:
                rf.__exit__(None, None, None)
            _ACTIVE.reset(token)
            rec["phases"] = _phase_table(rec["phases"], off)
            self._finish(rec, scheduler, kind_hint, t0, t1, sampled,
                         spec0, transfer, push0, load0,
                         compiles0, compile_s0)

    def _finish(self, rec, scheduler, kind_hint, t0, t1, sampled,
                spec0, transfer, push0, load0,
                compiles0, compile_s0) -> None:
        dur = max(0.0, t1 - t0)
        rec["dur_s"] = round(dur, 6)
        rec["kind"] = kind_hint or self._classify(rec["dispatches"])
        # sampled probe: time the device drain, then read the watermarks
        # (reading them BEFORE the block would race in-flight dispatches)
        if sampled:
            stall = 0.0
            sentinel = self._sentinel
            target = None
            if sentinel is not None:
                target = sentinel()
            elif scheduler is not None:
                target = getattr(getattr(scheduler, "engine", None),
                                 "cache", None)
            if target is not None:
                tb = self._clock()
                try:
                    self._block(target)
                except Exception:  # noqa: BLE001 — probe must not fault steps
                    pass
                stall = max(0.0, self._clock() - tb)
            rec["host_stall_s"] = round(stall, 6)
            mem = self._mem()
            if mem is not None:
                if mem.get("cpu_fallback"):
                    self._peak_live = max(self._peak_live,
                                          mem["live_bytes"])
                    mem["peak_bytes"] = self._peak_live
                rec["mem"] = mem
        # speculation attribution: per-step deltas of the speculator's
        # counters next to the dispatch counts — accepted tokens PER
        # DISPATCH is the number that explains a sub-1x speedup at high
        # acceptance
        spec1 = self._spec_counts(scheduler)
        if spec0 is not None and spec1 is not None and spec1 != spec0:
            rec["spec"] = {
                "rounds": spec1[0] - spec0[0],
                "proposed": spec1[1] - spec0[1],
                "accepted": spec1[2] - spec0[2],
            }
            with self._lock:
                for key in self._spec_totals:
                    self._spec_totals[key] += rec["spec"][key]
        # store-hop stages: attach the transfer's per-stage breakdown
        # when it changed under this step (push commits land on the
        # streamer thread, so attribution is best-effort by design)
        if transfer is not None:
            store: Dict[str, Any] = {}
            push = getattr(transfer, "last_push_stages", None)
            if push and id(push) != push0:
                store["push"] = dict(push)
            load = getattr(transfer, "last_load_stages", None)
            if load and id(load) != load0:
                store["load"] = dict(load)
            if store:
                rec["store"] = store
        if _COMPILES != compiles0:
            rec["compiles"] = _COMPILES - compiles0
            rec["compile_s"] = round(_COMPILE_S - compile_s0, 6)
        # lifetime aggregates + metric families
        kind = rec["kind"]
        with self._lock:
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            for k, n in rec["dispatches"].items():
                self._dispatch_totals[k] = \
                    self._dispatch_totals.get(k, 0) + n
            for k, n in rec["syncs"].items():
                self._sync_totals[k] = self._sync_totals.get(k, 0) + n
            self.tokens += rec["tokens"]
            self._wall_s += dur
            if sampled:
                self._sampled += 1
                self._sampled_wall_s += dur
                self._stall_s += rec.get("host_stall_s", 0.0)
                if rec.get("mem"):
                    self._mem_last = rec["mem"]
            self._ring.append(rec)
            if self._current_step == rec["step"]:
                self._current_step = None
        self._h_step.labels(kind, "wall").observe(dur)
        for k, n in rec["dispatches"].items():
            self._c_dispatch.labels(k).inc(n)
        for k, n in rec["syncs"].items():
            self._c_sync.labels(k).inc(n)
        for fname, n in rec["retraces"].items():
            self._c_retrace.labels(fname).inc(n)
        if sampled:
            stall = rec.get("host_stall_s", 0.0)
            self._h_step.labels(kind, "stall").observe(stall)
            self._h_stall.observe(stall)
            mem = rec.get("mem")
            if mem:
                self._g_mem.labels("live").set(mem["live_bytes"])
                self._g_mem.labels("peak").set(mem["peak_bytes"])
        # the device sub-track: the sampled drain as a span on a
        # synthetic "device" thread of the ACTIVE trace (the engine.step
        # trace in serving; a bench.* trace in the legs) — the scheduler
        # mirrors it into each participating request's own trace
        if sampled and rec.get("host_stall_s"):
            tracing.add_span_abs(
                "device.drain", t1, t1 + rec["host_stall_s"],
                tid="device", step=rec["step"],
            )
        rec["t0"], rec["t1"] = t0, t1  # for the scheduler's span mirror

    @staticmethod
    def _classify(dispatches: Dict[str, int]) -> str:
        spec = any(k.startswith(("spec", "draft", "verify"))
                   for k in dispatches)
        prefill = "prefill" in dispatches
        decode = "decode" in dispatches
        if spec:
            return "spec" if not (prefill or decode) else "mixed"
        if prefill and decode:
            return "mixed"
        if prefill:
            return "prefill"
        if decode:
            return "decode"
        return "idle"

    # -- cheap probe reads (the health sampler polls these every tick;
    # summary() builds dicts and merges global trace state, too much for
    # a 1 Hz background thread that only needs three numbers) --

    def stall_totals(self) -> tuple:
        """``(host_stall_s, sampled_wall_s)`` lifetime totals — windowed
        deltas of the pair give the health plane an INSTANTANEOUS
        host-stall fraction (``summary()['host_stall_frac']`` is the
        lifetime aggregate, too damped to watchdog a trend)."""
        with self._lock:
            return self._stall_s, self._sampled_wall_s

    def mem_last(self) -> Optional[Dict[str, int]]:
        """The most recent sampled device-memory watermark dict."""
        with self._lock:
            return dict(self._mem_last) if self._mem_last else None

    # -- export --

    def summary(self) -> Dict[str, Any]:
        """Lifetime aggregates: the ``/debug/engine`` header and the
        bench-JSON profiler block.  ``host_stall_frac`` is the sampled
        device-drain share of sampled step wall time — the one number
        that says device-bound vs host-bound; ``retraces_per_100_steps``
        the steady-state retrace pressure (both trend in
        scripts/bench_history.py)."""
        with self._lock:
            steps = self.steps
            by_kind = dict(self._by_kind)
            dispatches = dict(self._dispatch_totals)
            syncs = dict(self._sync_totals)
            spec_tot = dict(self._spec_totals)
            tokens = self.tokens
            wall = self._wall_s
            s_wall, stall, sampled = (self._sampled_wall_s, self._stall_s,
                                      self._sampled)
            mem = dict(self._mem_last) if self._mem_last else None
        with _TRACE_LOCK:
            retraces = {
                k: v - self._traces0.get(k, 0) for k, v in _TRACES.items()
                if v - self._traces0.get(k, 0) > 0
            }
            compiles = _COMPILES - self._compiles0
            compile_s = _COMPILE_S - self._compile_s0
        n_retr = sum(retraces.values())
        dispatch_total = sum(dispatches.values())
        out = {
            "steps": steps,
            "by_kind": by_kind,
            "dispatches": dispatches,
            "dispatch_total": dispatch_total,
            "syncs": syncs,
            "syncs_total": sum(syncs.values()),
            # dispatch economy: compiled programs launched per decoded
            # token — THE number the single-sync speculation work moves
            # (directions in scripts/bench_history.py: down is good)
            "dispatches_per_token": round(dispatch_total / tokens, 4)
            if tokens else 0.0,
            "tokens": tokens,
            "wall_s": round(wall, 4),
            "sampled_steps": sampled,
            "host_stall_s": round(stall, 4),
            "host_stall_frac": round(stall / s_wall, 4) if s_wall else 0.0,
            "retraces": retraces,
            "retraces_total": n_retr,
            "retraces_per_100_steps": round(100.0 * n_retr / steps, 3)
            if steps else 0.0,
            "compiles": compiles,
            "compile_s": round(compile_s, 4),
            "mem": mem,
        }
        # speculation economy: accepted tokens per fused dispatch, the
        # read that explained r4's "0.53x at 0.938 acceptance" (up is
        # good; absent when no spec step ever ran)
        n_spec_disp = dispatches.get("spec_round", 0)
        if n_spec_disp and spec_tot["proposed"]:
            out["spec_accept_per_dispatch"] = round(
                spec_tot["accepted"] / n_spec_disp, 3
            )
        return out

    def tail(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            recs = [
                {k: v for k, v in r.items() if k not in ("t0", "t1")}
                for r in self._ring
            ]
        if limit is not None and limit >= 0:
            recs = recs[len(recs) - min(limit, len(recs)):]
        return recs

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /debug/engine`` payload."""
        if not self.enabled:
            return {"enabled": False}
        # current BEFORE tail: a step completing in between then shows in
        # the ring snapshot, so a step id a reader learned earlier (from
        # /debug/requests) always resolves one way or the other
        with self._lock:
            current = self._current_step
        recs = self.tail(limit)
        if current is not None and not any(
            r["step"] == current for r in recs
        ):
            # the step EXECUTING right now: a ledger row may already name
            # it (requests retire mid-step), so the join must resolve —
            # the full record replaces this stub when the step ends
            recs.append({"step": current, "in_progress": True})
        return {
            "enabled": True,
            "sample": self.sample,
            "ring": self._ring.maxlen,
            "summary": self.summary(),
            "returned": len(recs),
            "records": recs,
        }


# -- torch.profiler capture, folded into the plane ------------------------

@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture device activity for the enclosed block.

    With ``log_dir``, a ``torch.profiler`` capture (CPU and, when a card
    is present, CUDA activity) written as a Chrome trace to
    ``log_dir/trace.json``; either way a ``device_trace`` span lands in
    the active istpu trace, so a capture shows up in the same Perfetto
    export as the step records.  ``log_dir=None`` keeps just the span."""
    prof = None
    if log_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with tracing.span("device_trace", log_dir=log_dir or ""):
            yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
