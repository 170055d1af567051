"""Continuous batching on top of the engine's graph-captured decode.

Counterpart of the reference's ``engine/scheduler.py``.  Requests are
admitted and retired only at decode-chunk boundaries, and every in-flight
request decodes in lockstep through ``InferenceEngine.decode_batch``.  Chunk
lengths are powers of two capped at ``engine.decode_chunk``; sampling params
ride into the decode step as per-row device vectors, so admission is FIFO
within a priority and mixed-params requests share one lockstep batch while
the engine's CUDA graphs stay bounded by batch buckets x table-width
buckets x 3 sampling variants (vLLM's CUDA-graph batch-size buckets).  A
request whose budget ends mid-chunk decodes to the boundary and is trimmed
at retirement.

Flow per ``step()``:
1. admit pending requests up to ``max_batch``: with an EMPTY batch a whole
   wave prefills at once (one padded forward per length bucket); with a
   batch already decoding, up to ``prefill_concurrency`` newcomers ingest
   via chunked prefill — one prefill chunk EACH per step, interleaved with
   the batch's decode chunks (vLLM chunked-prefill continuous batching), so
   neither a long prompt nor a deep queue of long prompts can stall
   in-flight requests or serialize admission one-completion-at-a-time;
2. advance every in-progress chunked prefill by one chunk;
3. decode one chunk for the active batch;
4. retire requests that hit ``max_new_tokens`` or emitted a stop id
   (checked host-side at the chunk boundary), freeing their KV pages.

``fault_reset()`` is the one place engine-fault cleanup lives: it abandons
partial prefills, releases every page, fails out queued work, and returns
the dropped requests for the serving layer to notify.

Speculative decoding is the fast path for up to ``spec_batch`` requests
(one by default): with a ``draft_engine`` (``engine/speculative.py``) or
``ngram_spec`` (``engine/ngram.py``), an eligible step (greedy or one shared
sample mode, no penalties, seeds, logprobs or adapters) decodes its chunk
through the speculator's round graphs instead of the lockstep decode; a
step that cannot (a draft pool too small, a row too short) falls back to
lockstep decode, and ``state.tokens`` stays the source of truth for both.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import usage as _usage
from ..ledger import MAX_STAMPS
from ..utils import tracing
from ..utils.metrics import MetricsRegistry, default_registry, nearest_rank
from . import stepprof as _stepprof
from .engine import InferenceEngine, PartialPrefill, SequenceState


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class Request:
    req_id: int
    tokens: List[int]
    max_new_tokens: int
    # generation stops at the FIRST occurrence of ANY of these token ids
    # (vLLM stop_token_ids semantics; ``eos_id`` kept as the single-id
    # convenience spelling)
    eos_ids: Optional[List[int]] = None
    sample: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # sampling penalties (vLLM SamplingParams parity): presence/frequency
    # over generated tokens (OpenAI), repetition over prompt+generated
    # (HF).  They reshape the distribution greedy argmaxes too, so they
    # are NOT normalized away for greedy requests.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    # per-request sampling seed (None = the scheduler's stream): seeded
    # requests reproduce their tokens exactly regardless of batchmates
    seed: Optional[int] = None
    # OpenAI logit_bias: token id -> additive bias (densified on device)
    logit_bias: Optional[Dict[int, float]] = None
    # admission priority (vLLM priority scheduling): higher admits first;
    # FIFO within a priority level.  Affects ADMISSION order only — an
    # admitted request is never preempted by a later high-priority one
    # (page backpressure/shedding still applies uniformly).
    priority: int = 0
    # tenant label (usage-attribution plane): the lane label used for
    # metrics, quotas, and the store usage ledger.  None = integer lane
    # (the label is then str(priority)); named tenants ("acme") ride
    # here while ``priority`` keeps carrying admission ORDER.
    tenant: Optional[str] = None
    # conversation id (session-attribution plane): turns of one
    # conversation share this id; the SessionLedger folds them into
    # per-session turn rows and the re-prefill waste accounting.  None =
    # single-shot traffic (no session bookkeeping at all).
    session: Optional[str] = None
    adapter_id: int = 0  # LoRA adapter slot (0 = base model)
    # OpenAI logprobs: collect the chosen token's logprob + the top-k
    # alternatives per generated token (0 = off); records land in lp_data
    # aligned 1:1 with output
    logprobs: int = 0
    # streaming: called at every chunk boundary with the newly visible
    # tokens (already eos/budget-trimmed), then once with ([], True) at
    # retirement — the vLLM streaming-generator analog at chunk granularity
    on_token: Optional[Callable[[List[int], bool], None]] = None
    # filled by the scheduler
    state: Optional[SequenceState] = None
    output: List[int] = field(default_factory=list)
    lp_data: List[tuple] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    _sent: int = 0
    # draft-engine cache state while this request rides the speculative
    # fast path; dropped the moment the batch grows past ``spec_batch``
    _draft_state: Optional[SequenceState] = None
    # set after a mid-round allocator failure: this request stays on the
    # lockstep path (re-entering speculation would thrash draft prefills)
    _spec_off: bool = False
    # latency accounting (perf_counter stamps): submission, first
    # admission into prefill, first visible token.  queue-wait =
    # t_admit - t_submit; prefill/compute share of TTFT = t_first -
    # t_admit — the split /metrics exports so "TTFT is high" is
    # attributable to admission vs compute
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    # the last prefill chunk returned the request's state: the ledger
    # splits t_first - t_admit at it into prefill and the hold until
    # the first token shows (a decode chunk boundary)
    t_prefilled: float = 0.0
    # retirement stamp + the ledger's waterfall inputs: accumulated
    # on_token delivery time (slow consumers show up as "stream", not
    # "decode") and per-chunk token-delivery stamps (t_rel, cum_tokens)
    t_done: float = 0.0
    t_stream_s: float = 0.0
    stamps: List[tuple] = field(default_factory=list)
    # handler-thread staging stamp (perf_counter, taken by serve.py when
    # the body was parsed and queued for the engine loop): admission_wait
    # = t_submit - t_stage, the pre-scheduler share of client TTFT the
    # stage ledger attributes explicitly.  0.0 = direct library callers.
    t_stage: float = 0.0
    # the trace id the submitting HTTP handler had bound (serve.py
    # captures it on the handler thread) — joins this request's ledger
    # record and log lines to its http.request trace
    trace_id: Optional[str] = None
    # engine steps this request participated in (newest MAX_STEP_IDS
    # kept) — the ledger's join key against the step profiler's
    # /debug/engine records
    step_ids: List[int] = field(default_factory=list)


class Scheduler:
    # logprob requests all collect this many alternatives on device (ONE
    # top-k shape per decode graph; rows slice down to what they asked for
    # host-side) — also the admission cap for top_logprobs
    LOGPROBS_K = 8

    def __init__(self, engine: InferenceEngine, max_batch: int = 8,
                 rng: Optional[torch.Generator] = None,
                 draft_engine: Optional[InferenceEngine] = None,
                 spec_k: int = 4, prefill_concurrency: int = 4,
                 spec_batch: int = 1,
                 ngram_spec: bool = False, spec_g: int = 2,
                 metrics: Optional[MetricsRegistry] = None,
                 ledger=None, session_ledger=None,
                 slo_ttft_s: Optional[float] = None,
                 slo_tpot_s: Optional[float] = None,
                 stepprof=None, admission=None):
        self.engine = engine
        # SLO-aware admission control (admission.py):
        # when attached, submit() sheds/throttles over-budget or
        # shed-lane work with AdmissionShed (429 + Retry-After at the
        # serving layer), and _step_inner caps prefill chunk tokens per
        # step in degraded mode (queued work always drains — see the
        # note in _admit).  None (the library default) = every
        # submission admitted, zero overhead.  ServingServer attaches
        # its controller right after construction.
        self.admission = admission
        # per-step engine/device attribution (engine/stepprof.py): when a
        # StepProfiler is attached, every step() emits one structured
        # record, participating requests collect the step ids for the
        # ledger join, and each request's own trace gains engine.step /
        # device-drain spans.  None = zero overhead (library default;
        # ServingServer always attaches one).
        self.stepprof = stepprof
        # per-request lifecycle ledger (ledger.py): every
        # request that leaves the scheduler — retired, cancelled, or
        # dropped by fault_reset — is recorded exactly once
        self.ledger = ledger
        # session-grain attribution (sessions.py): requests
        # carrying a session id additionally fold into their session's
        # turn history at the same exit point.  None = no session plane.
        self.session_ledger = session_ledger
        # SLO targets for the per-lane violation counters; None falls
        # back to env (ISTPU_SLO_TTFT_S / ISTPU_SLO_TPOT_S), which
        # itself defaults to 2 s TTFT / 250 ms TPOT — the bench-serve
        # harness and serve.py flags override per deployment
        self.slo_ttft_s = slo_ttft_s if slo_ttft_s is not None \
            else _env_float("ISTPU_SLO_TTFT_S", 2.0)
        self.slo_tpot_s = slo_tpot_s if slo_tpot_s is not None \
            else _env_float("ISTPU_SLO_TPOT_S", 0.25)
        # latency histograms (log-spaced buckets -> rate()-able and
        # replica-aggregatable, unlike the rolling-window p50 gauges the
        # latency_metrics property still offers as a convenience view).
        # ``metrics``: the owning server's registry (ServingServer passes
        # its own so two servers in one process never mix); library
        # callers default to the process registry.
        self.metrics = metrics if metrics is not None else default_registry()
        self._h_queue_wait = self.metrics.histogram(
            "istpu_serve_queue_wait_seconds",
            "Per-request wait from submit to prefill start",
        )
        self._h_prefill = self.metrics.histogram(
            "istpu_serve_prefill_seconds",
            "Per-request prefill-start to first visible token "
            "(the compute half of TTFT)",
        )
        self._h_decode_step = self.metrics.histogram(
            "istpu_serve_decode_step_seconds",
            "One decode dispatch: the whole batch advancing one chunk",
        )
        # per-lane SLO families: the admission-priority field doubles as
        # the lane label (the multi-tenant QoS axis — ROADMAP item 4),
        # so `histogram_quantile(0.99, rate(istpu_serve_ttft_seconds_
        # bucket{lane="10"}[5m]))` is a per-lane SLO query out of the box
        self._h_ttft = self.metrics.histogram(
            "istpu_serve_ttft_seconds",
            "Per-request time to first token (submit -> first visible "
            "token), labeled by priority lane",
            labelnames=("lane",),
        )
        self._h_tpot = self.metrics.histogram(
            "istpu_serve_tpot_seconds",
            "Per-request mean time per output token after the first, "
            "labeled by priority lane",
            labelnames=("lane",),
        )
        self._c_slo = self.metrics.counter(
            "istpu_serve_slo_violations_total",
            "Finished requests that missed the configured SLO target",
            labelnames=("slo", "lane"),
        )
        self.metrics.gauge(
            "istpu_serve_inflight",
            "Requests holding engine resources (active batch + chunked "
            "prefills)",
            fn=lambda: len(self.active) + len(self._prefilling),
        )
        self.metrics.gauge(
            "istpu_serve_queue_depth",
            "Requests admitted to the scheduler but not yet prefilling",
            fn=lambda: len(self.pending),
        )
        self.max_batch = max_batch
        self.pending: List[Request] = []
        self.active: List[Request] = []
        # chunked-prefill admission: up to ``prefill_concurrency`` newcomers
        # ingest their prompts one chunk each per step, interleaved with the
        # active batch's decode chunks (vLLM chunked-prefill continuous
        # batching)
        self._prefilling: List[Tuple[Request, PartialPrefill]] = []
        self.prefill_concurrency = max(1, prefill_concurrency)
        self._next_id = 0
        # the host generator the engine draws each unseeded call's base
        # seed from
        if rng is None:
            rng = torch.Generator()
            rng.manual_seed(0)
        self._rng = rng
        # set when decode sheds a request for lack of KV pages: admission
        # pauses until something retires, otherwise the shed request would
        # re-admit into the same full allocator and be shed again (livelock)
        self._admission_hold = False
        # device-side penalty state threaded across steps while the batch
        # composition is stable (engine.decode_batch pen_cache)
        self._pen_cache: dict = {}
        # rolling (queue_wait_s, prefill_s) samples of retired requests
        # for the /metrics TTFT split
        from collections import deque

        self._latencies: "deque" = deque(maxlen=512)
        # speculative serving: a draft engine turns on the batch=1 fast
        # path (vLLM's speculative mode analog)
        self.draft = draft_engine
        self.spec = None
        # speculation engages up to this many concurrent requests: 1 (the
        # default) is the latency-bound fast path; >1 runs the rows in
        # LOCKSTEP through the batched fused rounds when every active row
        # is eligible and shares a sample mode
        self.spec_batch = max(1, spec_batch)
        # model-free speculation: proposals from the device-side n-gram
        # matcher (engine/ngram.py), no draft engine, greedy requests only
        self.spec_kind = "ngram" if ngram_spec else "draft"
        if ngram_spec:
            if draft_engine is not None:
                raise ValueError(
                    "ngram_spec and draft_engine are alternative "
                    "speculation modes; pick one"
                )
            from .ngram import NgramSpeculator

            self.spec = NgramSpeculator(engine, k=spec_k, g=spec_g)
        elif draft_engine is not None:
            from .speculative import SpeculativeDecoder

            self.spec = SpeculativeDecoder(engine, draft_engine, k=spec_k)

    def submit(
        self,
        tokens: Sequence[int],
        max_new_tokens: int,
        eos_id: Optional[int] = None,
        eos_ids: Optional[Sequence[int]] = None,
        sample: str = "greedy",
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        repetition_penalty: float = 1.0,
        seed: Optional[int] = None,
        logit_bias: Optional[Dict[int, float]] = None,
        priority: int = 0,
        tenant: Optional[str] = None,
        session: Optional[str] = None,
        adapter_id: int = 0,
        logprobs: int = 0,
        on_token: Optional[Callable[[List[int], bool], None]] = None,
        trace_id: Optional[str] = None,
        t_stage: float = 0.0,
        resume_output: Optional[Sequence[int]] = None,
    ) -> int:
        # boundary validation: a bad request must be rejected HERE, not
        # explode inside a later engine step and fault out every in-flight
        # batchmate (ServingServer._validate rejects earlier with 400s;
        # this guards direct library callers)
        if repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0")
        if not (-10.0 <= presence_penalty <= 10.0
                and -10.0 <= frequency_penalty <= 10.0):
            raise ValueError("presence/frequency penalties out of range")
        if logit_bias is not None:
            import math

            if not all(
                isinstance(t, int) and 0 <= t < self.engine.cfg.vocab_size
                for t in logit_bias
            ):
                raise ValueError("logit_bias keys must be in-vocab token ids")
            if not all(
                isinstance(v, (int, float)) and math.isfinite(v)
                and -1000.0 <= v <= 1000.0
                for v in logit_bias.values()
            ):
                raise ValueError("logit_bias values must be finite and sane")
        if self.admission is not None:
            # the admission verdict BEFORE any state is created: a shed
            # request never holds a queue slot, never charges pages, and
            # (being pre-admission) is never a mid-stream cancellation.
            # Raises AdmissionShed -> the serving layer's 429.
            d = self.admission.check_submit(
                lane=(tenant if tenant else priority),
                tokens=len(tokens) + max_new_tokens,
                priority=priority)
            if not d.admitted:
                from ..admission import AdmissionShed

                raise AdmissionShed(
                    d.reason, d.retry_after_s,
                    ("tenant over token quota; retry later"
                     if d.reason == "quota"
                     else "server shedding load on this lane; retry later"),
                )
        if sample == "greedy":
            # greedy ignores these; normalizing keeps greedy requests in one
            # lockstep batch (and one decode graph) regardless of the
            # stray sampling params clients send alongside temperature 0
            temperature, top_k, top_p = 1.0, 0, 1.0
        stops = list(eos_ids) if eos_ids else []
        if eos_id is not None and eos_id not in stops:
            stops.append(eos_id)
        req = Request(
            req_id=self._next_id, tokens=list(tokens),
            max_new_tokens=max_new_tokens, eos_ids=stops or None,
            sample=sample, temperature=temperature, top_k=top_k,
            top_p=top_p, presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            repetition_penalty=repetition_penalty, seed=seed,
            logit_bias=dict(logit_bias) if logit_bias else None,
            priority=priority, tenant=tenant, session=session,
            adapter_id=adapter_id,
            logprobs=min(max(int(logprobs), 0), self.LOGPROBS_K),
            on_token=on_token, trace_id=trace_id, t_stage=t_stage,
        )
        if resume_output:
            # mid-stream resumption (serve.py restore path; docs/design.md
            # resumption contract): the survivor adopts a died worker's
            # generated-so-far tokens as pre-seeded output.  ``_admit``
            # prefills tokens + output, so the adopted KV pages come back
            # through the normal guarded store probe and decoding
            # continues from the checkpointed position.  ``on_token``
            # re-delivers the pre-seed (``_sent`` starts at 0) — the
            # serving layer's emitted-count watermark suppresses the
            # duplicates.  Capped one short of the budget so at least one
            # real decode step runs and the request retires through the
            # normal done path.
            req.output = [int(t) for t in resume_output][
                :max(0, max_new_tokens - 1)]
        self._next_id += 1
        req.t_submit = time.perf_counter()
        self._enqueue(req)
        return req.req_id

    def _enqueue(self, req: Request, front: bool = False) -> None:
        """Insert into the pending queue by (priority desc, FIFO).
        ``front=True`` re-queues a shed/held request AHEAD of its priority
        peers (it already waited its turn once)."""
        i = len(self.pending)
        while i > 0 and self.pending[i - 1].priority < req.priority:
            i -= 1
        if front:
            while i > 0 and self.pending[i - 1].priority == req.priority:
                i -= 1
        self.pending.insert(i, req)

    def cancel(self, req_id: int) -> bool:
        """Abort a request.  Pending: removed immediately.  Active or
        mid-prefill: retired at the next chunk boundary (pages freed,
        partial output kept).  Returns False for ids that are unknown or
        already finished."""
        for i, req in enumerate(self.pending):
            if req.req_id == req_id:
                req.cancelled = req.done = True
                self.pending.pop(i)
                self._stream(req, done=True)
                self._finish(req, "cancelled")
                return True
        for req, _pp in self._prefilling:
            if req.req_id == req_id and not req.cancelled:
                req.cancelled = True
                return True
        for req in self.active:
            if req.req_id == req_id and not req.cancelled:
                req.cancelled = True
                return True
        return False

    @staticmethod
    def _lane_label(req: Request) -> str:
        """The request's lane/tenant label — the one axis metrics,
        quotas, and the usage ledger share: ``"acme"`` for named
        tenants, ``str(priority)`` for integer lanes."""
        return req.tenant if req.tenant else str(req.priority)

    @staticmethod
    def _visible_len(req: Request) -> int:
        """Tokens of ``req.output`` that will survive retirement trimming
        (stop at the FIRST of any stop id, cap at budget) — the streaming
        horizon."""
        out = req.output
        if req.eos_ids:
            stops = set(req.eos_ids)
            for i, t in enumerate(out):
                if t in stops:
                    return min(i + 1, req.max_new_tokens)
        return min(len(out), req.max_new_tokens)

    def _stream(self, req: Request, done: bool) -> None:
        """Deliver newly visible tokens.  A raising callback must never
        corrupt the scheduler (leak pages, leave a done request active), so
        it is disarmed after the first failure and the request continues as
        a non-streaming one."""
        vis = self._visible_len(req)
        if vis > req._sent and len(req.stamps) < MAX_STAMPS:
            # chunk-boundary delivery stamp for the ledger (t relative
            # to submit, cumulative visible tokens) — stamped whether or
            # not a callback is attached, so /debug/requests shows the
            # token cadence for batch-mode requests too
            req.stamps.append(
                (round(time.perf_counter() - req.t_submit, 6), vis)
            )
        if req.on_token is None:
            return
        t0 = time.perf_counter()
        try:
            if vis > req._sent:
                req.on_token(req.output[req._sent:vis], False)
                req._sent = vis
            if done:
                req.on_token([], True)
        except Exception as e:  # noqa: BLE001 — user callback, not our state
            req.on_token = None
            import logging

            logging.getLogger("infinistore_tpu").warning(
                "on_token callback for request %d raised %r; streaming "
                "disabled for this request", req.req_id, e,
            )
        finally:
            # delivery time is the "stream" slice of the ledger's
            # waterfall: a slow consumer must show up as stream, not
            # inflate the decode share
            req.t_stream_s += time.perf_counter() - t0

    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.active or self._prefilling)

    def _admit(self) -> None:
        # sampling params are per-row device vectors in the decode step
        # (engine._step), so admission is pure FIFO — a greedy request and a
        # top-p request share one lockstep batch
        if not self.pending:
            return
        # NOTE on degraded mode: work already in ``pending`` is never
        # held back by lane here — the queue is priority-sorted, so
        # protected lanes admit first anyway, and freezing shed-lane
        # backlog would only let it age into guaranteed SLO violations
        # that re-ignite the burn the moment it clears (a fire/clear
        # oscillation).  The admission controller acts at the submit
        # boundary (shed new work) and via the per-step prefill token
        # budget (_step_inner); queued work always drains.
        if self.active or self._prefilling:
            # a batch is decoding (or newcomers are already ingesting):
            # admit newcomers via CHUNKED prefill — prefill_start here, one
            # prefill_step each per step() interleaved with the batch's
            # decode chunks.  Up to ``prefill_concurrency`` ingest
            # concurrently so a deep queue of long prompts doesn't
            # serialize admission one-completion-at-a-time while decode
            # slots sit idle.
            T = self.engine.pc.block_tokens
            while (self.pending
                   and len(self._prefilling) < self.prefill_concurrency
                   and (len(self.active) + len(self._prefilling)
                        < self.max_batch)):
                req = self.pending[0]
                need = -(-(len(req.tokens) + len(req.output)) // T)
                if need > self.engine.free_pages:
                    return  # wait for a retirement to free pages
                self.pending.pop(0)
                # queue-wait ends when prefill work BEGINS — stamped
                # BEFORE the call so prefill_start's store prefix
                # lookup/load I/O counts as prefill, matching the wave
                # path's t_wave placement (first admission only; a shed
                # request's re-prefill keeps its original stamps)
                first_admission = not req.t_admit
                if first_admission:
                    req.t_admit = time.perf_counter()
                try:
                    # bound to the REQUEST's own trace: the admission
                    # store hops (kv.lookup_prefix, kv.load_pages) are
                    # this request's cost, not the ambient engine.step's
                    with tracing.bind(req.trace_id), \
                            _usage.bind_account(self._lane_label(req)):
                        pp = self.engine.prefill_start(
                            req.tokens + req.output,
                            adapter_id=req.adapter_id,
                        )
                except MemoryError:
                    if first_admission:
                        req.t_admit = 0.0  # nothing ran; still queued
                    self._enqueue(req, front=True)
                    self._admission_hold = True
                    return
                self._prefilling.append((req, pp))
            return
        admit: List[Request] = []
        while self.pending and len(self.active) + len(admit) < self.max_batch:
            admit.append(self.pending.pop(0))
        # one padded forward per length bucket for the admission wave (falls
        # back to per-sequence prefill when store reuse applies).  The wave
        # is first sized against the allocator host-side (no wasted device
        # forwards), then page exhaustion mid-prefill sheds the newest
        # request and retries; a single unrunnable request with nothing in
        # flight is surfaced (it can never run), otherwise admission holds
        # until the running batch frees pages (backpressure).
        T = self.engine.pc.block_tokens

        def wave_pages(reqs):
            return sum(
                -(-(len(r.tokens) + len(r.output)) // T) for r in reqs
            )

        while len(admit) > 1 and wave_pages(admit) > self.engine.free_pages:
            self._enqueue(admit.pop(), front=True)
        while admit:
            t_wave = time.perf_counter()  # queue-wait ends as the wave runs
            try:
                # prompt + output-so-far: a request shed mid-decode resumes
                # where it left off (its generated tokens re-prefill).  A
                # single-request wave binds that request's trace so its
                # store-hop spans attribute to it; a multi-request wave
                # stays in the ambient engine.step trace (the work is
                # genuinely shared).
                with tracing.bind(
                    admit[0].trace_id if len(admit) == 1 else None
                ), _usage.bind_account(
                    self._lane_label(admit[0]) if len(admit) == 1 else None
                ):
                    states = self.engine.prefill_batch(
                        [r.tokens + r.output for r in admit],
                        adapter_ids=[r.adapter_id for r in admit],
                    )
            except MemoryError:
                if len(admit) > 1:
                    self._enqueue(admit.pop(), front=True)
                    continue
                if not self.active:
                    raise
                for r in reversed(admit):
                    self._enqueue(r, front=True)
                self._admission_hold = True  # retry after a retire frees pages
                return
            t_prefilled = time.perf_counter()
            for req, st in zip(admit, states):
                req.state = st
                if not req.t_admit:
                    # stamped at wave START so the wave's forward counts
                    # as prefill (t_first - t_admit), not queue-wait
                    req.t_admit = t_wave
                if not req.t_prefilled:
                    req.t_prefilled = t_prefilled
                self.active.append(req)
            return

    def _retire(self) -> List[Request]:
        with _stepprof.phase("sched.retire"):
            done_now: List[Request] = []
            still: List[Request] = []
            now = time.perf_counter()
            for req in self.active:
                if not req.t_first and req.output:
                    req.t_first = now
            for req in self.active:
                out = req.output
                hit_eos = bool(req.eos_ids) \
                    and not set(req.eos_ids).isdisjoint(out)
                if req.cancelled or hit_eos or len(out) >= req.max_new_tokens:
                    del out[self._visible_len(req):]
                    del req.lp_data[len(out):]  # aligned 1:1 with output
                    req.done = True
                    done_now.append(req)
                else:
                    still.append(req)
            # every request's token delivery in one pass, one phase: each
            # delivery times itself into its request's stream slice
            with _stepprof.phase("sched.stream"):
                for req in self.active:
                    self._stream(req, done=req.done)
            for req in done_now:
                self._drop_draft(req)
                self._drop_spec_state(req)
                self.engine.release(req.state)
                self.record_latency(req)
                self._finish(req, "cancelled" if req.cancelled else "done")
            self.active = still
            if done_now:
                # pages freed; admission may resume
                self._admission_hold = False
                if not any(self._penalized(r) for r in still):
                    # don't pin the dense [B, V] device penalty state after
                    # the batch that needed it retires (its composition key
                    # can never recur — seq ids are monotonic)
                    self._pen_cache.clear()
            return done_now

    @staticmethod
    def _penalized(req: Request) -> bool:
        return (req.presence_penalty != 0.0 or req.frequency_penalty != 0.0
                or req.repetition_penalty != 1.0 or bool(req.logit_bias))

    # -- speculative fast path (a draft engine or n-gram attached) --

    def _drop_draft(self, req: Request) -> None:
        if req._draft_state is not None:
            self.draft.release(req._draft_state)
            req._draft_state = None

    def _drop_spec_state(self, req: Request) -> None:
        """Forget the speculator's per-request adaptive-R controller (a
        retired seq id never recurs).  No-op for speculators without
        per-request state (n-gram)."""
        forget = getattr(self.spec, "forget", None)
        if forget is not None and req.state is not None:
            forget(req.state.seq_id)

    def _draft_state_for(self, req: Request) -> Optional[SequenceState]:
        """The draft's cache state for ``req``, prefilled on (re-)entry to
        the fast path.  None when the draft allocator can't hold the
        sequence PLUS one round's k+1 appended tokens: without the
        headroom, a pool that exactly fits the prefill would burn a full
        draft prefill every step only to dry up mid-round."""
        if req._draft_state is not None:
            return req._draft_state
        T = self.draft.pc.block_tokens
        need = -(-(len(req.state.tokens) + self.spec.k + 1) // T)
        if need > self.draft.free_pages:
            return None
        try:
            req._draft_state = self.draft.prefill(req.state.tokens)
        except MemoryError:
            return None
        return req._draft_state

    def _spec_step(self, req: Request, chunk: int) -> bool:
        """Decode ``chunk`` tokens for the lone active request through the
        speculative decoder.  Returns False when the fast path couldn't run
        (draft pages unavailable or exhausted mid-round): the caller falls
        back to the lockstep path THIS step; partial speculative progress
        is reconciled from ``state.tokens``."""
        if req._spec_off:
            return False
        # the fast path drives the target through verify, which never
        # reclaims; a fully-windowed target would otherwise grow its pool
        # without bound
        self.engine._reclaim_window_pages(req.state)
        st_d = self._draft_state_for(req)
        if st_d is None:
            return False
        try:
            toks = self.spec.decode(
                req.state, st_d, chunk,
                sample=req.sample, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p, rng=self._rng,
            )
        except MemoryError:
            # an allocator ran dry mid-round (spec.decode left the target
            # decode-ready; if the TARGET is the dry pool that re-verify
            # raised out of here, like the plain batch=1 path).  Reconcile
            # the tokens the completed rounds appended, drop the draft, and
            # run this request on the lockstep path from now on
            req.output = list(req.state.tokens[len(req.tokens):])
            self._drop_draft(req)
            req._spec_off = True
            return False
        req.output.extend(toks)
        _stepprof.note_tokens(len(toks))
        return True

    def _ngram_step_batch(self, reqs: List[Request], chunk: int) -> bool:
        """Model-free speculation step: every active row rides the batched
        n-gram rounds.  Greedy rows only; returns False to fall back to
        lockstep decode when any row is ineligible."""
        sp = self.spec
        if any(r._spec_off or r.sample != "greedy"
               or not sp.eligible(r.state) for r in reqs):
            return False
        for r in reqs:
            self.engine._reclaim_window_pages(r.state)
        try:
            outs = sp.decode_batch([r.state for r in reqs], chunk)
        except MemoryError:
            # the target pool ran dry; states were reconciled after the
            # last completed dispatch, so they are decode-ready: hand these
            # rows to the lockstep path from now on
            for r in reqs:
                r.output = list(r.state.tokens[len(r.tokens):])
                r._spec_off = True
            return False
        for r, toks in zip(reqs, outs):
            r.output.extend(toks)
            _stepprof.note_tokens(len(toks))
        return True

    def _spec_dispatch(self, reqs: List[Request], chunk: int) -> bool:
        with _stepprof.phase("sched.decode_chunk", timed=True,
                             batch=len(reqs), chunk=chunk,
                             spec=self.spec_kind) as ph:
            if self.spec_kind == "ngram":
                ok = self._ngram_step_batch(reqs, chunk)
            else:
                ok = self._spec_step_batch(reqs, chunk)
        if ok:
            self._h_decode_step.observe(ph.wall_s)
        return ok

    def _spec_step_batch(self, reqs: List[Request], chunk: int) -> bool:
        """Decode ``chunk`` tokens for up to ``spec_batch`` requests in
        lockstep through the batched fused rounds.  Returns False when the
        fast path couldn't run this step (a row opted out, too short for
        the fused window, or draft pages unavailable): the caller falls
        back to lockstep decode."""
        if len(reqs) == 1:
            # the single-request path keeps its host-loop fallback for
            # prompts shorter than the fused window
            return self._spec_step(reqs[0], chunk)
        sp = self.spec
        k = sp.k
        # decode_batch has no host-loop fallback, so every graceful-
        # fallback condition the single-row path checks inside decode()
        # is checked HERE
        if not (sp.fuse_rounds and sp.target._has_verify
                and sp.draft._has_verify):
            return False
        if any(r._spec_off or len(r.state.tokens) < k + 2 for r in reqs):
            return False
        for r in reqs:
            self.engine._reclaim_window_pages(r.state)
        # a lockstep step in between advances the target without the
        # draft: those rows' drafts are stale and need a re-prefill.  Check
        # that EVERY needed prefill fits before doing ANY of them
        T = self.draft.pc.block_tokens
        # length must match too: a repeated-token tail can make a SHORTER
        # stale draft compare equal on values alone
        stale = [
            r._draft_state is not None
            and (len(r._draft_state.tokens) != len(r.state.tokens)
                 or r._draft_state.tokens[-(k + 2):]
                 != r.state.tokens[-(k + 2):])
            for r in reqs
        ]
        need = sum(
            -(-(len(r.state.tokens) + k + 1) // T)
            for r, s in zip(reqs, stale)
            if s or r._draft_state is None
        )
        freed = sum(
            len(r._draft_state.block_ids)
            for r, s in zip(reqs, stale) if s
        )
        if need > self.draft.free_pages + freed:
            return False
        st_ds = []
        for r, s in zip(reqs, stale):
            if s:
                self._drop_draft(r)
            st_d = self._draft_state_for(r)
            if st_d is None:
                return False
            st_ds.append(st_d)
        try:
            outs = self.spec.decode_batch(
                [r.state for r in reqs], st_ds, chunk,
                sample=reqs[0].sample,
                temperature=[r.temperature for r in reqs],
                top_k=[r.top_k for r in reqs],
                top_p=[r.top_p for r in reqs],
                rng=self._rng,
            )
        except MemoryError:
            # an allocator ran dry: every row's state is decode-ready (the
            # batched path reconciles after each dispatch and acquires
            # BEFORE the next); run these requests on the lockstep path
            for r in reqs:
                r.output = list(r.state.tokens[len(r.tokens):])
                self._drop_draft(r)
                r._spec_off = True
            return False
        for r, toks in zip(reqs, outs):
            r.output.extend(toks)
            _stepprof.note_tokens(len(toks))
        return True

    def step(self) -> List[Request]:
        """Admit, advance each in-flight chunked prefill by one chunk,
        decode one chunk for the whole batch, retire.  Returns the requests
        that finished this step.

        With a ``stepprof`` attached the whole step runs under one
        profiler record; afterwards every participating request collects
        the step id (ledger join key) and — when it carries a trace id —
        an ``engine.step`` span plus, on sampled steps, the device-drain
        span on the synthetic device track, folded into ITS OWN
        ``http.request`` trace."""
        prof = self.stepprof
        if prof is None or not prof.enabled:
            return self._step_inner()
        with prof.step(self) as rec:
            retired = self._step_inner()
        self._attribute_step(rec, retired)
        return retired

    def _attribute_step(self, rec: Optional[dict],
                        retired: List[Request]) -> None:
        if rec is None:
            return
        sid = rec["step"]
        t0, t1 = rec.get("t0"), rec.get("t1")
        participants = (
            list(self.active)
            + [r for r, _pp in self._prefilling]
            + retired
        )
        for req in participants:
            ids = req.step_ids
            if (not ids or ids[-1] != sid) and len(ids) < _stepprof.MAX_STEP_IDS:
                ids.append(sid)
            if req.trace_id and t0 and t1:
                tracing.add_span_abs_to(
                    req.trace_id, "engine.step", t0, t1,
                    step=sid, kind=rec["kind"],
                )
                stall = rec.get("host_stall_s")
                if stall:
                    tracing.add_span_abs_to(
                        req.trace_id, "device.drain", t1, t1 + stall,
                        tid="device", step=sid,
                    )

    def _step_inner(self) -> List[Request]:
        if not (self._admission_hold and self.active):
            with _stepprof.phase("sched.admit"):
                self._admit()
        # ``sched.book``: the step's own bookkeeping between the phases
        # above and below, so that the top-level phases tile the step
        with _stepprof.phase("sched.book"):
            cancelled_prefill: List[Request] = []
            still: List[Tuple[Request, PartialPrefill]] = []
            # degraded-mode chunked-prefill throttle: while a burn watchdog
            # fires, only this many prefill chunk tokens advance per step
            # (None = no cap) — decode keeps its TPOT for the protected
            # lane, prefill queues.  Cancellations always process (they
            # FREE resources).
            pf_budget = (self.admission.prefill_token_budget()
                         if self.admission is not None else None)
            chunk_cost = self.engine.prefill_chunk or 1
        for req, pp in self._prefilling:
            if req.cancelled:
                with _stepprof.phase("sched.book"):
                    self.engine.abandon_prefill(pp)
                    req.done = True
                    self._stream(req, done=True)
                    self._finish(req, "cancelled")
                    cancelled_prefill.append(req)
                continue
            if pf_budget is not None and pf_budget <= 0:
                still.append((req, pp))  # over budget: hold this step
                continue
            # the phase outermost, so the bindings' own work counts in it
            with _stepprof.phase("sched.prefill_step", timed=True,
                                 trace_id=req.trace_id, req=req.req_id), \
                    tracing.bind(req.trace_id), \
                    _usage.bind_account(self._lane_label(req)):
                st = self.engine.prefill_step(pp)  # ONE chunk per step each
            if pf_budget is not None:
                pf_budget -= chunk_cost
            if st is not None:
                req.state = st
                if not req.t_prefilled:
                    req.t_prefilled = time.perf_counter()
                self.active.append(req)
            else:
                still.append((req, pp))
        self._prefilling = still
        if not self.active:
            return cancelled_prefill
        if any(r.cancelled for r in self.active):
            # retire cancellations before burning a decode chunk on them
            return cancelled_prefill + self._retire()
        with _stepprof.phase("sched.book"):
            # chunk lengths are powers of two capped at decode_chunk; a
            # request whose budget lands mid-chunk decodes to the chunk
            # boundary and _retire trims the overshoot
            shortest = min(r.max_new_tokens - len(r.output)
                           for r in self.active)
            chunk = 1
            while chunk < shortest and chunk < self.engine.decode_chunk:
                chunk *= 2
            chunk = min(chunk, self.engine.decode_chunk)
            spec = False
            if self.spec is not None and len(self.active) > self.spec_batch:
                # batch grew past the speculation window: draft pages back
                # to the pool; lockstep decode already fills the card at
                # depth
                for r in self.active:
                    self._drop_draft(r)
            else:
                spec = (
                    self.spec is not None
                    and all(
                        r.adapter_id == 0       # the draft carries no adapters
                        and r.logprobs == 0     # spec emits no logprobs
                        and not self._penalized(r)   # no penalty math
                        and r.seed is None      # spec has its own stream
                        for r in self.active
                    )
                    # the fused rounds are one graph per key: every row
                    # must share the sample mode (temps/top-k/top-p ride as
                    # per-row vectors)
                    and len({r.sample for r in self.active}) == 1
                )
            # any row asking for logprobs switches the batch to the
            # collecting graph (fixed top-LOGPROBS_K shape; rows slice to
            # their own k); any row with penalties switches to the
            # count-carrying graph
            want_lp = any(r.logprobs for r in self.active)
            want_pen = any(self._penalized(r) for r in self.active)
        if spec and self._spec_dispatch(self.active, chunk):
            # speculation pays when the card is latency-bound: batch=1 by
            # default; spec_batch > 1 runs a small batch in lockstep
            return cancelled_prefill + self._retire()
        try:
            # the histogram times exactly the decode_batch call, its
            # arguments included; the span carries the batch and chunk
            with _stepprof.phase("sched.decode_chunk", timed=True,
                                 batch=len(self.active), chunk=chunk) as ph:
                outs = self.engine.decode_batch(
                    [r.state for r in self.active], chunk,
                    sample=[r.sample for r in self.active],
                    temperature=[r.temperature for r in self.active],
                    top_k=[r.top_k for r in self.active],
                    top_p=[r.top_p for r in self.active],
                    rng=self._rng,
                    logprobs=self.LOGPROBS_K if want_lp else 0,
                    logprobs_rows=(
                        [bool(r.logprobs) for r in self.active] if want_lp
                        else None
                    ),
                    presence_penalty=[r.presence_penalty
                                      for r in self.active],
                    frequency_penalty=[r.frequency_penalty
                                       for r in self.active],
                    repetition_penalty=(
                        [r.repetition_penalty for r in self.active]
                    ),
                    # generation began after the PROMPT — a shed request's
                    # re-prefilled prior output still counts as generated
                    gen_start=(
                        [len(r.tokens) for r in self.active] if want_pen
                        else None
                    ),
                    seed=[r.seed for r in self.active],
                    logit_bias=[r.logit_bias for r in self.active],
                    pen_cache=self._pen_cache,
                )
        except MemoryError:
            # decode-time page exhaustion: shed the newest request back to
            # pending (its pages free now; its prompt + output re-prefill on
            # re-admission) and let the remaining batch make progress
            if len(self.active) <= 1:
                raise
            victim = self.active.pop()
            self._drop_draft(victim)
            self.engine.release(victim.state)
            victim.state = None
            self._enqueue(victim, front=True)
            self._admission_hold = True
            return cancelled_prefill
        with _stepprof.phase("sched.book"):
            self._h_decode_step.observe(ph.wall_s)
            if want_lp:
                outs, lps = outs
                for req, lp in zip(self.active, lps):
                    if req.logprobs:
                        req.lp_data.extend(lp)
            for req, toks in zip(self.active, outs):
                req.output.extend(toks)
        return cancelled_prefill + self._retire()

    def fault_reset(self) -> List[Request]:
        """Engine-fault cleanup, owned by the scheduler so its invariants
        live in one file: abandon partial prefills, release every target
        and draft page, clear the queues and holds,
        and mark every dropped request done with streaming disarmed.
        Returns the dropped requests — the serving layer tells their
        clients the truth (an error, not a completion)."""
        dropped: List[Request] = []
        for req, pp in self._prefilling:
            try:
                self.engine.abandon_prefill(pp)
            except Exception:  # noqa: BLE001 — already faulting
                pass
            dropped.append(req)
        self._prefilling = []
        dropped.extend(self.active)
        dropped.extend(self.pending)
        self.active = []
        self.pending = []
        for req in dropped:
            try:
                self._drop_draft(req)
            except Exception:  # noqa: BLE001 — already faulting
                req._draft_state = None
            if req.state is not None:
                try:
                    self._drop_spec_state(req)
                    self.engine.release(req.state)
                except Exception:  # noqa: BLE001
                    pass
                req.state = None
            req.done = True
            req.on_token = None
            self._finish(req, "error")
        self._admission_hold = False
        self._pen_cache.clear()
        return dropped

    def _finish(self, req: Request, outcome: str) -> None:
        """The ONE request exit point: stamp retirement, feed the
        per-lane TTFT/TPOT histograms and SLO-violation counters, and
        fold the request into the ledger.  Called exactly once per
        request, from every path a request leaves the scheduler
        (retirement, pending/prefill cancellation, fault_reset)."""
        if not req.t_done:
            req.t_done = time.perf_counter()
        # the step that retired this request must make the LEDGER record:
        # the end-of-step attribution pass runs after ledger.record below
        sid = _stepprof.current_step()
        if (sid is not None
                and (not req.step_ids or req.step_ids[-1] != sid)
                and len(req.step_ids) < _stepprof.MAX_STEP_IDS):
            req.step_ids.append(sid)
        lane = self._lane_label(req)
        n_out = len(req.output)
        if req.t_first:
            ttft = req.t_first - req.t_submit
            self._h_ttft.labels(lane).observe(ttft)
            if self.slo_ttft_s and ttft > self.slo_ttft_s:
                self._c_slo.labels("ttft", lane).inc()
            if n_out > 1 and req.t_done > req.t_first:
                tpot = (req.t_done - req.t_first) / (n_out - 1)
                self._h_tpot.labels(lane).observe(tpot)
                if self.slo_tpot_s and tpot > self.slo_tpot_s:
                    self._c_slo.labels("tpot", lane).inc()
        if self.ledger is not None:
            try:
                self.ledger.record(req, outcome)
            except Exception:  # noqa: BLE001 — observability must not
                pass           # take the engine loop down
        if self.session_ledger is not None:
            try:
                self.session_ledger.record_turn(req, outcome)
            except Exception:  # noqa: BLE001 — same contract as above
                pass

    def record_latency(self, req: Request) -> None:
        """Fold a finished request's stamps into the rolling latency
        window (called at retirement by run()/the serving layer) and into
        the queue-wait / prefill histograms."""
        if req.t_submit and req.t_admit and req.t_first:
            queue_wait = req.t_admit - req.t_submit
            prefill = req.t_first - req.t_admit
            self._latencies.append((queue_wait, prefill))
            self._h_queue_wait.observe(queue_wait)
            self._h_prefill.observe(prefill)

    @property
    def latency_metrics(self) -> Dict[str, float]:
        """TTFT split over the rolling window: queue-wait (submit ->
        prefill start) and prefill/compute (prefill start -> first
        token) p50/p99 in ms.  Separating the two says whether high TTFT
        is an ADMISSION problem or a COMPUTE problem."""
        if not self._latencies:
            return {"queue_wait_p50_ms": 0.0, "queue_wait_p99_ms": 0.0,
                    "prefill_p50_ms": 0.0, "prefill_p99_ms": 0.0,
                    "window": 0}
        qs = sorted(q for q, _ in self._latencies)
        ps = sorted(p for _, p in self._latencies)
        return {
            "queue_wait_p50_ms": round(nearest_rank(qs, 0.50) * 1e3, 2),
            "queue_wait_p99_ms": round(nearest_rank(qs, 0.99) * 1e3, 2),
            "prefill_p50_ms": round(nearest_rank(ps, 0.50) * 1e3, 2),
            "prefill_p99_ms": round(nearest_rank(ps, 0.99) * 1e3, 2),
            "window": len(self._latencies),
        }

    @property
    def spec_metrics(self) -> Dict[str, float]:
        """Speculative serving counters for /metrics: rounds, proposed and
        accepted draft tokens, acceptance rate (0 when speculation is off
        or hasn't run)."""
        if self.spec is None:
            return {"rounds": 0, "proposed": 0, "accepted": 0, "rate": 0.0}
        return {
            "rounds": self.spec.rounds,
            "proposed": self.spec.proposed,
            "accepted": self.spec.accepted,
            "rate": round(self.spec.acceptance_rate, 4),
        }

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request finishes; returns
        req_id -> generated tokens.  (``step()`` hands each finished request
        back exactly once and the scheduler keeps no reference — a
        long-running server that drives ``step()`` itself owns the results
        and the scheduler's memory stays bounded by the active batch.)
        Requests cancelled while active appear with their partial output;
        requests cancelled while pending never appear."""
        results: Dict[int, List[int]] = {}
        while self.has_work:
            for req in self.step():
                results[req.req_id] = req.output
        return results
