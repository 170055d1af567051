"""HTTP serving front-end: an OpenAI-completions-style API over the
continuous-batching scheduler.

Counterpart of the reference's ``serve.py``: every route, payload, metric
family and ``X-Istpu-*`` header keeps the reference's name, so the front
door, ``istpu-top``, ``istpu-doctor`` and the load generator drive it
unchanged.  Only ``main`` differs: it serves the ``tiny`` model or a local
HF checkpoint directory (``load_model``) on a ``--device`` (``cuda`` by
default), and ``--role router`` hands the command line to the port's
``frontdoor.main``; ``--store-endpoints a,b,c`` (with ``--store-replicas``)
shards the store over a ``cluster.RoutedStorePool``; ``--tp N`` and
``--pp M`` serve on N x M ranks over ``torch.distributed``
(``--dist-backend``), each rank holding its stage's ``1/M`` of the layers
and its ``1/N`` of each layer's heads: this process leads (rank 0: HTTP,
scheduler, store, the unsharded draft of ``--draft-model``) and starts
the other ranks itself.

The reference's serving loop is vLLM, which fronts its engine with an
OpenAI-compatible HTTP server; a standalone framework needs the same last
mile.  Design (stdlib only, like the store's manage plane — server.py):

* one **engine thread** owns the ``Scheduler`` and is the only thread that
  touches it; HTTP handler threads talk to it through a staging list
  guarded by a condition variable (submissions, cancellations) and
  per-request ``queue.Queue``s (token delivery).  ONE exception dispatches
  device work off the engine thread: echo-request prompt scoring
  (``_score_prompt``) runs its dense forward on the handler thread, so a
  long scoring forward never head-of-line blocks in-flight decodes.  That
  forward is stateless — no paged cache, no scheduler state, no in-place
  writes — which is the invariant that makes the concurrency safe;
* ``POST /v1/completions`` — body ``{"prompt": "text" | [token ids],
  "max_tokens", "temperature", "top_p", "top_k", "stop": "s" | [..],
  "stop_token_ids": [..], "stream"}``.  With a tokenizer attached
  (``--tokenizer`` / the checkpoint's own), string prompts are encoded and
  responses carry detokenized ``"text"`` next to ``"token_ids"``; string
  ``stop`` sequences are honored vLLM-style (output truncated BEFORE the
  stop string), and EVERY entry of ``stop_token_ids`` stops generation
  (first occurrence wins).  Token-id prompts keep working without any
  tokenizer.  Non-streaming answers one JSON body; ``"stream": true``
  answers Server-Sent Events (``data: {...}``, final ``data: [DONE]``) at
  decode-chunk granularity, riding the scheduler's ``on_token`` hook —
  streamed events carry text deltas, holding back any tail that could
  still become a stop string or an incomplete UTF-8 sequence;
* ``POST /v1/chat/completions`` — the OpenAI chat surface: ``messages``
  are templated into a prompt (the tokenizer's own
  ``apply_chat_template`` when present, a minimal role-tagged transcript
  otherwise) and answered as an assistant message / streaming
  ``delta.content`` chunks;
* ``GET /v1/models`` — model card; ``GET /metrics`` — Prometheus text
  (requests served/active, tokens generated, free KV pages).

A client disconnect mid-stream cancels the request at the next chunk
boundary (pages freed, batchmates unaffected — scheduler.cancel semantics).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from .admission import AdmissionShed as _AdmissionShed
from .admission import retry_after_header as _retry_after_header
from .engine import Scheduler
from .ledger import RequestLedger
from .utils import metrics as _metrics
from .utils import resilience as _resilience
from .utils import tracing
from .utils.logging import Logger
from .utils.metrics import MetricsRegistry, PROMETHEUS_CONTENT_TYPE


class ServingServer:
    """Owns the engine thread and the HTTP server."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 8, model_id: str = "infinistore-tpu",
                 tokenizer=None, draft_engine=None, spec_k: int = 4,
                 max_queue: Optional[int] = None, spec_batch: int = 1,
                 ngram_spec: bool = False, spec_g: int = 2,
                 prefill_concurrency: int = 4,
                 slo_ttft_s: Optional[float] = None,
                 slo_tpot_s: Optional[float] = None,
                 ledger_ring: Optional[int] = None,
                 session_ring: Optional[int] = None,
                 store_manage_endpoints: Optional[List[str]] = None,
                 quotas=None, role: str = "monolith"):
        """``tokenizer``: any object with ``encode(str) -> [int]`` and
        ``decode([int]) -> str`` (an HF tokenizer qualifies) — enables
        string prompts, text responses, and string stop sequences.
        ``draft_engine`` (a second ``InferenceEngine``, same vocabulary and
        ``block_tokens``) or ``ngram_spec`` turns on speculative decoding
        as the scheduler's fast path for up to ``spec_batch`` requests
        (``spec_k`` proposals per round, ``spec_g`` the n-gram width)."""
        self.engine = engine
        self.model_id = model_id
        self.tokenizer = tokenizer
        # fleet role (disaggregated serving, docs/design.md
        # §disaggregation): "monolith" serves everything; "prefill"
        # workers additionally advertise the PD handoff contract
        # (POST /v1/prefill computes + flushes, never decodes for the
        # client); "decode" workers adopt store-resident prefixes.  The
        # role is a LABEL — every endpoint stays live on every role, so
        # a shrinking fleet can degrade to fewer specialized workers
        # without redeploying — surfaced on /healthz, /metrics, and the
        # router's rollup.
        if role not in ("monolith", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        self.role = role
        # serve-plane fault injection (house rule: every failure mode
        # the fleet claims to survive gets a FaultInjector action before
        # a mitigation).  Armed via POST /debug/faults with the store
        # injector's rule grammar, matched on the request PATH — the
        # worker-death chaos walks drive drop_conn/stall/delay through
        # this before (or instead of) killing the process.
        from .pyserver import FaultInjector

        self.faults = FaultInjector()
        # admission control: with more than this many requests in the
        # system, new submissions answer 429 instead of queueing without
        # bound (None = unbounded)
        self.max_queue = max_queue
        # per-instance registry (tests run several servers per process):
        # the scheduler's queue-wait/prefill/decode histograms land here,
        # next to this server's own request counters
        self.metrics = MetricsRegistry()
        # stage ledger (critpath.py): every retired
        # request folds into the canonical latency-attribution stages,
        # exported at GET /debug/critpath and as the
        # istpu_critpath_stage_seconds histogram family.  The fold rides
        # the request ledger's sink — one dict of float math per
        # retirement, nothing on the step hot path.
        from .critpath import StageLedger

        try:
            _cp_ring = int(os.environ.get("ISTPU_CRITPATH_RING", "") or 256)
        except ValueError:
            _cp_ring = 256
        self.critpath = StageLedger(capacity=_cp_ring,
                                    metrics=self.metrics, role=role)
        # per-request lifecycle ledger, exported at /debug/requests and
        # logged through the shared logger (trace_id-joinable) — the
        # scheduler records into it at every request exit
        self.ledger = RequestLedger(capacity=ledger_ring,
                                    sink=self.critpath.fold)
        # session-grain attribution (sessions.py):
        # requests carrying a "session" id fold into per-session turn
        # rows + the re-prefill waste accounting, exported at
        # GET /debug/sessions; the derived istpu_serve_reprefill_* /
        # istpu_serve_session_* families land on this registry.
        # Capacity: --session-ring / ISTPU_SESSION_RING (sessions, LRU).
        from .sessions import SessionLedger

        self.sessions = SessionLedger(
            capacity=session_ring,
            block_tokens=getattr(getattr(engine, "pc", None),
                                 "block_tokens", 1),
            metrics=self.metrics,
        )
        # per-step engine/device attribution (engine/stepprof.py),
        # exported at /debug/engine: one record per scheduler step —
        # dispatch counts, sampled host-stall/device-drain, retraces,
        # device memory watermarks, speculation deltas.  ISTPU_STEPPROF=0
        # disables; ISTPU_STEPPROF_SAMPLE/_RING tune it.
        from .engine.stepprof import StepProfiler

        from .engine.stepprof import default_mem_reader

        self.stepprof = StepProfiler(
            metrics=self.metrics, sentinel=lambda: self.engine.cache,
            mem_reader=lambda: default_mem_reader(self.engine))
        self.sched = Scheduler(engine, max_batch=max_batch,
                               draft_engine=draft_engine, spec_k=spec_k,
                               spec_batch=spec_batch,
                               ngram_spec=ngram_spec, spec_g=spec_g,
                               prefill_concurrency=prefill_concurrency,
                               metrics=self.metrics, ledger=self.ledger,
                               session_ledger=self.sessions,
                               slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
                               stepprof=self.stepprof)
        self._register_metrics()
        # fleet health plane (health.py): a background
        # sampler feeds the flight-recorder ring from cheap probes every
        # ISTPU_HEALTH_STEP_S and evaluates the watchdog rules; exported
        # at GET /debug/health, folded into /healthz (a firing PAGE
        # alert => degraded).  ISTPU_HEALTH=0 kills it.
        from .health import (
            HealthSampler,
            default_serve_rules,
            serve_probes,
        )

        self.health_sampler = HealthSampler(
            probes=serve_probes(self), rules=default_serve_rules(),
            metrics=self.metrics,
        )
        # SLO-aware admission control (admission.py):
        # reads the sampler's burn state, the scheduler's queue depth,
        # and the KV pool, and sheds/throttles new submissions with 429
        # + Retry-After instead of queueing past collapse.  Per-tenant
        # token quotas ride the priority-lane label (``quotas`` /
        # --quota / ISTPU_QUOTAS); ISTPU_ADMISSION=0 is the kill
        # switch.  Exported at GET /debug/admission and as a compact
        # /healthz "admission" block.
        from .admission import AdmissionController

        self.admission = AdmissionController(
            sched=self.sched, engine=engine, sampler=self.health_sampler,
            metrics=self.metrics, quotas=quotas,
        )
        self.sched.admission = self.admission
        # store manage-plane endpoints ("host:manage_port") the health
        # rollup polls — the serving side only knows SERVICE ports, so
        # the manage plane must be named explicitly
        # (--store-manage-endpoints / ISTPU_STORE_MANAGE_ENDPOINTS)
        self.store_manage_endpoints = list(store_manage_endpoints or [])
        # resumable streams (docs/design.md, resumption contract): the
        # SSE streamer checkpoints what the KV pages don't cover —
        # emitted tokens, effective sampling seed, session id — through
        # the store's inline-blob path every ISTPU_RESUME_CKPT_TOKENS
        # emitted tokens (0 disables).  Writes ride a background writer
        # thread fed from the handler threads, so neither the decode hot
        # loop nor the emit path ever blocks on the store.
        try:
            self.resume_every = int(os.environ.get(
                "ISTPU_RESUME_CKPT_TOKENS", "") or 8)
        except ValueError:
            self.resume_every = 8
        self._ckpt_q: "queue.Queue" = queue.Queue()
        self._ckpt_thread = threading.Thread(
            target=self._ckpt_loop, name="istpu-resume-ckpt", daemon=True,
        )
        self._cv = threading.Condition()
        self._staged: List[Dict[str, Any]] = []   # submissions from handlers
        self._cancels: List[int] = []
        self._queues: Dict[int, "queue.Queue"] = {}  # live req_id -> events
        self._stop = False
        self.stats = {"requests": 0, "completed": 0, "tokens": 0}
        # degraded-mode flag for /healthz: set when a store flush fails
        # (operators must see a silently-degrading cache tier without
        # reading logs), cleared by the next clean flush.  The breaker
        # state (engine.breaker) is the other /healthz input.
        self._degraded_reason: Optional[str] = None
        self._score_memo: Optional[tuple] = None  # (key, records)
        # scoring forwards run on HTTP handler threads (any of them), so the
        # memo needs a lock; holding it across the compute also makes an
        # n>1 scoring fan-out hit the memo instead of racing n dense
        # forwards
        self._score_lock = threading.Lock()
        self._scoring = 0  # in-flight handler-thread scoring forwards
        self._submitting = 0  # popped from _staged, not yet in the scheduler
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="istpu-engine", daemon=True
        )
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]

    # -- lifecycle --

    def start(self) -> None:
        self._engine_thread.start()
        self._ckpt_thread.start()
        threading.Thread(
            target=self.httpd.serve_forever, name="istpu-http", daemon=True
        ).start()
        self.health_sampler.start()
        Logger.info(f"serving {self.model_id} on :{self.port}")

    def close(self) -> None:
        self.health_sampler.stop()
        with self._cv:
            self._stop = True
            self._cv.notify()
            # every in-flight or staged request gets an "abort": its
            # handler drops the connection ABRUPTLY (no [DONE], no SSE
            # error event), so a relaying router sees a mid-stream
            # transport death and resumes on a survivor — a graceful
            # goodbye here would surface the restart to clients as an
            # error instead of a stall
            aborts = list(self._queues.values()) + \
                [it["q"] for it in self._staged]
        for q in aborts:
            q.put(("abort", "server restarting"))
        self._ckpt_q.put(None)  # writer drains the backlog, then exits
        self.httpd.shutdown()
        self.httpd.server_close()
        self._engine_thread.join(timeout=30)
        if self._ckpt_thread.is_alive():
            self._ckpt_thread.join(timeout=5)

    # -- handler-side API (any thread) --

    def prepare_body(self, body: Dict[str, Any], chat: bool) -> Dict[str, Any]:
        """Tokenization-heavy request preparation, run on the HTTP HANDLER
        thread so chat templating / long-transcript encoding never stalls
        the engine thread's decode loop.  Enforces the endpoint contract:
        chat takes ``messages``, completions takes ``prompt``.  Raises
        ValueError -> 400."""
        body = dict(body)
        # endpoint marker survives the messages->prompt conversion, so the
        # engine-thread _validate can still apply the chat-specific
        # parameter spellings (logprobs/top_logprobs) after this pop
        body["_chat"] = bool(chat or body.get("_chat"))
        if chat:
            if "messages" not in body or "prompt" in body:
                raise ValueError(
                    "chat completions take 'messages' (not 'prompt')"
                )
            body["prompt"] = self._messages_to_ids(body.pop("messages"))
        else:
            if "messages" in body:
                raise ValueError(
                    "completions take 'prompt'; use /v1/chat/completions "
                    "for 'messages'"
                )
            prompt = body.get("prompt")
            if isinstance(prompt, str):
                if self.tokenizer is None:
                    raise ValueError(
                        "string prompt requires a tokenizer (start the "
                        "server with --tokenizer); send a list of token "
                        "ids instead"
                    )
                if not prompt:
                    raise ValueError("prompt must be non-empty")
                body["prompt"] = [int(t) for t in self.tokenizer.encode(prompt)]
        return body

    def submit(self, body: Dict[str, Any]) -> "queue.Queue":
        """Stage a request; returns the queue its events arrive on.
        Events: ("tokens", [ids]) then ("done", finish_reason).

        Echo requests with ``max_tokens: 0`` (the OpenAI scoring idiom) are
        answered entirely on THIS handler thread: they touch no scheduler
        state, and a near-context-length dense scoring forward on the
        engine thread would head-of-line block every in-flight request's
        decode.  Echo+logprobs requests that DO generate get their prompt
        scored here too, with the records handed to the engine thread for
        ordered delivery after the id event."""
        q: queue.Queue = queue.Queue()
        # stats counters are mutated from handler threads AND the engine
        # thread; the registry lock is the one lock /metrics reads under,
        # so increments behind it can never expose a torn scrape
        with self.metrics.lock:
            self.stats["requests"] += 1
        # capture the HANDLER thread's trace id now: the scheduler submit
        # happens later on the engine thread, where the ambient trace is
        # an engine.step — the ledger must join to the request's own
        # http.request trace
        # staging stamp for the stage ledger: handler staging ->
        # scheduler submit is the admission_wait share of client TTFT
        item: Dict[str, Any] = {"body": body, "q": q,
                                "trace_id": tracing.current_trace_id(),
                                "t_stage": time.perf_counter()}
        if body.get("echo") and not body.get("_chat"):
            # scoring forwards are real device work: the admission limit must
            # bound them like anything else.  Check-and-reserve is ONE _cv
            # acquisition so concurrent scoring submissions can't all read
            # the pre-increment depth and overshoot max_queue.
            with self._cv:
                if self._over_depth_locked():
                    q.put(("busy", "server at capacity; retry later"))
                    return q
                self._scoring += 1
            try:
                # validation and scoring fail differently: ANY validation
                # failure is a bad request (-> 400, matching the
                # engine-thread path's catch-all), while ANY failure of
                # the scoring forward itself is a server fault (-> 500)
                try:
                    kwargs = self._validate(body)
                except Exception as e:  # noqa: BLE001 — bad request -> 400
                    q.put(("error", str(e)))
                    return q
                item["kwargs"] = kwargs  # engine thread reuses, no re-parse
                try:
                    if kwargs["max_new_tokens"] == 0:
                        # pure echo / pure scoring: nothing to generate —
                        # no page allocation, no queue slot, no
                        # engine-thread work.  Score BEFORE the id event
                        # goes out: a scoring fault must be the FIRST
                        # event (-> 500), not a stray second event after a
                        # handler already saw the id.
                        recs = (self._score_prompt(kwargs)
                                if kwargs.get("logprobs") else None)
                        q.put(("id", -1))
                        if recs is not None:
                            q.put(("prompt_lp", recs))
                        q.put(("done", "length"))
                        with self.metrics.lock:
                            self.stats["completed"] += 1
                        return q
                    if kwargs.get("logprobs"):
                        item["prompt_lp"] = self._score_prompt(kwargs)
                except Exception as e:  # noqa: BLE001 — runtime -> 500
                    q.put(("fault", f"scoring failed: {e!r}"))
                    return q
                # stage while still holding the reservation: the item is
                # counted via _staged before _scoring drops, so the depth
                # never dips mid-handoff
                with self._cv:
                    if self._stop:
                        # close() already broadcast aborts to the staged
                        # queues it could see; a submit racing past that
                        # snapshot must abort itself or it hangs forever
                        q.put(("abort", "server restarting"))
                        return q
                    self._staged.append(item)
                    self._cv.notify()
                return q
            finally:
                with self._cv:
                    self._scoring -= 1
        with self._cv:
            if self._stop:
                q.put(("abort", "server restarting"))
                return q
            self._staged.append(item)
            self._cv.notify()
        return q

    def _over_depth_locked(self) -> bool:
        """Admission depth check; caller holds ``_cv``.  Counts the
        scheduler lists (engine-thread-owned; len() reads are atomic
        snapshots), staged-but-unprocessed submissions, items the engine
        loop has popped but not yet handed to the scheduler
        (``_submitting`` — without it a scoring request admitted in that
        window overshoots ``max_queue``), and in-flight handler-thread
        scoring forwards — device work the scheduler never sees."""
        if self.max_queue is None:
            return False
        depth = (len(self.sched.pending) + len(self.sched.active)
                 + len(self.sched._prefilling) + len(self._staged)
                 + self._submitting + self._scoring)
        return depth >= self.max_queue

    def _sched_at_capacity(self) -> bool:
        """Engine-side admission for a popped item.  Deliberately narrower
        than ``_over_depth_locked``: counting ``_staged``/``_submitting``
        here would charge an older request for submissions that arrived
        AFTER it (non-FIFO 429s on an otherwise idle server); the popped
        item competes only against work already admitted (scheduler lists)
        and standing reservations (scoring forwards)."""
        if self.max_queue is None:
            return False
        with self._cv:
            depth = (len(self.sched.pending) + len(self.sched.active)
                     + len(self.sched._prefilling) + self._scoring)
            return depth >= self.max_queue

    def cancel(self, req_id: int) -> None:
        with self._cv:
            self._cancels.append(req_id)
            self._cv.notify()

    # -- stream-resume checkpoints (docs/design.md, resumption) --

    @staticmethod
    def resume_key(trace_id: str) -> str:
        """Store key of a stream's resume checkpoint.  Keyed by trace id
        — the one identifier that survives the router re-dispatching the
        request to a different worker."""
        return f"istpu:resume:{trace_id}"

    def resume_stage(self, ckpt: Dict[str, Any]) -> None:
        """Hand one checkpoint to the background writer.  Called from the
        SSE handler thread at the chunk boundary that crossed the
        cadence; never blocks (unbounded queue, tiny JSON payloads)."""
        if self.engine.transfer is None or not ckpt.get("trace_id"):
            return
        self._ckpt_q.put(ckpt)

    def _ckpt_loop(self) -> None:
        """Writer thread: drain staged checkpoints into the store as
        inline blobs.  Best-effort by contract — a failed write costs
        replay work at resume time, never a request."""
        while True:
            ckpt = self._ckpt_q.get()
            if ckpt is None:
                return
            delta = int(ckpt.pop("_delta", 0))
            data = json.dumps(ckpt).encode()
            if self.engine.transfer.put_blob(
                    self.resume_key(ckpt["trace_id"]), data):
                with self.metrics.lock:
                    self._ckpt_stats["writes"] += 1
                    self._ckpt_stats["tokens"] += delta

    def resume_fetch(self, trace_id: Optional[str]) -> Optional[Dict[str, Any]]:
        """Survivor side: the last checkpoint a died worker wrote for
        this trace, or None (store down, evicted, or death before the
        first cadence tick — the caller degrades to deterministic
        re-generation under the watermark)."""
        if self.engine.transfer is None or not trace_id:
            self._c_restore.labels("miss").inc()
            return None
        raw = self.engine.transfer.get_blob(self.resume_key(trace_id))
        if raw is None:
            self._c_restore.labels("miss").inc()
            return None
        try:
            ckpt = json.loads(bytes(raw).decode())
        except (ValueError, UnicodeDecodeError):
            self._c_restore.labels("miss").inc()
            return None
        if not isinstance(ckpt, dict) or ckpt.get("v") != 1:
            self._c_restore.labels("miss").inc()
            return None
        self._c_restore.labels("ok").inc()
        return ckpt

    # -- engine thread --

    def _engine_loop(self) -> None:
        while True:
            if not self.sched.has_work and self.engine.transfer is not None:
                # the batch just drained: join the store streamer so
                # relaxed-durability pushes land and their errors SURFACE
                # here (logged) instead of parking in the streamer until
                # a flush nobody calls.  Outside the lock — a slow store
                # must not block submissions from being STAGED (they are
                # picked up right after the join).
                try:
                    with tracing.trace("engine.store_flush"):
                        self.engine.store_flush()
                    self._degraded_reason = None
                except Exception as e:  # noqa: BLE001
                    # not just a log line: the failure must reach the
                    # breaker (so sustained failures open the circuit and
                    # stop taxing requests) and the /healthz degraded
                    # flag (so operators see it without reading logs)
                    Logger.warn(f"store flush failed: {e!r}")
                    self._degraded_reason = f"store flush failed: {e!r}"
                    _resilience.count_degraded("flush")
                    br = getattr(self.engine, "breaker", None)
                    if br is not None and isinstance(
                        e, _resilience.transport_errors()
                    ):
                        br.record_failure()
            with self._cv:
                while not (self._staged or self._cancels or self._stop
                           or self.sched.has_work):
                    self._cv.wait()
                if self._stop:
                    # second abort sweep: items this loop popped from
                    # _staged before close() snapshotted (and registered
                    # into _queues since) were invisible to close()'s
                    # broadcast; duplicates are harmless — a queue whose
                    # handler already returned just holds an unread event
                    for q in (list(self._queues.values())
                              + [it["q"] for it in self._staged]):
                        q.put(("abort", "server restarting"))
                    return
                staged, self._staged = self._staged, []
                cancels, self._cancels = self._cancels, []
                # popped items keep counting toward the admission depth
                # until the scheduler owns them (see _over_depth_locked)
                self._submitting += len(staged)
            for rid in cancels:
                self.sched.cancel(rid)
                self._queues.pop(rid, None)
            for item in staged:
                try:
                    self._submit_to_sched(item)
                finally:
                    with self._cv:
                        self._submitting -= 1
            if self.sched.has_work:
                try:
                    # one trace per scheduler step: the prefill/decode
                    # spans (and any store-hop spans under them) group
                    # into a step-granular timeline in /debug/traces
                    with tracing.trace("engine.step"):
                        retired = self.sched.step()
                    for req in retired:
                        with self.metrics.lock:
                            # handler threads increment completed too (the
                            # echo shortcut), so the counter update needs
                            # the lock
                            self.stats["completed"] += 1
                            self.stats["tokens"] += len(req.output)
                        self._queues.pop(req.req_id, None)
                except Exception as e:
                    # last-resort fault path (validation keeps bad requests
                    # out, so this is an engine/runtime failure): the
                    # scheduler owns the cleanup invariants (fault_reset);
                    # this layer only tells waiting clients the truth — an
                    # error, not a completion
                    Logger.error(f"engine step failed: {e!r}")
                    for req in self.sched.fault_reset():
                        q = self._queues.pop(req.req_id, None)
                        if q is not None:
                            q.put(("error", f"engine fault: {e!r}"))

    def _messages_to_ids(self, messages) -> List[int]:
        """Chat-completions prompt construction.  HF tokenizers bring their
        model's own chat template (``apply_chat_template``); a plain
        tokenizer falls back to a minimal role-tagged transcript ending
        with the assistant cue."""
        if self.tokenizer is None:
            raise ValueError(
                "chat completions require a tokenizer (start the server "
                "with --tokenizer)"
            )
        if not (isinstance(messages, list) and messages and all(
                isinstance(m, dict) and isinstance(m.get("role"), str)
                and isinstance(m.get("content"), str) for m in messages)):
            raise ValueError(
                "messages must be a non-empty list of {role, content}"
            )
        tmpl = getattr(self.tokenizer, "apply_chat_template", None)
        if callable(tmpl):
            ids = tmpl(messages, tokenize=True, add_generation_prompt=True)
            return [int(t) for t in ids]
        text = "".join(
            f"{m['role']}: {m['content']}\n" for m in messages
        ) + "assistant:"
        return [int(t) for t in self.tokenizer.encode(text)]

    def _validate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Range-check everything client-supplied BEFORE it reaches the
        scheduler: a bad request must be a 400, never an assertion inside
        an engine step that would take the whole batch down.

        Tokenization (string prompts / messages) delegates to
        ``prepare_body`` — the HTTP path already ran it on the handler
        thread (idempotent here: the prompt is ids by then); direct
        ``submit()`` callers get the same conversion."""
        chat = "messages" in body or bool(body.get("_chat"))
        body = self.prepare_body(body, chat="messages" in body)
        prompt = body.get("prompt")
        if not (isinstance(prompt, list) and prompt
                and all(isinstance(t, int) and not isinstance(t, bool)
                        for t in prompt)):
            raise ValueError(
                "prompt must be a non-empty string or list of token ids"
            )
        vocab = self.engine.cfg.vocab_size
        if not all(0 <= t < vocab for t in prompt):
            raise ValueError(f"prompt token ids must be in [0, {vocab})")
        max_tokens = int(body.get("max_tokens", 16))
        # max_tokens 0 is the OpenAI scoring idiom (echo + logprobs with
        # nothing generated); without echo there is nothing to return
        floor = 0 if body.get("echo") else 1
        if not floor <= max_tokens <= 1_000_000:
            raise ValueError(f"max_tokens must be >= {floor}")
        T = self.engine.pc.block_tokens
        need = -(-(len(prompt) + max_tokens) // T)
        if need > self.engine.pc.n_blocks:
            raise ValueError(
                f"prompt + max_tokens needs {need} KV pages; this engine "
                f"has {self.engine.pc.n_blocks}"
            )
        temperature = float(body.get("temperature", 1.0))
        if not 0.0 <= temperature <= 100.0:
            raise ValueError("temperature must be in [0, 100]")
        sample = "greedy" if temperature == 0.0 else (
            str(body.get("sample", "categorical")))
        if sample not in ("greedy", "categorical"):
            raise ValueError("sample must be 'greedy' or 'categorical'")
        top_k = int(body.get("top_k", 0))
        if not 0 <= top_k <= vocab:
            raise ValueError(f"top_k must be in [0, {vocab}]")
        top_p = float(body.get("top_p", 1.0))
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        presence = float(body.get("presence_penalty", 0.0))
        frequency = float(body.get("frequency_penalty", 0.0))
        if not (-2.0 <= presence <= 2.0 and -2.0 <= frequency <= 2.0):
            raise ValueError(
                "presence_penalty/frequency_penalty must be in [-2, 2]"
            )
        repetition = float(body.get("repetition_penalty", 1.0))
        if not 0.0 < repetition <= 10.0:
            raise ValueError("repetition_penalty must be in (0, 10]")
        seed = body.get("seed")
        if seed is not None and not _valid_seed(seed):
            raise ValueError("seed must be an integer in [0, 2**31)")
        echo = body.get("echo", False)
        if not isinstance(echo, bool):
            raise ValueError("echo must be a boolean")
        if echo and chat:
            raise ValueError("echo is a completions-only parameter")
        prio = body.get("priority", 0)
        tenant = body.get("tenant")
        if isinstance(prio, str):
            # string lane: a NAMED tenant riding the lane field (the
            # loadgen/bench spelling `--lanes acme:3`); ordering
            # priority defaults to 0, the explicit "tenant" field wins
            if tenant is None:
                tenant = prio
            prio = 0
        if not (isinstance(prio, int) and not isinstance(prio, bool)
                and -100 <= prio <= 100):
            raise ValueError("priority must be an integer in [-100, 100]")
        if tenant is not None:
            import re as _re

            if not (isinstance(tenant, str) and 1 <= len(tenant) <= 64
                    and _re.fullmatch(r"[A-Za-z0-9._\-]+", tenant)):
                raise ValueError(
                    "tenant must be 1-64 chars of [A-Za-z0-9._-]"
                )
        # conversation id, next to the tenant and under its contract:
        # turns of one conversation share a "session" id and fold into
        # the SessionLedger (/debug/sessions, re-prefill waste
        # attribution); the frontdoor keys decode affinity on it too
        session = body.get("session")
        if session is not None:
            import re as _re

            if not (isinstance(session, str) and 1 <= len(session) <= 64
                    and _re.fullmatch(r"[A-Za-z0-9._\-]+", session)):
                raise ValueError(
                    "session must be 1-64 chars of [A-Za-z0-9._-]"
                )
        raw_bias = body.get("logit_bias")
        logit_bias = None
        if raw_bias is not None:
            if not isinstance(raw_bias, dict) or len(raw_bias) > 300:
                raise ValueError(
                    "logit_bias must be a map of at most 300 token ids"
                )
            logit_bias = {}
            for k, v in raw_bias.items():
                try:
                    tid = int(k)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"logit_bias key {k!r} is not a token id"
                    ) from None
                if not 0 <= tid < vocab:
                    raise ValueError(
                        f"logit_bias token id {tid} outside [0, {vocab})"
                    )
                if not (isinstance(v, (int, float))
                        and not isinstance(v, bool) and -100.0 <= v <= 100.0):
                    raise ValueError("logit_bias values must be in [-100, 100]")
                logit_bias[tid] = float(v)
        n = body.get("n", 1)
        if not (isinstance(n, int) and not isinstance(n, bool)
                and 1 <= n <= 8):
            raise ValueError("n must be an integer in [1, 8]")
        # logprobs: the two endpoints spell it differently (OpenAI contract)
        # — completions: logprobs = int top-k (0 = chosen token only);
        # chat: logprobs = bool + top_logprobs = int.  Both map onto the
        # scheduler's single collector (k alternatives + the chosen token).
        _S = Scheduler
        lp_k = 0
        if chat:
            lp_flag = body.get("logprobs", False)
            if not isinstance(lp_flag, bool):
                raise ValueError("logprobs must be a boolean on "
                                 "/v1/chat/completions")
            top_lp = body.get("top_logprobs", 0) or 0
            if not (isinstance(top_lp, int) and not isinstance(top_lp, bool)
                    and 0 <= top_lp <= _S.LOGPROBS_K):
                raise ValueError(
                    f"top_logprobs must be an integer in "
                    f"[0, {_S.LOGPROBS_K}]"
                )
            if top_lp and not lp_flag:
                raise ValueError("top_logprobs requires logprobs: true")
            lp_k = max(top_lp, 1) if lp_flag else 0
        else:
            lp = body.get("logprobs")
            if lp is not None:
                if not (isinstance(lp, int) and not isinstance(lp, bool)
                        and 0 <= lp <= 5):
                    raise ValueError("logprobs must be an integer in [0, 5]")
                lp_k = max(lp, 1)
        if echo and lp_k and len(prompt) > SCORING_MAX_PROMPT:
            raise ValueError(
                f"echo+logprobs scores the prompt in one dense forward; "
                f"prompts longer than {SCORING_MAX_PROMPT} tokens are not "
                f"supported"
            )
        stops = body.get("stop_token_ids") or []
        if stops and not all(isinstance(t, int) for t in stops):
            raise ValueError("stop_token_ids must be token ids")
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        if not (isinstance(stop, list)
                and all(isinstance(s, str) and s for s in stop)):
            raise ValueError("stop must be a string or list of strings")
        if stop and self.tokenizer is None:
            raise ValueError(
                "string stop sequences require a tokenizer; use "
                "stop_token_ids instead"
            )
        # multi-LoRA serving (the vLLM "served adapter as a model" pattern):
        # "model" naming a bank adapter routes the request to that adapter;
        # the base model id (or omitting "model") is the base weights
        adapter_id = 0
        model = body.get("model")
        if model is not None and model != self.model_id:
            bank = getattr(self.engine, "lora", None)
            if bank is None:
                raise ValueError(
                    f"unknown model {model!r}; this server serves "
                    f"{self.model_id!r}"
                )
            try:
                adapter_id = bank.adapter_id(str(model))
            except KeyError:
                raise ValueError(
                    f"unknown model/adapter {model!r}; have "
                    f"{[self.model_id] + bank.names[1:]}"
                ) from None
        # restore-path pre-seed (the resumption contract): generated-so-
        # far tokens a survivor adopts from a died worker's checkpoint.
        # Internal — the HTTP layer pops any wire-supplied value and only
        # injects what it fetched from the store itself.
        resume_output = body.get("_resume_output")
        if resume_output is not None:
            if not (isinstance(resume_output, list)
                    and all(isinstance(t, int) and not isinstance(t, bool)
                            and 0 <= t < vocab for t in resume_output)):
                raise ValueError(
                    "_resume_output must be a list of in-vocab token ids"
                )
            if lp_k:
                raise ValueError(
                    "stream resumption does not support logprobs"
                )
        return {
            "tokens": prompt, "max_new_tokens": max_tokens,
            "adapter_id": adapter_id,
            # the FULL stop list (first occurrence of any id stops)
            "eos_ids": [int(t) for t in stops] or None,
            "sample": sample,
            # OpenAI convention: temperature 0 means greedy
            "temperature": temperature or 1.0,
            "top_k": top_k, "top_p": top_p,
            "presence_penalty": presence, "frequency_penalty": frequency,
            "repetition_penalty": repetition,
            "seed": seed,
            "logit_bias": logit_bias,
            "priority": prio,
            "tenant": tenant,
            "session": session,
            "logprobs": lp_k,
            "resume_output": resume_output,
        }

    def logprobs_display_k(self, body: Dict[str, Any],
                           chat: bool) -> Optional[int]:
        """How many top-alternatives the RESPONSE should show: None when
        the request didn't ask for logprobs at all, else the alternative
        count (0 = chosen-token logprob only).  Mirrors ``_validate``'s
        endpoint-specific spelling."""
        if chat:
            if not body.get("logprobs", False):
                return None
            return int(body.get("top_logprobs", 0) or 0)
        lp = body.get("logprobs")
        return None if lp is None else int(lp)

    def tok_str(self, tid: int) -> str:
        """Display form of a token for logprobs payloads: the tokenizer's
        own token string when available, the bare id otherwise."""
        if self.tokenizer is not None:
            conv = getattr(self.tokenizer, "convert_ids_to_tokens", None)
            if callable(conv):
                return str(conv([tid])[0])
            return self.tokenizer.decode([tid])
        return str(tid)

    def _score_prompt(self, kwargs: Dict[str, Any]) -> List[tuple]:
        """Prompt-scoring records, memoized single-entry: an n>1 scoring
        request submits n identical bodies back to back (only the seed
        differs, which scoring ignores) — compute the dense forward once
        and fan the records out.  Runs on HTTP handler threads; the lock
        spans the compute so identical concurrent requests coalesce."""
        key = (tuple(kwargs["tokens"]), kwargs.get("adapter_id", 0))
        # the caller (submit()'s echo branch) holds the _scoring
        # reservation for the duration of this call
        with self._score_lock:
            hit = self._score_memo
            if hit is not None and hit[0] == key:
                return hit[1]
            recs = self.engine.prompt_logprobs(
                kwargs["tokens"], k=Scheduler.LOGPROBS_K,
                adapter_id=kwargs.get("adapter_id", 0),
            )
            self._score_memo = (key, recs)
            return recs

    def _submit_to_sched(self, item: Dict[str, Any]) -> None:
        body, q = item["body"], item["q"]
        # finish_reason per the OpenAI contract: "stop" when a stop id
        # ended generation (visible tokens are eos-trimmed, so the last
        # delivered token tells), "length" when the budget did
        tally = {"n": 0, "eos": False, "budget": 0, "eos_set": frozenset(),
                 "req": None}

        def on_token(tokens: List[int], done: bool) -> None:
            if tokens:
                req = tally["req"]
                if req is not None and req.logprobs:
                    # lp records ride AHEAD of their tokens so stream
                    # handlers have them when the chunk goes out; slices
                    # align 1:1 with the visible-token stream
                    lo = tally["n"]
                    q.put(("lp", list(req.lp_data[lo:lo + len(tokens)])))
                tally["n"] += len(tokens)
                if tokens[-1] in tally["eos_set"]:
                    tally["eos"] = True
                q.put(("tokens", list(tokens)))
            if done:
                q.put((
                    "done",
                    "length"
                    if not tally["eos"] and tally["n"] >= tally["budget"]
                    else "stop",
                ))

        if "kwargs" not in item and self._sched_at_capacity():
            # pre-scored echo items were admitted (and reserved) in
            # submit(); busy-rejecting them HERE would throw away the dense
            # forward the admission check exists to protect
            q.put(("busy", "server at capacity; retry later"))
            return
        try:
            # echo requests arrive pre-validated (submit() needed the
            # kwargs for the scoring forward); everything else validates
            # here on the engine thread
            kwargs = item.get("kwargs") or self._validate(body)
            kwargs.setdefault("trace_id", item.get("trace_id"))
            kwargs.setdefault("t_stage", item.get("t_stage") or 0.0)
            tally["budget"] = kwargs["max_new_tokens"]
            tally["eos_set"] = frozenset(kwargs["eos_ids"] or ())
            req_id = self.sched.submit(on_token=on_token, **kwargs)
            if kwargs.get("logprobs"):
                # the engine thread owns both this submit and every later
                # on_token call, so holding the Request here is race-free
                tally["req"] = next(
                    r for r in self.sched.pending if r.req_id == req_id
                )
            self._queues[req_id] = q
            q.put(("id", req_id))
            if item.get("prompt_lp") is not None:
                # OpenAI echo+logprobs scoring alongside generation: the
                # handler thread already computed the records (submit());
                # queued right after the id, so handlers see them before
                # any token event (no scheduler step has run yet)
                q.put(("prompt_lp", item["prompt_lp"]))
        except _AdmissionShed as e:
            # the admission controller refused the submission (quota /
            # shed-on-burn): a 429 + Retry-After, not an error — the
            # request never held scheduler state
            q.put(("shed", {"error": str(e), "reason": e.reason,
                            "retry_after_s": e.retry_after_s}))
        except Exception as e:
            q.put(("error", str(e)))

    # -- metrics --

    def _register_metrics(self) -> None:
        """Declare this server's metric families on its registry.  Every
        pre-registry metric name is preserved verbatim; the counters are
        exposition-time callbacks into ``self.stats`` (mutated under the
        registry's lock) and live scheduler/engine state, so a scrape is
        always a consistent read with no double bookkeeping."""
        reg = self.metrics

        def stat(name):
            return lambda: self.stats[name]

        def lat(name):
            return lambda: self.sched.latency_metrics[name]

        reg.gauge("istpu_serve_role",
                  "Fleet role of this serving process (1 on the active "
                  "label: monolith/prefill/decode)",
                  labelnames=("role",)).labels(self.role).set(1)
        reg.counter("istpu_serve_requests_total",
                    "Requests submitted", fn=stat("requests"))
        reg.counter("istpu_serve_completed_total",
                    "Requests completed", fn=stat("completed"))
        reg.counter("istpu_serve_tokens_total",
                    "Tokens generated", fn=stat("tokens"))
        # resumable-stream accounting (docs/design.md, resumption):
        # checkpoint writes land on the writer thread under the registry
        # lock; restores count on the SURVIVOR at adoption time — the
        # stream_resume_spike watchdog rule rides the restore series
        self._ckpt_stats = {"writes": 0, "tokens": 0}
        reg.counter("istpu_serve_resume_ckpt_writes_total",
                    "Stream-resume checkpoints written to the store "
                    "(cadence: ISTPU_RESUME_CKPT_TOKENS emitted tokens)",
                    fn=lambda: self._ckpt_stats["writes"])
        reg.counter("istpu_serve_resume_ckpt_tokens_total",
                    "Emitted tokens covered by written resume checkpoints "
                    "(ckpt-to-ckpt deltas; lag behind tokens_total is the "
                    "worst-case replay window on resume)",
                    fn=lambda: self._ckpt_stats["tokens"])
        self._c_restore = reg.counter(
            "istpu_serve_resume_restores_total",
            "Survivor-side mid-stream restores by result: ok (checkpoint "
            "found and adopted), miss (none found — full deterministic "
            "re-generation under the router's watermark)",
            labelnames=("result",))
        for res in ("ok", "miss"):
            self._c_restore.labels(res)
        reg.gauge("istpu_serve_free_kv_pages", "Free KV cache pages",
                  fn=lambda: self.engine.free_pages)
        # TTFT split (rolling window): queue-wait vs prefill/compute —
        # says whether high TTFT is admission or compute.  Point-in-time
        # convenience views; the rate()-able truth is the
        # istpu_serve_queue_wait/prefill_seconds histograms next to them.
        reg.gauge("istpu_serve_queue_wait_p50_ms",
                  "Rolling-window queue-wait p50",
                  fn=lat("queue_wait_p50_ms"))
        reg.gauge("istpu_serve_queue_wait_p99_ms",
                  "Rolling-window queue-wait p99",
                  fn=lat("queue_wait_p99_ms"))
        reg.gauge("istpu_serve_prefill_p50_ms",
                  "Rolling-window prefill p50", fn=lat("prefill_p50_ms"))
        reg.gauge("istpu_serve_prefill_p99_ms",
                  "Rolling-window prefill p99", fn=lat("prefill_p99_ms"))
        if self.sched.spec is not None:
            def spec(name):
                return lambda: self.sched.spec_metrics[name]

            reg.gauge("istpu_spec_kind", "Active speculation mode",
                      labelnames=("kind",)).labels(
                          self.sched.spec_kind).set(1)
            reg.counter("istpu_spec_rounds_total",
                        "Speculative rounds run", fn=spec("rounds"))
            reg.counter("istpu_spec_proposed_tokens_total",
                        "Draft tokens proposed", fn=spec("proposed"))
            reg.counter("istpu_spec_accepted_tokens_total",
                        "Draft tokens accepted", fn=spec("accepted"))
            reg.gauge("istpu_spec_acceptance_rate",
                      "accepted/proposed", fn=spec("rate"))

    def health(self) -> Dict[str, Any]:
        """The /healthz payload: ``degraded`` while the store circuit is
        not closed, the last store flush failed, or a PAGE-severity
        watchdog alert is firing (docs/runbook.md) — serving keeps
        answering (recompute path), but prefix reuse and KV durability
        are impaired and operators should look at the store tier."""
        br = getattr(self.engine, "breaker", None)
        circuit = br.state if br is not None else None
        hs = self.health_sampler
        firing = hs.firing() if hs.enabled else []
        page = [f for f in firing if f["severity"] == "page"]
        degraded = (circuit not in (None, "closed")
                    or self._degraded_reason is not None
                    or bool(page))
        out: Dict[str, Any] = {
            "status": "degraded" if degraded else "ok",
            # fleet role label: the router's rollup (and the cluster
            # rollup) group by this
            "role": self.role,
        }
        if circuit is not None:
            out["store_circuit"] = circuit
        if self._degraded_reason is not None:
            out["reason"] = self._degraded_reason
        if hs.enabled:
            out["alerts"] = {
                "firing": len(firing), "page": len(page),
                "rules": sorted(f["rule"] for f in firing),
            }
        adm = getattr(self, "admission", None)
        if adm is not None and adm.enabled:
            # "are we shedding?" belongs on the first read an operator
            # makes.  NOTE the /healthz payload grows over time — assert
            # fields, never the exact body (scripts/healthz_assert_lint
            # .py enforces this in CI).
            out["admission"] = adm.health_block()
        return out

    def debug_health(self, series: Optional[str] = None,
                     limit: Optional[int] = None) -> Dict[str, Any]:
        """The /debug/health payload: the sampler's alert/timeline
        snapshot, plus the CLUSTER rollup — per-node circuit states from
        the routed pool and, when store manage endpoints are configured,
        each node's own /healthz + /debug/health verdicts (unreachable
        nodes degrade the rollup instead of failing it)."""
        from .health import cluster_rollup

        out = self.health_sampler.snapshot(series=series, limit=limit)
        cl = self.cluster_report()
        cluster: Dict[str, Any] = {}
        if cl.get("enabled"):
            cluster["ring"] = [
                {"endpoint": n["endpoint"], "state": n["state"],
                 "membership": n.get("membership", "active")}
                for n in cl.get("nodes", ())
            ]
            mig = cl.get("migration")
            if mig and mig.get("state") != "idle":
                cluster["migration"] = mig
        if self.store_manage_endpoints:
            cluster.update(cluster_rollup(self.store_manage_endpoints))
        if cluster:
            out["cluster"] = cluster
        return out

    def _store_conns(self) -> List[Any]:
        """Every stitchable store connection behind this engine (one for
        a plain transfer, every node's for a clustered pool)."""
        conns: List[Any] = []
        transfer = getattr(self.engine, "transfer", None)
        if transfer is not None:
            srcs = getattr(transfer, "trace_srcs", None)
            if srcs is not None:  # clustered: every node's span ring
                conns.extend(srcs())
            else:
                conns.append(transfer._src)
        return conns

    def debug_traces_json(self, limit: Optional[int] = None) -> str:
        """The /debug/traces payload: the process trace ring, STITCHED
        with the attached store's server-side span ring when the store
        connection negotiated wire trace context (one Perfetto file shows
        http.request → engine.step → kv.load_pages → [wire] →
        store.GET_DESC → store.desc_build end to end, clock-skew
        corrected).  Falls back to the local ring alone when there is no
        stitchable store."""
        from .utils import trace_stitch

        return trace_stitch.stitched_chrome_json(
            tracing.TRACER, self._store_conns(), limit=limit
        )

    def debug_trace_json(self, trace_id: str) -> str:
        """ONE request's stitched timeline (``/debug/trace/{id}``): the
        local ring plus every attached store's ring, narrowed to the
        trace id — the worker-grain half of the frontdoor's mesh-wide
        single-trace download."""
        from .utils import trace_stitch

        return trace_stitch.stitched_chrome_json(
            tracing.TRACER, self._store_conns(), trace_id=trace_id,
            local_role=self.role,
        )

    def debug_traces_raw(self, limit: Optional[int] = None,
                         trace_id: Optional[str] = None,
                         include_stores: bool = False) -> Dict[str, Any]:
        """Raw span-ring dump with process-clock stamps plus ``clock`` =
        now on the same clock — the HTTP twin of the wire
        ``OP_TRACE_DUMP`` (``/debug/traces?raw=1``).  The fleet front
        door polls this from every worker and maps the stamps into its
        own timeline (round-trip-midpoint offset estimate, the HELLO
        clock-sync trick over HTTP), which is what turns N worker rings
        into ONE stitched Perfetto file.

        ``include_stores`` adds each attached store's ring under
        ``remotes``, with stamps PRE-MAPPED into this worker's clock
        (the wire-HELLO offset applied here), so the frontdoor's one
        worker offset carries store spans onto the router timeline
        transitively; each entry keeps the residual error bound.
        ``trace_id`` narrows everything to one trace."""
        from .utils import trace_stitch

        d = tracing.TRACER.dump(limit, trace_id=trace_id)
        d["role"] = self.role
        if not include_stores:
            return d
        remotes = []
        for conn in self._store_conns():
            got = trace_stitch.gather_remote(conn)
            if got is None:
                continue
            dump, offset, err = got
            traces = []
            for tr in dump.get("traces", []):
                if trace_id is not None and tr.get("trace_id") != trace_id:
                    continue
                traces.append({
                    "trace_id": tr.get("trace_id"),
                    "name": tr.get("name"),
                    "events": [[n, t0 - offset, t1 - offset, tid, a]
                               for (n, t0, t1, tid, a)
                               in tr.get("events", [])],
                })
            remotes.append({
                "pid": dump.get("pid"), "role": "store",
                "dropped": dump.get("dropped"),
                "clock_offset_err_s": err,
                "traces": traces,
            })
        d["remotes"] = remotes
        return d

    def cluster_report(self) -> Dict[str, Any]:
        """The /debug/cluster payload: ring + per-node state when the
        engine's store is a RoutedStorePool, else a disabled marker."""
        transfer = getattr(self.engine, "transfer", None)
        rep = getattr(transfer, "cluster_report", None)
        if rep is None:
            return {"enabled": False}
        return rep()

    def tenant_tokens(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant prompt-token provenance from the engine counter
        (``istpu_engine_tenant_prefix_tokens_total`` — the process
        registry, where engines register): ``{tenant: {source:
        tokens}}`` — the "tokens saved" side of the usage ledger."""
        out: Dict[str, Dict[str, float]] = {}
        for labels, v in _metrics.default_registry().family_items(
                "istpu_engine_tenant_prefix_tokens_total"):
            tenant = labels.get("tenant")
            src = labels.get("source")
            if tenant is None or src is None:
                continue
            out.setdefault(tenant, {})[src] = (
                out.get(tenant, {}).get(src, 0.0) + v
            )
        return out

    def usage_debug(self) -> Dict[str, Any]:
        """The serve plane's ``GET /debug/usage``: join every named
        store node's ``/debug/usage`` with this engine's per-tenant
        token provenance into one ledger (``usage.usage_report``) —
        per-tenant byte·seconds held vs tokens served from the store,
        i.e. "is the cache paying for itself, and for whom"."""
        from .health import fetch_json
        from .usage import usage_report

        stores = []
        store_nodes = []
        for ep in self.store_manage_endpoints:
            base = ep if ep.startswith("http") else f"http://{ep}"
            u = fetch_json(base.rstrip("/") + "/debug/usage")
            store_nodes.append({"endpoint": ep,
                                "reachable": u is not None})
            if u:
                stores.append(u)
        out = usage_report(stores, tenant_tokens=self.tenant_tokens())
        out["store_nodes"] = store_nodes
        out["role"] = self.role
        return out

    def metrics_text(self) -> str:
        """Prometheus exposition: this server's registry plus the
        process-global one (the client data plane's
        ``istpu_client_op_seconds`` stage histograms live there, because
        connections are created deep inside engines)."""
        text = self.metrics.to_prometheus_text()
        client = _metrics.default_registry()
        if client is not self.metrics:
            # skip families this server already owns (a library-default
            # Scheduler elsewhere in the process may have registered the
            # same names globally): one TYPE line per family per scrape
            text += client.to_prometheus_text(exclude=self.metrics.names())
        return text


SCORING_MAX_PROMPT = 8192  # echo+logprobs runs ONE dense forward (see
# InferenceEngine.prompt_logprobs); past this the [S, V] logits dominate
# device memory, so the contract rejects instead of OOMing mid-request


def _prompt_lp_payload(server, echo_ids: List[int], prompt_lps: List[tuple],
                       lp_k: int) -> Dict[str, Any]:
    """The prompt half of an echo+logprobs payload: position 0 has no
    distribution (null), then the scoring records.  One definition shared
    by batch assembly and the streaming echo chunk."""
    return {
        "tokens": [server.tok_str(t) for t in echo_ids],
        "token_logprobs": [None] + [c for c, _ in prompt_lps],
        "top_logprobs": [None] + [
            {server.tok_str(a): v for a, v in top[:lp_k]}
            for _, top in prompt_lps
        ],
    }


def _valid_seed(seed: Any) -> bool:
    """The one definition of an acceptable wire seed — shared by _validate
    (rejection) and the n>1 per-choice derivation (which must only derive
    from seeds _validate would accept)."""
    return (isinstance(seed, int) and not isinstance(seed, bool)
            and 0 <= seed < 2 ** 31)


def _lp_payload(server, token_ids: List[int], lps: List[tuple],
                k: int, chat: bool) -> Dict[str, Any]:
    """OpenAI logprobs object for ``token_ids`` from the scheduler's
    records ``(chosen_logprob, [(alt_id, alt_logprob) x K])``.  The two
    endpoints use different shapes: completions a column-oriented dict,
    chat a per-token ``content`` list.  ``k`` = alternatives to show
    (records carry Scheduler.LOGPROBS_K; rows slice down)."""
    if chat:
        return {"content": [
            {
                "token": server.tok_str(t),
                "logprob": chosen,
                "top_logprobs": [
                    {"token": server.tok_str(a), "logprob": alp}
                    for a, alp in top[:k]
                ],
            }
            for t, (chosen, top) in zip(token_ids, lps)
        ]}
    return {
        "tokens": [server.tok_str(t) for t in token_ids],
        "token_logprobs": [chosen for chosen, _ in lps],
        "top_logprobs": [
            {server.tok_str(a): alp for a, alp in top[:k]} for _, top in lps
        ],
    }


_REPL = "�"  # tokenizers emit U+FFFD for incomplete multibyte output


class _TextAccum:
    """Incremental detokenization with vLLM stop-string semantics.

    * The decoded text grows by APPEND-ONLY deltas computed with the
      two-offset incremental scheme (``convert_ids_to_tokens`` /
      ``convert_tokens_to_string`` — the vLLM detokenizer pattern, exact
      for SentencePiece/BPE where a plain ``decode`` of an id slice is
      not), so per-chunk cost is O(chunk), not O(total output).  A
      tokenizer without that API falls back to full re-decode per chunk.
    * The output is truncated BEFORE the earliest stop-string match —
      both the text AND the visible token ids (``visible_ids``).
    * Streamed deltas hold back any tail that could still grow into a
      stop string or an incomplete UTF-8 sequence.
    """

    def __init__(self, tokenizer, stop_strs: List[str]):
        self.tok = tokenizer
        self.stops = [s for s in stop_strs if s]
        self.hold = max((len(s) - 1 for s in self.stops), default=0)
        self.ids: List[int] = []
        self.emitted = 0  # chars already released downstream
        self.stop_cut: Optional[int] = None  # char index of the stop match
        self._text = ""  # decoded so far (append-only on the incr path)
        # (ids consumed, text length) milestones: maps the stop's char cut
        # back to the id prefix whose decode covers it
        self._miles: List[tuple] = []
        self._incr = callable(
            getattr(tokenizer, "convert_ids_to_tokens", None)
        ) and callable(getattr(tokenizer, "convert_tokens_to_string", None))
        self._toks: List[str] = []  # token strings (incremental path)
        self._p = 0  # prefix offset: tokens already folded into _text
        self._r = 0  # read offset: end of the last complete decode window
        self._hcur = 0  # emit_ids_horizon cursor into _miles (incr path)
        self._hids = 0  # last horizon id count (fallback path)

    def _ingest(self, ids: List[int]) -> None:
        if not self._incr:
            self.ids.extend(ids)
            self._text = self.tok.decode(self.ids)
            return
        for tok_s, tid in zip(self.tok.convert_ids_to_tokens(ids), ids):
            self._toks.append(tok_s)
            self.ids.append(tid)
            full = self.tok.convert_tokens_to_string(self._toks[self._p:])
            if full and not full.endswith(_REPL):
                prefix = self.tok.convert_tokens_to_string(
                    self._toks[self._p:self._r]
                )
                if len(full) > len(prefix):
                    self._text += full[len(prefix):]
                    self._p, self._r = self._r, len(self._toks)
            self._miles.append((len(self.ids), len(self._text)))

    def _release(self, final: bool):
        text = self._text
        cut = -1
        for s in self.stops:  # str.find is cheap; detok was the O(n^2) part
            i = text.find(s)
            if i != -1 and (cut == -1 or i < cut):
                cut = i
        if cut != -1:
            self.stop_cut = cut
            delta = text[self.emitted:cut] if cut > self.emitted else ""
            self.emitted = max(self.emitted, cut)
            return delta, True
        safe = len(text) if final else max(len(text) - self.hold, self.emitted)
        while safe > self.emitted and not final and text[safe - 1] == _REPL:
            safe -= 1
        delta = text[self.emitted:safe]
        self.emitted = safe
        return delta, False

    def add(self, ids: List[int]):
        """Consume newly generated ids; returns ``(delta_text, stopped)``."""
        self._ingest(list(ids))
        return self._release(final=False)

    def finish(self) -> str:
        """Release the held-back tail (scanning it for a late stop)."""
        if self._incr and self._r < len(self._toks):
            # flush an unterminated partial sequence as-is (genuinely
            # malformed output keeps its replacement chars)
            prefix = self.tok.convert_tokens_to_string(
                self._toks[self._p:self._r]
            )
            full = self.tok.convert_tokens_to_string(self._toks[self._p:])
            if len(full) > len(prefix):
                self._text += full[len(prefix):]
                self._miles.append((len(self.ids), len(self._text)))
        return self._release(final=True)[0]

    def _covering_prefix(self, chars: int) -> int:
        """Smallest id count whose decoded text covers ``chars`` — the one
        id/text correspondence rule, shared by ``visible_ids`` (stop
        truncation) and ``emit_ids_horizon`` (streaming) so the two can
        never disagree about which ids a char boundary maps to."""
        if chars <= 0:
            # a boundary at char 0 (e.g. the model echoes the stop
            # immediately) maps to ZERO ids
            return 0
        if self._incr:
            for n, c in self._miles:
                if c >= chars:
                    return n
            return len(self.ids)
        lo, hi = 0, len(self.ids)  # bisection on the fallback path
        while lo < hi:
            mid = (lo + hi) // 2
            if len(self.tok.decode(self.ids[:mid])) >= chars:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def emit_ids_horizon(self) -> int:
        """ids safe to stream now: the prefix whose decode is covered by
        the RELEASED text.  Ids for held-back text (stop-prefix / partial
        UTF-8 tail) are withheld with it, so a stop that later completes
        can never leave the client holding ids past the stop cut; any
        future cut is >= ``emitted``, hence maps to >= this many ids.

        Called once per streamed chunk, so it keeps a cursor instead of
        re-deriving from scratch: ``emitted`` only grows and ``_miles`` is
        monotone, making the incremental path O(1) amortized; the fallback
        path restarts its bisection above the last horizon (that path's
        ``_ingest`` full re-decode dominates anyway)."""
        if self.emitted <= 0:
            return 0
        if self._incr:
            i = self._hcur
            miles = self._miles
            while i < len(miles) and miles[i][1] < self.emitted:
                i += 1
            self._hcur = i
            return miles[i][0] if i < len(miles) else len(self.ids)
        lo, hi = self._hids, len(self.ids)
        while lo < hi:
            mid = (lo + hi) // 2
            if len(self.tok.decode(self.ids[:mid])) >= self.emitted:
                hi = mid
            else:
                lo = mid + 1
        self._hids = lo
        return lo

    @property
    def text(self) -> str:
        """Everything released so far (the visible completion)."""
        return self._text[: self.emitted]

    def visible_ids(self) -> List[int]:
        """token_ids matching the visible text: the shortest id prefix
        whose decoded text covers the stop-truncated horizon (all ids when
        no stop was hit) — ids and text never disagree about what was
        generated."""
        if self.stop_cut is None:
            return list(self.ids)
        return self.ids[: self._covering_prefix(self.stop_cut)]


def _make_handler(server: ServingServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            Logger.debug("http " + fmt % args)

        def _fault_gate(self) -> bool:
            """Apply an armed serve-plane fault rule to this request
            (the worker-death chaos machinery).  Rules match on the
            request path (``{"op": "/v1/prefill", "action":
            "drop_conn"}``); ``/debug/faults`` itself is exempt so a
            ``*`` rule can never lock out its own clear.  Returns True
            when the request should proceed."""
            if not server.faults.armed:
                return True
            rule = server.faults.match(self.path.split("?", 1)[0].upper())
            if rule is None:
                return True
            action = rule["action"]
            if action == "delay":
                time.sleep(rule["delay_s"])
                return True
            if action == "stall":
                # the hang no socket error surfaces: held until the rule
                # is cleared (the router's leg timeout is the escape)
                while server.faults.active(rule["id"]):
                    time.sleep(0.05)
                return True
            if action == "drop_conn":
                try:
                    self.connection.close()
                except OSError:
                    pass
                return False
            if action == "error":
                self._json(500, {"error": "injected fault"})
                return False
            return True  # "corrupt" is a store-plane action: no-op here

        def _stream_fault(self) -> bool:
            """Mid-stream fault point, matched at every SSE chunk
            boundary against the pseudo-op ``STREAM`` — the request-entry
            gate above cannot kill a stream AFTER bytes went out, which
            is exactly the window the resumption walk needs
            (``decode_death_mid_stream`` uses ``after`` to let N chunks
            through first).  Returns False when the stream should die
            abruptly now (connection already closed)."""
            if not server.faults.armed:
                return True
            rule = server.faults.match("STREAM")
            if rule is None:
                return True
            action = rule["action"]
            if action == "delay":
                time.sleep(rule["delay_s"])
                return True
            if action == "stall":
                while server.faults.active(rule["id"]):
                    time.sleep(0.05)
                return True
            if action == "drop_conn":
                try:
                    # an abrupt RST, not a tidy FIN after [DONE]: the
                    # relay must see a mid-stream transport death
                    self.connection.close()
                except OSError:
                    pass
                return False
            return True

        def _json(self, code: int, obj: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if not self._fault_gate():
                return
            if self.path == "/v1/models":
                cards = [{"id": server.model_id, "object": "model",
                          "owned_by": "infinistore-tpu"}]
                bank = getattr(server.engine, "lora", None)
                if bank is not None:  # each served adapter is a "model"
                    cards += [
                        {"id": name, "object": "model",
                         "owned_by": "infinistore-tpu",
                         "parent": server.model_id}
                        for name in bank.names[1:]
                    ]
                self._json(200, {"object": "list", "data": cards})
            elif self.path == "/metrics":
                data = server.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/healthz":
                # liveness + store-tier degradation (docs/robustness.md):
                # always 200 — the serving plane is up either way; the
                # body says whether the cache tier behind it is
                self._json(200, server.health())
            elif self.path.split("?", 1)[0] == "/debug/requests":
                # the request ledger: recent per-request lifecycle
                # records with waterfall attribution, joinable to
                # /debug/traces by trace_id.  ?limit=N caps the tail
                # (ring capacity itself is ISTPU_LEDGER_RING).
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                self._json(200, server.ledger.snapshot(limit=limit))
            elif self.path.split("?", 1)[0] == "/debug/sessions":
                # the session ledger: per-conversation turn histories
                # (context growth, TTFT, provenance split) + the
                # re-prefill waste totals, joinable to /debug/requests
                # by trace_id.  ?limit=N caps the session rows (LRU
                # capacity itself is ISTPU_SESSION_RING).
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                self._json(200, server.sessions.snapshot(limit=limit))
            elif self.path.split("?", 1)[0] == "/debug/engine":
                # the step profiler's ring: one record per engine step
                # (kind, batch, dispatch counts, sampled host-stall and
                # device-mem watermarks, retraces, speculation deltas)
                # plus the lifetime summary.  ?limit=N caps the records
                # returned; /debug/requests rows join here by step_ids.
                # ``kernel_launches``: the process's launches of each
                # hand-written kernel (all zero on the CPU, where the
                # plain versions run).
                from urllib.parse import parse_qs, urlsplit

                from .ops import cuda_attention

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                payload = server.stepprof.snapshot(limit=limit)
                payload["kernel_launches"] = dict(cuda_attention.LAUNCHES)
                # under tensor parallelism: every rank's backend, whether
                # its graphs capture, held bytes and kernel launches
                ranks = server.engine.tp_report()
                if ranks is not None:
                    payload["tp"] = {"size": len(ranks), "ranks": ranks}
                self._json(200, payload)
            elif self.path.split("?", 1)[0] == "/debug/health":
                # the fleet health plane: watchdog alerts (firing/
                # cleared, transitions) + the flight recorder's series
                # (?series=a,b selects timeline tails, ?limit=N caps
                # points) + the cluster health rollup.  /healthz is the
                # one-bit summary; this is the history behind it.
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                series = q.get("series", [None])[0]
                self._json(200, server.debug_health(series=series,
                                                    limit=limit))
            elif self.path.split("?", 1)[0] == "/debug/admission":
                # the admission-control plane: mode (normal/shed), burn
                # state and the current shed-lane ladder, decision and
                # shed tallies, per-tenant quota buckets, the prefill
                # throttle, and the live queue/drain/pool inputs.
                # Answers {"enabled": false} under ISTPU_ADMISSION=0.
                self._json(200, server.admission.snapshot())
            elif self.path.split("?", 1)[0] == "/debug/cluster":
                # the store-cluster view: ring ownership, per-node
                # circuit state, request/replica-read counters, and the
                # hot/pinned prefix tracker ({"enabled": false} when the
                # store is a single node or absent)
                self._json(200, server.cluster_report())
            elif self.path.split("?", 1)[0] == "/debug/usage":
                # the tenant usage ledger: per-tenant store occupancy
                # (byte·seconds, both tiers, joined across the named
                # store nodes) against per-tenant token provenance —
                # the cache-economics view (docs/observability.md
                # §Usage attribution)
                self._json(200, server.usage_debug())
            elif self.path.split("?", 1)[0] == "/debug/critpath":
                # the stage ledger: p50/p99 TTFT by canonical stage,
                # dominant stage, worst-offender trace ids — per lane
                # and overall (docs/observability.md §Latency
                # attribution).  ?limit=N caps the row tail returned;
                # ring capacity itself is ISTPU_CRITPATH_RING.
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                self._json(200, server.critpath.snapshot(limit=limit))
            elif self.path.split("?", 1)[0] == "/debug/traces":
                # recent completed request/step traces as Chrome trace-
                # event JSON — stitched with the attached store's server-
                # side spans when trace context negotiated: save the body
                # to a file and load it in Perfetto (ui.perfetto.dev) or
                # chrome://tracing.  ?limit=N caps the local traces
                # exported (ring capacity itself is ISTPU_TRACE_RING).
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                if q.get("raw", ["0"])[0] not in ("0", ""):
                    # raw dump (process-clock stamps + `clock`): the
                    # front door's cross-process stitch input.
                    # ?stores=1 folds the attached store rings in
                    # (pre-mapped into this worker's clock) for the
                    # transitive mesh gather; ?trace_id= narrows to one
                    # request.
                    self._json(200, server.debug_traces_raw(
                        limit=limit,
                        trace_id=q.get("trace_id", [None])[0] or None,
                        include_stores=(q.get("stores", ["0"])[0]
                                        not in ("0", "")),
                    ))
                    return
                data = server.debug_traces_json(limit=limit).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path.startswith("/debug/trace/"):
                # ONE request's stitched timeline by trace id (local
                # ring + attached store rings, clock-mapped)
                tid = self.path[len("/debug/trace/"):].split("?", 1)[0]
                if not tid:
                    self._json(400, {"error": "trace id required"})
                    return
                data = server.debug_trace_json(tid).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path.split("?", 1)[0] == "/debug/faults":
                # arm/clear serve-plane fault rules (chaos only; never
                # itself fault-matched — see _fault_gate).  Body: a rule
                # list, {"rules": [...]}, or {"scenario": name} for a
                # canned set (the store manage plane's idiom) — e.g.
                # {"scenario": "decode_death_mid_stream"}.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"[]")
                    if isinstance(body, dict) and body.get("scenario"):
                        armed = server.faults.arm_scenario(
                            str(body["scenario"]))
                    else:
                        rules = body.get("rules", []) \
                            if isinstance(body, dict) else body
                        armed = server.faults.arm(rules)
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"armed": armed})
                return
            if self.path.split("?", 1)[0] == "/debug/cluster":
                # live membership control: join/drain one store node
                # with background migration of its ~1/N key range while
                # serving ({"action": "join"|"drain", "endpoint":
                # "host:port"}).  Never fault-gated — it IS the ops
                # plane operators use while chaos rules are armed.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._json(400, {"error": "invalid JSON body"})
                    return
                pool = getattr(server.engine.transfer, "pool", None)
                if pool is None:
                    self._json(400, {"error": "store is not clustered "
                                              "(no RoutedStorePool)"})
                    return
                action = body.get("action")
                endpoint = body.get("endpoint") or ""
                try:
                    if action == "join":
                        pool.join_node(endpoint)
                    elif action == "drain":
                        pool.drain_node(endpoint)
                    else:
                        self._json(400, {"error": "action must be "
                                                  "join or drain"})
                        return
                except (ValueError, RuntimeError) as e:
                    self._json(409, {"error": str(e)})
                    return
                self._json(200, server.cluster_report())
                return
            if not self._fault_gate():
                return
            if self.path not in ("/v1/completions", "/v1/chat/completions",
                                 "/v1/prefill"):
                self._json(404, {"error": "not found"})
                return
            # request-scoped trace on the handler thread: covers prep,
            # submit, and the wait/stream phases.  Engine-thread compute
            # shows up in the per-step "engine.step" traces next to it in
            # /debug/traces (same ring, own trace ids).  An X-Istpu-Trace
            # header CONTINUES the caller's trace (the fleet front door
            # propagates one id through prefill handoff, store push, and
            # decode adoption — the stitched single-trace contract).
            tid = self.headers.get("X-Istpu-Trace") or None
            with tracing.TRACER.trace("http.request", trace_id=tid,
                                      path=self.path):
                if self.path == "/v1/prefill":
                    self._handle_prefill()
                else:
                    self._handle_completions()

        def _handle_completions(self):
            chat = self.path == "/v1/chat/completions"
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                self._json(400, {"error": "invalid JSON body"})
                return
            if isinstance(body, dict):
                # internal endpoint marker; a wire body must not spoof it
                # (it would cross-wire the two endpoints' validation)
                body.pop("_chat", None)
            try:
                # tokenization-heavy prep on THIS thread, not the engine's
                # (the raw string survives for echo: decode(encode(s)) may
                # add special tokens the client never sent)
                raw_prompt = body.get("prompt")
                body = server.prepare_body(body, chat)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            n = body.get("n", 1)
            if not (isinstance(n, int) and not isinstance(n, bool)
                    and 1 <= n <= 8):
                self._json(400, {"error": "n must be an integer in [1, 8]"})
                return
            # mid-stream resumption (router re-dispatch after a decode
            # death; docs/design.md resumption contract): the resume
            # headers carry the client's emitted-count watermark, the
            # store checkpoint (when one landed) carries the generated-
            # so-far tokens and the effective sampling seed.  Wire
            # bodies must never spoof the pre-seed — only what THIS
            # handler fetched from the store is injected.
            body.pop("_resume_output", None)
            resume_wm = 0
            if self.headers.get("X-Istpu-Resume"):
                if n != 1 or server.logprobs_display_k(body, chat) is not None:
                    self._json(409, {"error": "stream resumption supports "
                                              "single-choice requests "
                                              "without logprobs"})
                    return
                try:
                    resume_wm = max(0, int(self.headers.get(
                        "X-Istpu-Resume-Watermark", "0") or 0))
                except ValueError:
                    resume_wm = 0
                ckpt = server.resume_fetch(tracing.current_trace_id())
                if ckpt is not None:
                    if (body.get("seed") is None
                            and ckpt.get("seed") is not None):
                        body["seed"] = ckpt["seed"]
                    body["_resume_output"] = list(ckpt.get("output") or [])
            # n choices = n scheduler requests sharing the prompt (the
            # prefix cache pins one set of prompt pages; each choice
            # decodes its own continuation — the vLLM n>1 model).  A
            # VALID seeded request derives choice i's seed as seed+i (else
            # all n choices would sample identical continuations); an
            # invalid seed passes through untouched so _validate rejects
            # it instead of this derivation accidentally laundering it
            # into range.
            seed = body.get("seed")
            derive = n > 1 and _valid_seed(seed)
            qs = [
                server.submit(
                    {**body, "seed": (seed + i) % (2 ** 31)} if derive
                    else body
                )
                for i in range(n)
            ]
            req_ids, err, busy, fault, shed = [], None, None, None, None
            aborted = None
            for q in qs:
                kind, val = q.get()
                if kind == "error":
                    err = val
                elif kind == "fault":
                    # a runtime failure (e.g. the scoring forward), not a
                    # bad request: server-error class
                    fault = val
                elif kind == "busy":
                    busy = val
                elif kind == "shed":
                    # the admission controller refused it (quota /
                    # shed-on-burn): 429 + Retry-After below
                    shed = val
                elif kind == "abort":
                    # the server is restarting: drop the connection with
                    # no status at all so the caller (router _proxy_one)
                    # treats it as transport death and fails over
                    aborted = val
                else:
                    req_ids.append(val)
            if aborted is not None:
                for rid in req_ids:
                    server.cancel(rid)
                try:
                    self.connection.close()
                except OSError:
                    pass
                return
            if (err is not None or busy is not None or fault is not None
                    or shed is not None):
                for rid in req_ids:
                    server.cancel(rid)
                if shed is not None:
                    ra = _retry_after_header(shed.get("retry_after_s"))
                    self._json(
                        429,
                        {"error": shed["error"],
                         "reason": shed.get("reason"),
                         "retry_after_s": shed.get("retry_after_s")},
                        headers={"Retry-After": ra} if ra else None,
                    )
                elif busy is not None:
                    self._json(429, {"error": busy})
                elif fault is not None:
                    self._json(500, {"error": fault})
                else:
                    self._json(400, {"error": err})
                return
            # adapter-routed requests echo the adapter name they asked for
            model_name = str(body.get("model") or server.model_id)
            accums: List[Optional[_TextAccum]] = [None] * n
            if server.tokenizer is not None:
                stop = body.get("stop") or []
                stop = [stop] if isinstance(stop, str) else stop
                accums = [_TextAccum(server.tokenizer, stop)
                          for _ in range(n)]
            lp_k = server.logprobs_display_k(body, chat)
            prompt_len = len(body["prompt"])
            # OpenAI legacy `echo`: completions prepend the prompt to each
            # choice (ids always; text when a tokenizer is attached)
            echo_ids: Optional[List[int]] = None
            echo_text = ""
            if body.get("echo") and not chat:
                echo_ids = list(body["prompt"])
                if isinstance(raw_prompt, str):
                    echo_text = raw_prompt  # verbatim, per the contract
                elif server.tokenizer is not None:
                    echo_text = server.tokenizer.decode(echo_ids)
            if body.get("stream"):
                # resume-checkpoint template: n==1 streams on a store-
                # backed worker checkpoint their progress on the cadence
                # (the output list starts EMPTY — a restore's pre-seed is
                # re-delivered through on_token and re-accumulates here)
                ck = None
                if (n == 1 and server.resume_every > 0
                        and server.engine.transfer is not None):
                    ck = {"v": 1, "trace_id": tracing.current_trace_id(),
                          "session": body.get("session"),
                          "prompt_len": prompt_len,
                          "seed": body.get("seed"),
                          "output": []}
                self._stream(req_ids, qs, accums, chat, model_name,
                             prompt_len, lp_k, echo_ids, echo_text,
                             suppress=resume_wm, ck=ck)
            else:
                self._collect(req_ids, qs, accums, chat, model_name,
                              prompt_len, lp_k, echo_ids, echo_text)

        def _handle_prefill(self):
            """PD handoff, prefill side (docs/design.md §disaggregation):
            ingest the prompt through the STANDARD scheduler path —
            admission verdicts, chunked prefill interleaving, ledger,
            metrics all apply — while the prefill streams KV to the
            store chunk by chunk, then run the store_flush durability
            barrier before answering, so the pushed prefix is visible to
            ``get_match_last_index`` on the decode pool the moment the
            router dispatches decode.  Generates ONE throwaway token
            (the cheapest way to ride the scheduler end to end; the
            client's tokens come from the decode pool)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                self._json(400, {"error": "invalid JSON body"})
                return
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return
            body.pop("_chat", None)
            try:
                body = server.prepare_body(body, "messages" in body)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            prompt = body.get("prompt") or []
            # strip generation-shaping params that don't apply to a
            # handoff (echo would reroute through the scoring path);
            # priority/model stay — lanes and adapter namespaces matter
            for k in ("echo", "logprobs", "top_logprobs", "stream", "n",
                      "stop", "stop_token_ids"):
                body.pop(k, None)
            body.update(max_tokens=1, temperature=0)
            q = server.submit(body)
            req_id = None
            while True:
                try:
                    kind, val = q.get(timeout=1.0)
                except queue.Empty:
                    if self._client_gone():
                        # router gave up (leg timeout / died): free the
                        # slot; already-pushed chunks stay — they are
                        # content-addressed future hits, not leaks
                        if req_id is not None:
                            server.cancel(req_id)
                        return
                    continue
                if kind == "id":
                    req_id = val
                elif kind == "busy":
                    self._json(429, {"error": val})
                    return
                elif kind == "shed":
                    ra = _retry_after_header(val.get("retry_after_s"))
                    self._json(
                        429,
                        {"error": val["error"], "reason": val.get("reason"),
                         "retry_after_s": val.get("retry_after_s")},
                        headers={"Retry-After": ra} if ra else None,
                    )
                    return
                elif kind == "error":
                    self._json(400, {"error": val})
                    return
                elif kind == "fault":
                    self._json(500, {"error": val})
                    return
                elif kind == "abort":
                    # restart in progress: no status — the router's
                    # prefill_handoff records "failed" and decode
                    # recomputes, never a client-visible error
                    if req_id is not None:
                        server.cancel(req_id)
                    try:
                        self.connection.close()
                    except OSError:
                        pass
                    return
                elif kind == "done":
                    break
                # "tokens"/"lp" events: dropped — decode is not our job
            flushed = False
            flush_error = None
            if server.engine.transfer is not None:
                t_flush = time.perf_counter()
                try:
                    # the durability barrier of the handoff contract
                    # (relaxed-mode pushes drain here) — scoped to THIS
                    # request's pushes by its trace id (the marker the
                    # streamer tagged each submit with), so concurrent
                    # handoffs never wait on each other's queue tails
                    with tracing.span("engine.store_flush"):
                        server.engine.store_flush(
                            marker=tracing.current_trace_id()
                        )
                    flushed = True
                except Exception as e:  # noqa: BLE001 — degrade, don't 500:
                    # the router falls back to recompute-on-decode
                    flush_error = repr(e)
                # the flush barrier runs AFTER the request retired, so
                # its cost is annotated into the stage ledger row by
                # trace id (kv_flush: the handoff's TTFT share the
                # waterfall cannot see)
                server.critpath.annotate(
                    tracing.current_trace_id(), "kv_flush",
                    time.perf_counter() - t_flush,
                )
            T = server.engine.pc.block_tokens
            out = {
                "object": "prefill", "model_id": server.model_id,
                "role": server.role, "prompt_tokens": len(prompt),
                # complete chunks a decode worker can discover; its own
                # prefill re-probes (and caps reuse at (S-1)//T)
                "chunks": len(prompt) // T, "block_tokens": T,
                "store": server.engine.transfer is not None,
                "flushed": flushed,
            }
            if flush_error is not None:
                out["flush_error"] = flush_error
            self._json(200, out)

        def _client_gone(self) -> bool:
            """A request-less peek at the socket: readable + EOF means the
            client hung up (it sent nothing further on this connection).
            selectors (epoll on Linux) rather than select.select — the
            latter raises ValueError on fds >= FD_SETSIZE, which a large
            session fleet reaches."""
            import selectors
            import socket as socketlib

            try:
                sel = selectors.DefaultSelector()
                try:
                    sel.register(self.connection, selectors.EVENT_READ)
                    if not sel.select(0):
                        return False
                finally:
                    sel.close()
                return self.connection.recv(1, socketlib.MSG_PEEK) == b""
            except (OSError, ValueError):
                return True

        def _collect(self, req_ids: List[int], qs: List["queue.Queue"],
                     accums: List[Optional[_TextAccum]], chat: bool,
                     model_name: Optional[str], prompt_len: int,
                     lp_k: Optional[int],
                     echo_ids: Optional[List[int]] = None,
                     echo_text: str = "") -> None:
            choices: List[Dict[str, Any]] = []
            for i, (req_id, q, accum) in enumerate(zip(req_ids, qs, accums)):
                tokens: List[int] = []
                lps: List[tuple] = []
                prompt_lps: List[tuple] = []
                finish = "stop"
                while True:
                    try:
                        kind, val = q.get(timeout=1.0)
                    except queue.Empty:
                        if self._client_gone():
                            # nobody is waiting: free every batch slot
                            for rid in req_ids:
                                server.cancel(rid)
                            return
                        continue
                    if kind == "prompt_lp":
                        prompt_lps = val
                    elif kind == "lp":
                        lps.extend(val)
                    elif kind == "tokens":
                        tokens.extend(val)
                        if accum is not None and accum.add(val)[1]:
                            # stop string hit: end generation NOW (free the
                            # batch slot) instead of decoding to the budget
                            server.cancel(req_id)
                            break
                    elif kind == "abort":
                        # restart in progress: drop with no status so the
                        # router fails this attempt over to a survivor
                        for rid in req_ids:
                            server.cancel(rid)
                        try:
                            self.connection.close()
                        except OSError:
                            pass
                        return
                    elif kind in ("error", "fault"):
                        for rid in req_ids:
                            server.cancel(rid)
                        self._json(500, {"error": val})
                        return
                    elif kind == "done":
                        finish = val
                        break
                choice: Dict[str, Any] = {
                    "index": i, "token_ids": tokens, "finish_reason": finish,
                }
                if accum is not None:
                    accum.finish()
                    choice["text"] = accum.text
                    # ids, text, and usage agree: all truncated at the stop
                    choice["token_ids"] = tokens = accum.visible_ids()
                    if accum.stop_cut is not None:
                        # a stop that only completed inside the held-back
                        # tail (found at finish) is still a stop
                        choice["finish_reason"] = "stop"
                if lp_k is not None:
                    payload = _lp_payload(
                        server, tokens, lps[:len(tokens)], lp_k, chat
                    )
                    if echo_ids is not None and not chat:
                        # echo+logprobs scoring: the prompt's own records
                        # prepend (first position has no distribution)
                        head = _prompt_lp_payload(
                            server, echo_ids, prompt_lps, lp_k
                        )
                        payload = {
                            kk: head[kk] + payload[kk] for kk in head
                        }
                    choice["logprobs"] = payload
                if chat:  # chat requires a tokenizer, so accum is set
                    choice["message"] = {
                        "role": "assistant",
                        "content": choice.pop("text", ""),
                    }
                choices.append(choice)
            completion_tokens = sum(len(c["token_ids"]) for c in choices)
            if echo_ids is not None:
                # prepend AFTER usage accounting: echo changes the payload,
                # not what was generated
                for c in choices:
                    c["token_ids"] = echo_ids + c["token_ids"]
                    if "text" in c:
                        c["text"] = echo_text + c["text"]
            try:
                self._json(200, {
                    "id": f"{'chatcmpl' if chat else 'cmpl'}-{req_ids[0]}",
                    "object": "chat.completion" if chat else "text_completion",
                    "model": model_name or server.model_id,
                    "choices": choices,
                    "usage": {
                        "prompt_tokens": prompt_len,
                        "completion_tokens": completion_tokens,
                        "total_tokens": prompt_len + completion_tokens,
                    },
                })
            except (BrokenPipeError, ConnectionResetError):
                pass  # finished anyway; nothing left to free

        def _stream(self, req_ids: List[int], qs: List["queue.Queue"],
                    accums: List[Optional[_TextAccum]], chat: bool,
                    model_name: Optional[str], prompt_len: int,
                    lp_k: Optional[int],
                    echo_ids: Optional[List[int]] = None,
                    echo_text: str = "",
                    suppress: int = 0,
                    ck: Optional[Dict[str, Any]] = None) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            n = len(req_ids)
            first_delta = [True] * n
            ids_sent = [0] * n
            lps: List[List[tuple]] = [[] for _ in range(n)]
            live = [True] * n
            # resumption state: tokens still to drop below the client's
            # emitted-count watermark (per choice), and the emitted count
            # the last staged checkpoint covered
            sup_left = [max(0, int(suppress))] * n
            ck_mark = [0]

            # n>1: one SSE stream carries every choice; per-queue pump
            # threads merge the scheduler's per-request queues into one,
            # tagged with the choice index (events within a choice keep
            # their order; choices interleave as they decode)
            if n == 1:
                merged = None
            else:
                merged = queue.Queue()

                def pump(i: int, qi: "queue.Queue") -> None:
                    while True:
                        ev = qi.get()
                        merged.put((i, ev))
                        if ev[0] in ("done", "error", "fault", "abort"):
                            return

                for i, qi in enumerate(qs):
                    threading.Thread(target=pump, args=(i, qi),
                                     daemon=True).start()

            def next_event():
                if merged is None:
                    return 0, qs[0].get()
                return merged.get()

            def emit(i: int, token_ids: List[int], text: Optional[str],
                     finish: Optional[str] = None) -> None:
                choice: Dict[str, Any] = {
                    "index": i, "token_ids": token_ids,
                    "finish_reason": finish,
                }
                if lp_k is not None:
                    lo = ids_sent[i]
                    choice["logprobs"] = _lp_payload(
                        server, token_ids,
                        lps[i][lo:lo + len(token_ids)], lp_k, chat,
                    )
                if chat:
                    delta: Dict[str, Any] = {"content": text or ""}
                    if first_delta[i]:
                        delta["role"] = "assistant"
                        first_delta[i] = False
                    choice["delta"] = delta
                elif text is not None:
                    choice["text"] = text
                chunk = json.dumps({
                    "id": f"{'chatcmpl' if chat else 'cmpl'}-{req_ids[0]}",
                    "object": (
                        "chat.completion.chunk" if chat else "text_completion"
                    ),
                    "model": model_name or server.model_id,
                    "choices": [choice],
                })
                self.wfile.write(f"data: {chunk}\n\n".encode())
                self.wfile.flush()

            def finish_choice(i: int) -> bool:
                """Mark choice ``i`` done; True when ALL choices ended."""
                live[i] = False
                return not any(live)

            def done() -> None:
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()

            def emit_echo(i: int, prompt_lps=None) -> None:
                """The prompt as choice i's first chunk (OpenAI echo);
                with scoring (echo+logprobs) it carries the prompt's own
                logprob records."""
                choice: Dict[str, Any] = {
                    "index": i, "token_ids": list(echo_ids),
                    "finish_reason": None,
                }
                if accums[i] is not None:
                    choice["text"] = echo_text
                if prompt_lps is not None:
                    choice["logprobs"] = _prompt_lp_payload(
                        server, echo_ids, prompt_lps, lp_k
                    )
                chunk = json.dumps({
                    "id": f"cmpl-{req_ids[0]}",
                    "object": "text_completion",
                    "model": model_name or server.model_id,
                    "choices": [choice],
                })
                self.wfile.write(f"data: {chunk}\n\n".encode())
                self.wfile.flush()

            try:
                if echo_ids is not None and lp_k is None:
                    # plain echo: the prompt chunks go out immediately.
                    # (echo+logprobs instead waits for each choice's
                    # "prompt_lp" event, which precedes its token events.)
                    # Inside the try — a client that disconnects during
                    # the echo write must still have its requests
                    # cancelled.
                    for i in range(n):
                        emit_echo(i)
                while True:
                    i, (kind, val) = next_event()
                    if not live[i]:
                        # a stop-cancelled choice stays subscribed until the
                        # scheduler retires it; its trailing tokens/done
                        # events must not re-emit a terminal chunk
                        continue
                    accum = accums[i]
                    if kind == "prompt_lp":
                        if echo_ids is not None:
                            emit_echo(i, prompt_lps=val)
                    elif kind == "lp":
                        lps[i].extend(val)
                    elif kind == "tokens":
                        if not self._stream_fault():
                            # injected mid-stream death (the worker-side
                            # view of a decode-process kill): free the
                            # batch slots like a client disconnect; the
                            # router's resume path owns the client now
                            for rid in req_ids:
                                server.cancel(rid)
                            return
                        if ck is not None:
                            # checkpoint cadence: stage a write once the
                            # emitted count crossed resume_every since
                            # the last one (the writer thread owns the
                            # store hop; this thread only copies a list)
                            ck["output"].extend(val)
                            if (len(ck["output"]) - ck_mark[0]
                                    >= server.resume_every):
                                server.resume_stage({
                                    **ck, "output": list(ck["output"]),
                                    "_delta": len(ck["output"]) - ck_mark[0],
                                })
                                ck_mark[0] = len(ck["output"])
                        if sup_left[i]:
                            # watermark suppression (resumption contract):
                            # everything below the client's emitted-count
                            # watermark was already delivered by the died
                            # worker — drop the replay so the spliced
                            # stream carries no duplicate tokens
                            skip = min(sup_left[i], len(val))
                            sup_left[i] -= skip
                            val = val[skip:]
                            if not val:
                                continue
                        if accum is None:
                            emit(i, val, None)
                            ids_sent[i] += len(val)
                            continue
                        delta, stopped = accum.add(val)
                        if stopped:
                            # stop string hit mid-stream: final event for
                            # THIS choice carries the pre-stop text, the
                            # remaining stop-truncated ids and the
                            # finish_reason; the batch slot frees now
                            emit(i, accum.visible_ids()[ids_sent[i]:],
                                 delta, finish="stop")
                            server.cancel(req_ids[i])
                            if finish_choice(i):
                                done()
                                return
                            continue
                        # ids (and their lp records) ride the text release
                        # horizon: held-back ids can never pass a stop cut
                        # that only completes later
                        horizon = accum.emit_ids_horizon()
                        if horizon > ids_sent[i] or delta:
                            emit(i, accum.ids[ids_sent[i]:horizon], delta)
                            ids_sent[i] = horizon
                    elif kind == "abort":
                        # restart in progress: kill the socket mid-stream
                        # WITHOUT an SSE error or [DONE] — the relaying
                        # router sees EOF-before-[DONE] (transport death)
                        # and resumes the stream on a survivor, so the
                        # client sees a stall, never an error
                        for rid in req_ids:
                            server.cancel(rid)
                        try:
                            self.connection.close()
                        except OSError:
                            pass
                        return
                    elif kind in ("error", "fault"):
                        # a post-submit failure (e.g. the scoring forward)
                        # must not orphan already-admitted requests
                        for rid in req_ids:
                            server.cancel(rid)
                        err = json.dumps({"error": val})
                        self.wfile.write(f"data: {err}\n\n".encode())
                        done()
                        return
                    elif kind == "done":
                        tail = accum.finish() if accum is not None else ""
                        fin = val
                        last_ids: List[int] = []
                        if accum is not None:
                            if accum.stop_cut is not None:
                                fin = "stop"
                            # flush the withheld tail ids (stop-truncated
                            # when a stop was found at finish)
                            last_ids = accum.visible_ids()[ids_sent[i]:]
                        emit(i, last_ids, tail or None, finish=fin)
                        if finish_choice(i):
                            done()
                            return
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream: free every choice's pages at
                # the next chunk boundary; batchmates keep decoding
                for rid in req_ids:
                    server.cancel(rid)

    return Handler


# safetensors dtype tags -> torch dtypes (the format's own names)
_ST_DTYPES = {
    "F64": "float64", "F32": "float32", "F16": "float16", "BF16": "bfloat16",
    "I64": "int64", "I32": "int32", "I16": "int16", "I8": "int8",
    "U8": "uint8", "BOOL": "bool",
}


def _read_safetensors(path: str, device) -> Dict[str, Any]:
    """One ``.safetensors`` file as {name: tensor on ``device``}: the file
    is mapped, not read whole, and each tensor is copied once, straight to
    ``device`` (the format: an 8-byte little-endian header length, a JSON
    header of dtype / shape / byte offsets, then the raw bytes)."""
    import torch

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = torch.from_file(path, size=os.path.getsize(path),
                           dtype=torch.uint8)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = getattr(torch, _ST_DTYPES[meta["dtype"]])
        lo, hi = (8 + n + o for o in meta["data_offsets"])
        raw = data[lo:hi]
        if lo % dtype.itemsize:
            raw = raw.clone()  # a reinterpreting view needs alignment
        out[name] = raw.view(dtype).reshape(meta["shape"]).to(device)
    return out


def _is_moe_dir(name: str) -> bool:
    """Whether ``name`` is a checkpoint directory of the MoE family."""
    path = os.path.join(name, "config.json")
    if name == "tiny" or not os.path.isfile(path):
        return False
    with open(path) as f:
        return json.load(f).get("model_type") == "mixtral"


def load_model(name: str, device, seed: int = 0, tp_rank: int = 0,
               tp: int = 1, pp_rank: int = 0, pp: int = 1):
    """The counterpart of the reference ``serve.main``'s ``load_model``:
    ``(cfg, params, engine_fns)`` on ``device``, ``engine_fns`` routing a
    Mixtral checkpoint through the MoE forwards.

    ``"tiny"`` is TINY with random weights drawn from ``seed``.  Anything
    else is a local HF checkpoint directory: its ``config.json``, read as
    it stands (no ``transformers``: the result does not depend on which
    version, if any, is installed), and its ``*.safetensors`` weights
    (``save_pretrained``'s format), each tensor copied straight to
    ``device`` and imported there by ``models.hf`` in the config's
    default dtype (bf16), freed from the state dict as it is stacked.

    ``tp_rank``/``tp``, ``pp_rank``/``pp``: only that rank's shard of a
    dense model reaches ``device`` (its stage's layers, its tensor-parallel
    slice of each; a checkpoint is read into host memory, sliced a layer
    at a time over tp and by stage over pp)."""
    import glob
    import types

    import torch

    from .models import TINY, init_params

    if name == "tiny":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return TINY, init_params(TINY, gen, device, tp_rank=tp_rank, tp=tp,
                                 pp_rank=pp_rank, pp=pp), {}
    if not os.path.isfile(os.path.join(name, "config.json")):
        raise SystemExit(f"{name!r} is neither 'tiny' nor a checkpoint "
                         f"directory holding a config.json")
    with open(os.path.join(name, "config.json")) as f:
        hf_config = types.SimpleNamespace(**json.load(f))
    state: Dict[str, Any] = {}
    sharded = tp * pp > 1
    for path in sorted(glob.glob(os.path.join(name, "*.safetensors"))):
        state.update(_read_safetensors(path, "cpu" if sharded else device))
    if not state:
        raise SystemExit(f"no *.safetensors weights in {name!r}")
    from .models import hf

    if getattr(hf_config, "model_type", "") == "mixtral":
        from .models import (moe_decode_forward, moe_prefill_forward,
                             moe_verify_forward)

        mcfg = hf.moe_config_from_hf(hf_config)
        return mcfg, hf.moe_params_from_hf(state, mcfg, consume=True), {
            "prefill_fn": moe_prefill_forward,
            "decode_fn": moe_decode_forward,
            "verify_fn": moe_verify_forward,
        }
    from .parallel.sharding import llama_inference_specs, shard_tree

    cfg = hf.config_from_hf(hf_config)
    params = hf.params_from_hf(state, cfg, consume=True, tp_rank=tp_rank,
                               tp=tp)
    return cfg, shard_tree(params, llama_inference_specs(params), 0, 1,
                           pp_rank, pp, lambda x, _n: x.to(device)), {}


def _rank_device(device: str, rank: int):
    """Rank ``rank``'s device: ``cuda:(rank % cards)``, or the CPU."""
    import torch

    from . import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _dense_config(name: str):
    """The dense config ``name`` (``"tiny"`` or a checkpoint directory)
    names, read without its weights; None for the MoE family."""
    import types

    from .models import TINY

    if name == "tiny":
        return TINY
    if _is_moe_dir(name) or not os.path.isfile(
            os.path.join(name, "config.json")):
        return None
    from .models import hf

    with open(os.path.join(name, "config.json")) as f:
        return hf.config_from_hf(types.SimpleNamespace(**json.load(f)))


def tp_engine(spec: Dict[str, Any], rank: int, conn=None):
    """Rank ``rank``'s engine of the serving group ``spec`` describes
    (``serve --tp/--pp``): joins the group, builds the ``(pp, tp)`` mesh,
    loads the rank's shard of the model (its stage's layers, its heads)
    and builds its engine, every rank with the same arguments.  ``conn``
    (the store) on rank 0 only."""
    from .engine import InferenceEngine
    from .kv import PagedCacheConfig
    from .parallel import MeshShape, initialize, make_mesh

    device = _rank_device(spec["device"], rank)
    tp, pp = spec["tp"], spec.get("pp", 1)
    initialize(init_method=spec["init_method"], world_size=tp * pp,
               rank=rank, backend=spec["backend"])
    mesh = make_mesh(MeshShape(pp=pp, tp=tp))
    cfg, params, _ = load_model(spec["model"], device, seed=spec["seed"],
                                tp_rank=mesh.get_local_rank("tp"), tp=tp,
                                pp_rank=mesh.get_local_rank("pp"), pp=pp)
    pc = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=spec["n_blocks"],
        block_tokens=spec["block_tokens"], dtype=cfg.dtype,
    )
    return InferenceEngine(params, cfg, pc, conn=conn, mesh=mesh,
                           device=device, **spec["engine"])


def tp_follower(spec: Dict[str, Any], rank: int) -> None:
    """A ``serve --tp/--pp`` follower process: its engine follows rank
    0's ops until rank 0 shuts the group down (or dies, which makes it
    raise)."""
    tp_engine(spec, rank).follow()


def spawn_followers(spec: Dict[str, Any]) -> list:
    """Start ranks 1.. of ``spec``'s ``tp x pp`` group
    (``torch.multiprocessing``, start method ``spawn``), each running
    ``tp_follower``."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=tp_follower, args=(spec, r), daemon=True,
                         name=f"istpu-tp-rank{r}")
             for r in range(1, spec["tp"] * spec.get("pp", 1))]
    for p in procs:
        p.start()
    return procs


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    # `--role router` is the front door, a different program entirely
    # (no engine, no checkpoint): delegate before this parser rejects
    # the router's own flags
    for i, a in enumerate(argv):
        if (a == "--role" and i + 1 < len(argv)
                and argv[i + 1] == "router"):
            from . import frontdoor

            return frontdoor.main(argv[:i] + argv[i + 2:])
        if a == "--role=router":
            from . import frontdoor

            return frontdoor.main(argv[:i] + argv[i + 1:])

    ap = argparse.ArgumentParser("infinistore_tpu_torch.serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--role",
                    choices=["monolith", "prefill", "decode", "router"],
                    default="monolith",
                    help="fleet role: monolith serves everything; "
                         "prefill/decode label this worker for a "
                         "disaggregated fleet (every endpoint stays live "
                         "on every role); router runs the front door "
                         "(frontdoor.py) over --prefill-workers / "
                         "--decode-workers instead of an engine")
    ap.add_argument("--model", default="tiny",
                    help="'tiny' (random-init demo) or a local HF "
                         "checkpoint dir (Llama, Mistral, Qwen2/3, Gemma-2, "
                         "Mixtral)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on: 'cuda' (the "
                         "hand-written kernels, CUDA-graph decode) or "
                         "'cpu' (their plain PyTorch versions)")
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer dir enabling text prompts and "
                         "responses (imports transformers; default: the "
                         "--model checkpoint dir)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission cap: more than this many requests in "
                         "the system answers 429 instead of queueing "
                         "without bound")
    ap.add_argument("--quota", action="append", default=[],
                    dest="quotas", metavar="TENANT:TOKS_PER_S[:BURST_S]",
                    help="per-tenant token-rate quota (the priority-lane "
                         "label is the tenant axis), repeatable / comma "
                         "lists accepted.  Default env ISTPU_QUOTAS; "
                         "ISTPU_ADMISSION=0 disables the whole admission "
                         "controller")
    ap.add_argument("--n-blocks", type=int, default=512)
    ap.add_argument("--block-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefill-concurrency", type=int, default=4,
                    help="newcomers ingesting one prompt chunk each per "
                         "scheduler step, interleaved with decode")
    ap.add_argument("--decode-chunk", type=int, default=32,
                    help="decode steps per host sync (graph replays per "
                         "sync on the card)")
    ap.add_argument("--draft-model", default=None,
                    help="'tiny' or a checkpoint dir for a draft model "
                         "(same vocab as --model): turns on speculative "
                         "decoding as the scheduler's batch=1 fast path")
    ap.add_argument("--draft-n-blocks", type=int, default=None,
                    help="draft KV pages (default: --n-blocks)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--spec-batch", type=int, default=1,
                    help="speculate with up to this many concurrent "
                    "requests in lockstep (batched fused rounds); 1 = the "
                    "latency-bound fast path only")
    ap.add_argument("--ngram-spec", action="store_true",
                    help="model-free speculative decoding: proposals from "
                         "the device-side n-gram prompt-lookup matcher "
                         "(no draft model; greedy requests only; pays on "
                         "repetitive text). Mutually exclusive with "
                         "--draft-model")
    ap.add_argument("--spec-g", type=int, default=2,
                    help="n-gram match width for --ngram-spec")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: serve on this many ranks "
                         "(Megatron-sharded weights, head-sharded paged "
                         "cache); this process is rank 0 and starts the "
                         "others")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default="nccl",
                    help="the --tp/--pp ranks' collectives: nccl (one card "
                         "per rank, CUDA graphs capture the collectives) or "
                         "gloo (on the host: ranks may share a card, or run "
                         "on the CPU; graph bodies run eagerly)")
    ap.add_argument("--pp", type=int, default=1,
                    help="layer-sharding degree: each of this many stages "
                         "holds n_layers/pp of the layers (and their paged "
                         "cache) and hands its hidden state to the next; "
                         "with --tp the group has tp x pp ranks")
    ap.add_argument("--store-host", default=None,
                    help="attach an InfiniStore KV store at this host "
                         "(requires --store-service-port)")
    ap.add_argument("--store-service-port", type=int, default=None)
    ap.add_argument("--store-endpoints", default=None,
                    help="store CLUSTER membership: comma-separated "
                         "host:port list (or env ISTPU_STORE_ENDPOINTS). "
                         "Two or more endpoints shard the KV store over a "
                         "consistent-hash ring with per-node circuit "
                         "breakers and hot-prefix replication "
                         "(/debug/cluster shows the ring); exactly one "
                         "endpoint takes the classic single-connection "
                         "path.  Mutually exclusive with --store-host")
    ap.add_argument("--store-replicas", type=int, default=None,
                    help="total copies of a HOT chunk across the ring "
                         "(owner + successors; default env "
                         "ISTPU_CLUSTER_REPLICAS, else 2).  1 disables "
                         "replication")
    ap.add_argument("--store-op-timeout", type=float, default=30.0,
                    help="per-op deadline (s) on the store connection; "
                         "0 = unbounded")
    ap.add_argument("--store-connection", choices=["tcp", "shm"],
                    default="shm",
                    help="shm = zero-copy, same host; tcp = cross-host")
    ap.add_argument("--kv-quant", choices=["int8", "none"], default="int8",
                    help="store-hop page format (int8 halves the bytes; "
                         "'none' = lossless)")
    ap.add_argument("--store-durability", choices=["strict", "relaxed"],
                    default="relaxed",
                    help="relaxed (default): prefill returns when pages are "
                         "queued; strict: every page durable before "
                         "prefill returns")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="TTFT SLO target in seconds (default env "
                         "ISTPU_SLO_TTFT_S, else 2.0)")
    ap.add_argument("--slo-tpot", type=float, default=None,
                    help="TPOT SLO target in seconds (default env "
                         "ISTPU_SLO_TPOT_S, else 0.25)")
    ap.add_argument("--ledger-ring", type=int, default=None,
                    help="request-ledger ring capacity for /debug/requests")
    ap.add_argument("--session-ring", type=int, default=None,
                    help="session-ledger LRU capacity for /debug/sessions")
    ap.add_argument("--store-manage-endpoints", default=None,
                    help="store MANAGE-plane endpoints (host:manage_port, "
                         "comma-separated; default env "
                         "ISTPU_STORE_MANAGE_ENDPOINTS) for the "
                         "/debug/health cluster rollup")
    ap.add_argument("--log-level", default="info")
    args = ap.parse_args(argv)
    Logger.set_log_level(args.log_level)

    if args.tp < 1 or args.pp < 1:
        raise SystemExit("--tp and --pp must be >= 1")
    world = args.tp * args.pp
    if world > 1:
        # reject BEFORE building anything: mesh serving covers the
        # built-in dense families, whose layers and KV heads divide
        cfg0 = _dense_config(args.model)
        if cfg0 is None:
            raise SystemExit("--tp/--pp mesh serving supports the built-in "
                             "dense families")
        if cfg0.n_layers % args.pp:
            raise SystemExit(f"n_layers={cfg0.n_layers} must divide over "
                             f"--pp {args.pp}")
        if cfg0.n_kv_heads % args.tp:
            raise SystemExit(f"n_kv_heads={cfg0.n_kv_heads} must divide "
                             f"over --tp {args.tp}")
        if args.device.startswith("cuda"):
            import torch

            if not torch.cuda.is_available():
                raise SystemExit("--device cuda but no CUDA device")
            cards = torch.cuda.device_count()
            if args.dist_backend == "nccl" and world > cards:
                raise SystemExit(
                    f"--tp {args.tp} x --pp {args.pp} over nccl needs a card "
                    f"per rank, have {cards} (--dist-backend gloo lets ranks "
                    f"share one)")
        elif args.dist_backend == "nccl":
            raise SystemExit("--dist-backend nccl runs on CUDA devices; "
                             "--device cpu takes --dist-backend gloo")
    endpoints_spec = args.store_endpoints or os.environ.get(
        "ISTPU_STORE_ENDPOINTS"
    )
    if endpoints_spec and args.store_host is not None:
        raise SystemExit("--store-endpoints and --store-host are mutually "
                         "exclusive")
    endpoints = []
    if endpoints_spec:
        from .cluster import parse_endpoints

        endpoints = parse_endpoints(endpoints_spec)
        if len(endpoints) == 1:
            # exactly one endpoint is NOT a cluster: collapse to the
            # classic single-connection path (no ring, no routing
            # overhead — byte-identical to --store-host)
            host, _, port = endpoints[0].rpartition(":")
            args.store_host, args.store_service_port = host, int(port)
            endpoints = []

    from . import resolve_device
    from .engine import InferenceEngine
    from .kv import PagedCacheConfig

    device = resolve_device(args.device)
    followers: list = []
    tp_spec = None
    if world > 1:
        import tempfile

        if device.type == "cuda":
            from .ops import build

            # once, here: the followers find the libraries built
            build.build_all()
        rdv = tempfile.mkdtemp(prefix="istpu-tp-")
        tp_spec = {
            "tp": args.tp, "pp": args.pp, "backend": args.dist_backend,
            "init_method": "file://" + os.path.join(rdv, "store"),
            "device": args.device, "model": args.model, "seed": 0,
            "n_blocks": args.n_blocks, "block_tokens": args.block_tokens,
            "engine": dict(prefill_chunk=args.prefill_chunk,
                           decode_chunk=args.decode_chunk,
                           model_id=args.model,
                           kv_quant=(None if args.kv_quant == "none"
                                     else args.kv_quant),
                           store_durability=args.store_durability),
        }
        followers = spawn_followers(tp_spec)
        cfg, params, engine_fns = None, None, {}
    else:
        cfg, params, engine_fns = load_model(args.model, device)
    tokenizer = None
    tok_src = args.tokenizer or (
        args.model if args.model != "tiny" and any(
            os.path.exists(os.path.join(args.model, f)) for f in
            ("tokenizer.json", "tokenizer_config.json", "tokenizer.model"))
        else None)
    if tok_src is not None:
        try:
            import transformers

            tokenizer = transformers.AutoTokenizer.from_pretrained(tok_src)
        except Exception:
            if args.tokenizer is not None:
                raise  # the operator asked for THIS tokenizer: fail loudly
            # implicit default (the checkpoint dir's tokenizer files):
            # without transformers installed, serve token ids, no text
            Logger.warn(
                f"no usable tokenizer in {tok_src!r}; serving token ids only"
            )
    conn = None
    if endpoints:
        from .cluster import RoutedStorePool

        conn = RoutedStorePool(
            endpoints,
            connection_type=("SHM" if args.store_connection == "shm"
                             else "TCP"),
            op_timeout_s=args.store_op_timeout or None,
            **({"replicas": args.store_replicas}
               if args.store_replicas else {}),
        )
    if conn is None and args.store_host is not None:
        if args.store_service_port is None:
            raise SystemExit("--store-host requires --store-service-port")
        from . import lib as ist

        conn = ist.InfinityConnection(ist.ClientConfig(
            host_addr=args.store_host,
            service_port=args.store_service_port,
            connection_type=(ist.TYPE_SHM
                             if args.store_connection == "shm"
                             else ist.TYPE_TCP),
            op_timeout_s=args.store_op_timeout or None,
        ))
        conn.connect()
    if tp_spec is not None:
        engine = tp_engine(tp_spec, 0, conn=conn)
        # rank 0's card (cuda:0): the draft of --draft-model lives there
        cfg, device = engine.cfg, engine.device
    else:
        pc = PagedCacheConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, n_blocks=args.n_blocks,
            block_tokens=args.block_tokens, dtype=cfg.dtype,
        )
        engine = InferenceEngine(
            params, cfg, pc, prefill_chunk=args.prefill_chunk,
            decode_chunk=args.decode_chunk, conn=conn, model_id=args.model,
            kv_quant=(None if args.kv_quant == "none" else args.kv_quant),
            store_durability=args.store_durability, device=device,
            **engine_fns)
    draft_engine = None
    if args.draft_model is not None:
        # the draft proposes tokens the target verifies, so the vocabs must
        # agree; pages must chunk identically for the two caches to track
        # the same sequence (SpeculativeDecoder checks block_tokens)
        dcfg, dparams, dfns = load_model(args.draft_model, device, seed=1)
        if dcfg.vocab_size != cfg.vocab_size:
            raise SystemExit(
                f"--draft-model vocab {dcfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}; speculation needs a shared vocabulary"
            )
        dpc = PagedCacheConfig(
            n_layers=dcfg.n_layers, n_kv_heads=dcfg.n_kv_heads,
            head_dim=dcfg.head_dim,
            n_blocks=args.draft_n_blocks or args.n_blocks,
            block_tokens=args.block_tokens, dtype=dcfg.dtype,
        )
        draft_engine = InferenceEngine(dparams, dcfg, dpc,
                                       decode_chunk=args.decode_chunk,
                                       device=device, **dfns)
    if args.ngram_spec and draft_engine is not None:
        raise SystemExit("--ngram-spec and --draft-model are mutually "
                         "exclusive speculation modes")
    manage_spec = args.store_manage_endpoints or os.environ.get(
        "ISTPU_STORE_MANAGE_ENDPOINTS"
    )
    manage_eps = [e.strip() for e in (manage_spec or "").split(",")
                  if e.strip()]
    srv = ServingServer(engine, host=args.host, port=args.port,
                        max_batch=args.max_batch, model_id=args.model,
                        tokenizer=tokenizer, draft_engine=draft_engine,
                        spec_k=args.spec_k, max_queue=args.max_queue,
                        spec_batch=args.spec_batch,
                        ngram_spec=args.ngram_spec, spec_g=args.spec_g,
                        prefill_concurrency=args.prefill_concurrency,
                        slo_ttft_s=args.slo_ttft, slo_tpot_s=args.slo_tpot,
                        ledger_ring=args.ledger_ring,
                        session_ring=args.session_ring,
                        store_manage_endpoints=manage_eps,
                        quotas=args.quotas or None, role=args.role)
    if args.role == "prefill" and conn is None:
        Logger.warn("--role prefill without a store: handoffs will "
                    "answer flushed=false and decode workers recompute "
                    "(attach --store-host)")
    srv.start()
    if not followers:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.close()
        return
    # rank 0 of a serving group: SIGTERM (or ^C) shuts the followers
    # down; a follower that dies ends the server non-zero
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    dead = []
    try:
        while not dead and not stop.wait(0.5):
            dead = [p.name for p in followers if not p.is_alive()]
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        if not dead:
            engine.shutdown_followers()
        for p in followers:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
        import shutil

        shutil.rmtree(rdv, ignore_errors=True)  # the rendezvous file
    if dead:
        raise SystemExit(f"serving-group rank(s) {dead} died")


if __name__ == "__main__":
    main()
