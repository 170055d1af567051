"""Fleet front door: one HTTP entry point over N prefill + M decode
workers, KV handed off exclusively through the store tier.

The port's copy of the reference's ``frontdoor.py``: the router is host
code over HTTP, so it is the reference's line for line, and every
``istpu_fd_*`` family, ``/debug/fleet`` payload and ``X-Istpu-*`` header
keeps its name.  Only ``local_fleet`` differs: its workers are the port's
``InferenceEngine``s on a torch ``device``.

This is the deployment the source paper exists for (PAPER.md §1(a):
prefill→decode KV transfer in disaggregated clusters): a prefill pool
computes a prompt's KV once and pushes it over the zero-copy store path
(``KVTransferEngine.push_begin/push_commit``); decode workers ADOPT the
prefix through the content-addressed index (``get_match_last_index``
probe → ``load_pages`` inside their own ``prefill_start``) instead of
recomputing what a prefill worker already paid for.  Separating the two
pools removes prefill head-of-line interference from decode steps, so
TPOT holds flat under prefill bursts while TTFT stays at or below the
monolith's (bench_serve.py ``--self-disagg`` is the proof harness).

Design (stdlib only, like serve.py / server.py):

* **Placement.**  Prefill requests go to the least-loaded USABLE
  prefill worker — usable = reachable at the last `/healthz` poll and
  per-worker circuit not open; workers whose admission controller is
  shedding sort last (admission verdicts consulted per worker).  Decode
  requests are placed by PREFIX AFFINITY: a rendezvous hash of the
  prompt's leading stem over the usable decode pool, so same-prefix
  sessions land on the worker whose local ``PrefixPageCache`` (and hot
  store shard) already holds their pages.  The store probe itself runs
  inside the decode worker's ``prefill_start``, which makes ANY
  placement *correct* — affinity only makes it *fast* (the placement's
  input signals: chunk-stem hashing + ``get_match_last_index``).
* **Handoff wire sequence.**  router ``POST /v1/prefill`` on the
  prefill worker (scheduler-path prefill, KV streamed to the store,
  ``store_flush`` durability barrier) → router ``POST
  /v1/completions`` on the decode worker (prefix probe → zero-copy
  load → decode) → ONE SSE stream back to the client.  The request's
  trace id propagates via ``X-Istpu-Trace`` on both legs, so
  ``/debug/traces`` exports the whole chain — http.request → prefill
  worker → store push → decode adoption — under a single trace id
  (worker rings gathered via ``/debug/traces?raw=1`` and mapped onto
  the router's clock with a round-trip-midpoint offset estimate).
* **Failure semantics.**  A prefill-worker failure retries the next
  candidate and finally DEGRADES to recompute-on-decode — the
  guarded-load machinery makes a missing prefix a cache miss, never an
  error, so a prefill-pool death costs latency, not availability.  A
  decode-worker failure before any response byte was forwarded fails
  over to the next affinity candidate.  Per-worker circuit breakers
  (``istpu_store_circuit_state{name="<role>@host:port"}`` on the
  router's registry) keep a dead worker to one failed probe per
  cooldown instead of one per request.  Zero 5xx through a single
  prefill-worker death mid-flood is the chaos acceptance
  (tests/test_frontdoor.py).

Operator surface: ``GET /healthz`` (role=router + per-role rollup),
``GET /metrics`` (istpu_fd_* families, docs/observability.md),
``GET /debug/fleet`` (per-worker role/state/inflight rows — the
istpu-top fleet view), ``GET /debug/traces`` (fleet-stitched Perfetto
export), ``GET /debug/trace/{trace_id}`` (ONE request's mesh-stitched
timeline: router + workers + each worker's store fleet, one pid row
per process), ``GET /debug/critpath`` (router-grain stage ledger:
worker rows merged by trace id, p50/p99 TTFT by stage, dominant
stage, worst-offender trace ids — docs/observability.md "Latency
attribution").  Start with ``istpu-frontdoor`` or ``serve.py --role
router``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import http.client
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from .utils import resilience as _resilience
from .utils import tracing
from .utils.logging import Logger
from .utils.metrics import (
    MetricsRegistry,
    PROMETHEUS_CONTENT_TYPE,
    default_registry,
    parse_prometheus_text,
)

# worker /metrics families the poller keeps for the fleet view
_POLLED_FAMILIES = (
    "istpu_serve_requests_total",
    "istpu_serve_completed_total",
    "istpu_serve_free_kv_pages",
    "istpu_engine_prefix_tokens_total",
)


def _hostport(url: str) -> Tuple[str, int]:
    parts = urlsplit(url if "//" in url else f"http://{url}")
    if parts.hostname is None or parts.port is None:
        raise ValueError(f"worker url needs host:port, got {url!r}")
    return parts.hostname, parts.port


class WorkerState:
    """The router's view of one worker: last-poll health, the circuit
    breaker guarding its transport, and the router-tracked inflight
    count (requests this router dispatched and has not seen finish)."""

    def __init__(self, url: str, role: str, registry: MetricsRegistry):
        url = url if "//" in url else f"http://{url}"
        self.url = url.rstrip("/")
        self.role = role
        host, port = _hostport(url)
        self.host, self.port = host, port
        self.endpoint = f"{host}:{port}"
        # per-worker circuit on the ROUTER registry: the established
        # istpu_store_circuit_state{name=} family, one series per worker
        self.breaker = _resilience.CircuitBreaker(
            name=f"{role}@{self.endpoint}", registry=registry
        )
        self._lock = threading.Lock()
        self._inflight = 0
        self.reachable = False
        self.healthz: Optional[dict] = None
        self.prom: Dict[Tuple[str, tuple], float] = {}
        self.last_poll_s: Optional[float] = None

    # -- inflight accounting (handler threads) --

    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def end(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # -- placement inputs --

    @property
    def usable(self) -> bool:
        """Candidate filter: reachable and circuit not hard-open.  Uses
        the state PROPERTY, not ``allow()`` — allow() consumes the
        half-open probe and belongs at dispatch time."""
        return self.reachable and self.breaker.state != "open"

    @property
    def shedding(self) -> bool:
        adm = (self.healthz or {}).get("admission") or {}
        return adm.get("mode") == "shed"

    def metric(self, name: str, labels: tuple = ()) -> Optional[float]:
        return self.prom.get((name, tuple(sorted(labels))))

    def row(self) -> Dict[str, Any]:
        """One /debug/fleet row."""
        prov = {
            src: self.metric("istpu_engine_prefix_tokens_total",
                             (("source", src),)) or 0.0
            for src in ("local", "store", "computed")
        }
        return {
            "endpoint": self.endpoint, "url": self.url, "role": self.role,
            "reachable": self.reachable,
            "status": (self.healthz or {}).get("status",
                                               "unreachable"
                                               if not self.reachable
                                               else "?"),
            "circuit": self.breaker.state,
            "inflight": self.inflight,
            "shedding": self.shedding,
            "requests_total": self.metric("istpu_serve_requests_total"),
            "completed_total": self.metric("istpu_serve_completed_total"),
            "free_kv_pages": self.metric("istpu_serve_free_kv_pages"),
            "prefix_tokens": prov,
        }


def affinity_stem(body: Dict[str, Any], tokens: int = 16) -> Optional[str]:
    """The prompt's leading stem, the decode-placement affinity key: the
    first ``tokens`` token ids (or the first 64 chars of a string
    prompt / first chat message) — everything a shared-prefix session
    family has in common.  None when the body has no usable prompt
    (validation happens on the worker; placement just needs a key)."""
    prompt = body.get("prompt")
    if isinstance(prompt, list) and prompt:
        return ",".join(str(t) for t in prompt[:tokens])
    if isinstance(prompt, str) and prompt:
        return prompt[:64]
    msgs = body.get("messages")
    if isinstance(msgs, list) and msgs and isinstance(msgs[0], dict):
        return str(msgs[0].get("content", ""))[:64]
    return None


def rendezvous_order(workers: List[WorkerState],
                     key: Optional[str]) -> List[WorkerState]:
    """Highest-random-weight order of ``workers`` for ``key``: the head
    is the sticky placement, the tail the failover order — adding or
    removing a worker moves only ~1/N of the key space (the HashRing
    argument, per key instead of per ring).  Shedding workers sort
    after non-shedding ones, preserving affinity within each group
    (health-aware placement).  No key = least-loaded order."""

    def score(w: WorkerState) -> int:
        h = hashlib.blake2b(f"{key}|{w.endpoint}".encode(), digest_size=8)
        return int.from_bytes(h.digest(), "big")

    if key is None:
        return sorted(workers, key=lambda w: (w.shedding, w.inflight))
    return sorted(workers, key=lambda w: (w.shedding, -score(w)))


class FrontDoor:
    """Owns the worker table, the background health poller, and the
    routing HTTP server."""

    def __init__(self, prefill_urls: List[str], decode_urls: List[str],
                 host: str = "127.0.0.1", port: int = 8080,
                 poll_s: float = 1.0, handoff_timeout_s: float = 120.0,
                 request_timeout_s: float = 600.0,
                 affinity_tokens: int = 16,
                 peers: Optional[List[str]] = None):
        if not decode_urls:
            raise ValueError("need at least one decode worker")
        self.metrics = MetricsRegistry()
        # replicated routers (docs/design.md resumption + replication):
        # N front doors over the SAME worker pools need zero
        # coordination — rendezvous placement is deterministic, so every
        # replica computes the same affinity order, and health / breaker
        # / session-pin state stays per-router SOFT state (a pin missing
        # on replica 2 costs one affinity miss, which store adoption
        # already tolerates).  ``peers`` (--peers / ISTPU_FD_PEERS) only
        # names the siblings for the fleet-merged /debug/fleet view and
        # the replica gauge; routing never consults them.
        self.peers = [
            (u if "//" in u else f"http://{u}").rstrip("/")
            for u in (peers or [])
        ]
        # router-plane fault injection (house rule: the failure mode
        # lands as an injectable fault before its mitigation).  The
        # ``router_death`` scenario drops every client connection at
        # request entry — the loadgen's router-list failover is the
        # mitigation under test.  Armed via POST /debug/faults (never
        # itself gated).
        from .pyserver import FaultInjector

        self.faults = FaultInjector()
        self.prefill = [WorkerState(u, "prefill", self.metrics)
                        for u in prefill_urls]
        self.decode = [WorkerState(u, "decode", self.metrics)
                       for u in decode_urls]
        self.poll_s = poll_s
        self.handoff_timeout_s = handoff_timeout_s
        self.request_timeout_s = request_timeout_s
        self.affinity_tokens = affinity_tokens
        self.stats = {"2xx": 0, "4xx": 0, "5xx": 0, "error": 0}
        self._handoff_ms: deque = deque(maxlen=512)  # recent leg times
        # session-id decode affinity, LAYERED over the rendezvous prefix
        # affinity: a conversation's first turn routes by prefix stem
        # (fallback), every later turn goes back to the worker that
        # served it — the worker whose PrefixPageCache holds the
        # session's pages, so cross-turn reuse is LOCAL, not a store
        # round-trip.  Bounded LRU (ISTPU_FD_SESSION_CAP sessions);
        # losing an entry is safe — the next turn falls back to prefix
        # affinity and re-pins, store adoption covers the reuse.
        try:
            self.session_cap = int(
                os.environ.get("ISTPU_FD_SESSION_CAP", "") or 4096)
        except ValueError:
            self.session_cap = 4096
        self.session_cap = max(1, self.session_cap)
        self._session_map: "OrderedDict[str, str]" = OrderedDict()
        self._session_lock = threading.Lock()
        # router-grain critpath notes: the router's OWN measurement of
        # each request (handler entry → first forwarded byte → done),
        # joined to the workers' stage rows by trace id at
        # /debug/critpath — the note's TTFT is what the CLIENT saw, so
        # the gap between it and the mapped stage sum is the
        # `unattributed` remainder.  Bounded LRU like the session map.
        try:
            self._cp_cap = int(
                os.environ.get("ISTPU_CRITPATH_RING", "") or 256)
        except ValueError:
            self._cp_cap = 256
        self._cp_cap = max(1, self._cp_cap)
        self._cp_notes: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._cp_lock = threading.Lock()
        self._register_metrics()
        self._stop = threading.Event()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="istpu-fd-poll", daemon=True)
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]

    # -- lifecycle --

    def start(self) -> None:
        self._poll_once()  # the first placement must not race the poller
        self._poller.start()
        threading.Thread(target=self.httpd.serve_forever,
                         name="istpu-fd-http", daemon=True).start()
        Logger.info(
            f"front door on :{self.port} over "
            f"{len(self.prefill)} prefill + {len(self.decode)} decode"
        )

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- metrics --

    def _register_metrics(self) -> None:
        reg = self.metrics

        self._c_req = reg.counter(
            "istpu_fd_requests_total",
            "Client requests routed, by status class (the chaos walks "
            "assert the 5xx series stays flat through a worker death)",
            labelnames=("class",),
        )
        for cls in ("2xx", "4xx", "5xx", "error"):
            self._c_req.labels(cls)  # series exist BEFORE the first event
        self._c_handoff = reg.counter(
            "istpu_fd_handoff_total",
            "Prefill handoffs by outcome: ok (flushed), degraded "
            "(worker answered but decode must recompute), failed "
            "(every candidate errored), skipped (no prefill pool), "
            "rejected (prefill admission 429 everywhere)",
            labelnames=("outcome",),
        )
        self._h_handoff = reg.histogram(
            "istpu_fd_handoff_seconds",
            "Prefill handoff leg wall time (attempted handoffs)",
        )
        self._c_retry = reg.counter(
            "istpu_fd_decode_retries_total",
            "Decode dispatches that failed over to another worker",
        )
        self._c_session_aff = reg.counter(
            "istpu_serve_session_affinity_total",
            "Session-carrying decode dispatches by placement result: "
            "hit (served by the session's pinned worker), miss (pin "
            "existed, another worker served — drain/failover; re-pinned "
            "there), fallback (first turn / evicted pin — routed by "
            "prefix affinity, then pinned)",
            labelnames=("result",),
        )
        for res in ("hit", "miss", "fallback"):
            self._c_session_aff.labels(res)
        self._c_abort = reg.counter(
            "istpu_fd_stream_aborts_total",
            "Streams cut mid-flight by a decode-worker failure after "
            "bytes were already forwarded (client sees an SSE error "
            "event, not a broken socket)",
        )
        self._c_resume = reg.counter(
            "istpu_fd_stream_resumes_total",
            "Mid-stream decode-death re-dispatches by result: ok (the "
            "stream spliced onto a survivor and continued byte-exact "
            "under the emitted-count watermark), failed (no survivor "
            "could continue — the stream aborted)",
            labelnames=("result",),
        )
        for res in ("ok", "failed"):
            self._c_resume.labels(res)
        self._g_replicas = reg.gauge(
            "istpu_fd_router_replicas",
            "Router replicas this process knows of (itself + --peers).  "
            "Configuration, not membership: rendezvous placement needs "
            "no coordination, so replicas never handshake",
        )
        self._g_replicas.set(1 + len(self.peers))
        self._g_workers = reg.gauge(
            "istpu_fd_workers",
            "Configured workers per role", labelnames=("role",),
        )
        self._g_usable = reg.gauge(
            "istpu_fd_workers_usable",
            "Workers currently usable (reachable at the last poll, "
            "circuit not open) per role — refreshed each poll tick",
            labelnames=("role",),
        )
        self._g_inflight = reg.gauge(
            "istpu_fd_inflight",
            "Requests this router dispatched and not yet finished, "
            "per role — refreshed each poll tick (/debug/fleet has the "
            "live per-worker values)",
            labelnames=("role",),
        )
        for role, pool in (("prefill", self.prefill),
                           ("decode", self.decode)):
            self._g_workers.labels(role).set(len(pool))
            self._g_usable.labels(role).set(0)
            self._g_inflight.labels(role).set(0)
        self._g_store_tok = reg.gauge(
            "istpu_fd_fleet_store_tokens",
            "Last-polled sum over the decode pool of store-adopted "
            "prompt tokens (istpu_engine_prefix_tokens_total{source="
            "\"store\"}) — the fleet's adoption-is-working signal",
        )

    # -- polling --

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._poll_once()
            except Exception as e:  # noqa: BLE001 — the poller must survive
                Logger.warn(f"fleet poll failed: {e!r}")

    def _poll_once(self) -> None:
        for w in self.prefill + self.decode:
            hz = self._fetch_json(w, "/healthz", timeout=2.0)
            w.reachable = hz is not None
            w.healthz = hz if hz is not None else w.healthz
            if hz is None:
                w.last_poll_s = time.monotonic()
                continue
            raw = self._fetch(w, "/metrics", timeout=2.0)
            if raw is not None:
                try:
                    parsed = parse_prometheus_text(raw.decode())
                    w.prom = {
                        k: v for k, v in parsed.items()
                        if k[0] in _POLLED_FAMILIES
                    }
                except ValueError:
                    pass
            w.last_poll_s = time.monotonic()
        for role, pool in (("prefill", self.prefill),
                           ("decode", self.decode)):
            self._g_usable.labels(role).set(
                sum(1 for w in pool if w.usable))
            self._g_inflight.labels(role).set(
                sum(w.inflight for w in pool))
        self._g_store_tok.set(sum(
            w.metric("istpu_engine_prefix_tokens_total",
                     (("source", "store"),)) or 0.0
            for w in self.decode
        ))

    @staticmethod
    def _fetch(w: WorkerState, path: str,
               timeout: float) -> Optional[bytes]:
        try:
            conn = http.client.HTTPConnection(w.host, w.port,
                                              timeout=timeout)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return resp.read()
            finally:
                conn.close()
        except OSError:
            return None

    @classmethod
    def _fetch_json(cls, w: WorkerState, path: str,
                    timeout: float) -> Optional[dict]:
        raw = cls._fetch(w, path, timeout)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    # -- placement --

    def prefill_candidates(self) -> List[WorkerState]:
        """Least-loaded-first usable prefill workers; shedding workers
        last (admission-verdict-aware placement)."""
        return sorted((w for w in self.prefill if w.usable),
                      key=lambda w: (w.shedding, w.inflight))

    def decode_candidates(self, stem: Optional[str]) -> List[WorkerState]:
        """Usable decode workers in affinity order; when the last poll
        says NOBODY is usable, try everyone anyway (polls go stale the
        instant a worker recovers, and a stale 503 is worse than one
        failed connect)."""
        usable = [w for w in self.decode if w.usable]
        pool = usable or [w for w in self.decode
                          if w.breaker.state != "open"] or list(self.decode)
        return rendezvous_order(pool, stem)

    def session_pin(self, session: Optional[str]) -> Optional[str]:
        """The decode endpoint this session is pinned to (LRU-touched),
        or None for unpinned/unknown sessions."""
        if not session:
            return None
        with self._session_lock:
            ep = self._session_map.get(session)
            if ep is not None:
                self._session_map.move_to_end(session)
            return ep

    def session_bind(self, session: str, endpoint: str) -> None:
        """(Re)pin a session to the worker that just served it."""
        with self._session_lock:
            self._session_map[session] = endpoint
            self._session_map.move_to_end(session)
            while len(self._session_map) > self.session_cap:
                self._session_map.popitem(last=False)

    # -- the prefill leg --

    def prefill_handoff(self, body: Dict[str, Any],
                        trace_id: Optional[str]) -> Dict[str, Any]:
        """Run the prefill leg: pick, POST /v1/prefill, fall through the
        candidate list on failure.  Returns an outcome dict; "ok" means
        the prefix is durably in the store and decode will adopt it,
        anything else means decode recomputes (correct either way —
        guarded loads make a missing prefix a miss).  ``reject`` carries
        a client-facing (status, payload) when the prefill pool REJECTED
        the request body (4xx: identical validation everywhere, no point
        burning a decode leg)."""
        # only what the prefill side needs: the prompt (or messages —
        # workers share the tokenizer, so ids come out identical), the
        # admission lane, and the adapter route.  max_tokens stays home:
        # pages for prompt+budget must fit the DECODE worker, the
        # prefill worker only pages the prompt + 1.
        sub = {k: body[k] for k in ("prompt", "messages", "priority",
                                    "model")
               if k in body}
        cands = self.prefill_candidates()
        if not cands:
            self._c_handoff.labels(
                "skipped" if not self.prefill else "failed").inc()
            return {"outcome": "skipped" if not self.prefill else "failed"}
        t0 = time.perf_counter()
        sheds = 0
        with tracing.span("fd.prefill_handoff"):
            for w in cands:
                if not w.breaker.allow():
                    continue
                w.begin()
                try:
                    status, payload = self._post_json(
                        w, "/v1/prefill", sub, self.handoff_timeout_s,
                        trace_id)
                except OSError as e:
                    w.breaker.record_failure()
                    Logger.warn(
                        f"prefill handoff to {w.endpoint} failed: {e!r}")
                    continue
                finally:
                    w.end()
                w.breaker.record_success()
                if status == 200:
                    out = ("ok" if (payload or {}).get("flushed")
                           else "degraded")
                    self._c_handoff.labels(out).inc()
                    self._observe_handoff(t0)
                    return {"outcome": out, "worker": w.endpoint,
                            **(payload or {})}
                if status == 429:
                    sheds += 1  # this worker's admission refused; try next
                    continue
                if 400 <= status < 500:
                    # bad request: every worker validates identically —
                    # answer the client now, skip the decode leg
                    self._c_handoff.labels("rejected").inc()
                    self._observe_handoff(t0)
                    return {"outcome": "rejected", "worker": w.endpoint,
                            "reject": (status, payload)}
                # 5xx: engine fault on that worker; not a transport
                # failure (no breaker), but recompute-elsewhere applies
                Logger.warn(
                    f"prefill handoff to {w.endpoint}: HTTP {status}")
        # a shedding prefill pool is admission working, not a fault: the
        # request still decodes (the decode worker's own admission gets
        # the final say) — "degraded" = attempted but decode recomputes
        outcome = "degraded" if sheds else "failed"
        self._c_handoff.labels(outcome).inc()
        self._observe_handoff(t0)
        return {"outcome": outcome}

    def _observe_handoff(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        self._h_handoff.observe(dt)
        self._handoff_ms.append(dt * 1e3)

    def _post_json(self, w: WorkerState, path: str, body: Dict[str, Any],
                   timeout: float, trace_id: Optional[str]
                   ) -> Tuple[int, Optional[dict]]:
        conn = http.client.HTTPConnection(w.host, w.port, timeout=timeout)
        try:
            headers = {"Content-Type": "application/json"}
            if trace_id:
                headers["X-Istpu-Trace"] = trace_id
            conn.request("POST", path, json.dumps(body), headers)
            resp = conn.getresponse()
            raw = resp.read()
            try:
                payload = json.loads(raw) if raw else None
            except ValueError:
                payload = None
            return resp.status, payload
        finally:
            conn.close()

    # -- operator surface --

    def count_code(self, status: int) -> None:
        cls = ("2xx" if 200 <= status < 300 else
               "4xx" if 400 <= status < 500 else
               "5xx" if 500 <= status < 600 else "error")
        with self.metrics.lock:
            self.stats[cls] += 1
        self._c_req.labels(cls).inc()

    def _role_rollup(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for role, pool in (("prefill", self.prefill),
                           ("decode", self.decode)):
            counts = {"workers": len(pool), "ok": 0, "degraded": 0,
                      "unreachable": 0, "circuit_open": 0}
            for w in pool:
                if not w.reachable:
                    counts["unreachable"] += 1
                elif (w.healthz or {}).get("status") == "ok":
                    counts["ok"] += 1
                else:
                    counts["degraded"] += 1
                if w.breaker.state == "open":
                    counts["circuit_open"] += 1
            out[role] = counts
        return out

    def health(self) -> Dict[str, Any]:
        """The /healthz payload (field asserts only — it grows):
        degraded when any worker is not ok, or a pool has no usable
        member (the decode pool empty means the fleet cannot answer)."""
        rollup = self._role_rollup()
        degraded = any(
            c["degraded"] or c["unreachable"] or c["circuit_open"]
            for c in rollup.values()
        ) or not any(w.usable for w in self.decode)
        return {
            "status": "degraded" if degraded else "ok",
            "role": "router",
            "rollup": rollup,
            "workers": len(self.prefill) + len(self.decode),
        }

    def usage_rollup(self) -> Dict[str, Any]:
        """The router's ``GET /debug/usage``: poll every worker's
        joined usage ledger and fold them into ONE fleet ledger
        (``usage.merge_usage_reports`` — store-side byte·seconds dedupe
        by max across workers sharing manage endpoints; token counts
        sum).  Unreachable workers degrade the rollup, never fail it."""
        from .health import fetch_json
        from .usage import merge_usage_reports

        reports = []
        workers = []
        for w in self.prefill + self.decode:
            u = fetch_json(w.url + "/debug/usage") if w.usable else None
            workers.append({"endpoint": w.endpoint, "role": w.role,
                            "reachable": u is not None})
            if u:
                reports.append(u)
        out = merge_usage_reports(reports)
        out["role"] = "router"
        out["workers"] = workers
        return out

    def fleet_report(self) -> Dict[str, Any]:
        """The /debug/fleet payload: one row per worker (role / state /
        inflight / adoption provenance), the per-role rollup, recent
        handoff percentiles, and the adoption totals — everything
        istpu-top's fleet view renders."""
        ms = sorted(self._handoff_ms)

        def pct(q: float) -> Optional[float]:
            if not ms:
                return None
            return round(ms[min(len(ms) - 1, int(q * len(ms)))], 2)

        store_tok = sum(
            w.metric("istpu_engine_prefix_tokens_total",
                     (("source", "store"),)) or 0.0 for w in self.decode)
        local_tok = sum(
            w.metric("istpu_engine_prefix_tokens_total",
                     (("source", "local"),)) or 0.0 for w in self.decode)
        return {
            "enabled": True,
            "role": "router",
            "workers": [w.row() for w in self.prefill + self.decode],
            "rollup": self._role_rollup(),
            "handoff": {"count": len(ms), "p50_ms": pct(0.50),
                        "p99_ms": pct(0.99)},
            "adoption": {"store_tokens": store_tok,
                         "local_tokens": local_tok},
            "sessions": {
                "pinned": len(self._session_map),
                "capacity": self.session_cap,
                "affinity": {
                    res: self.metrics.family_value(
                        "istpu_serve_session_affinity_total",
                        where={"result": res}) or 0.0
                    for res in ("hit", "miss", "fallback")
                },
            },
            "requests": dict(self.stats),
            "router": {
                "replicas": 1 + len(self.peers),
                "peers": list(self.peers),
                "stream": {
                    "aborts": self.metrics.family_value(
                        "istpu_fd_stream_aborts_total") or 0.0,
                    "resumes": {
                        res: self.metrics.family_value(
                            "istpu_fd_stream_resumes_total",
                            where={"result": res}) or 0.0
                        for res in ("ok", "failed")
                    },
                },
            },
        }

    def fleet_report_merged(self) -> Dict[str, Any]:
        """``GET /debug/fleet?merged=1``: this replica's report plus
        every peer's, with the request/stream counters SUMMED — the one
        place a fleet-wide "did any stream die?" answer exists without
        scraping N routers by hand.  Per-replica reports stay truthful
        (each router only ever counts its own traffic); unreachable
        peers degrade the merge, never fail it."""
        mine = self.fleet_report()
        routers = [{"endpoint": f"127.0.0.1:{self.port}", "self": True,
                    "reachable": True, "report": mine}]
        for url in self.peers:
            try:
                host, port = _hostport(url)
            except ValueError:
                continue
            peer = WorkerState.__new__(WorkerState)
            peer.host, peer.port = host, port
            rep = self._fetch_json(peer, "/debug/fleet", timeout=5.0)
            routers.append({"endpoint": f"{host}:{port}", "self": False,
                            "reachable": rep is not None, "report": rep})
        total = {"2xx": 0.0, "4xx": 0.0, "5xx": 0.0, "error": 0.0}
        stream = {"aborts": 0.0, "resumes_ok": 0.0, "resumes_failed": 0.0}
        for r in routers:
            rep = r.get("report") or {}
            for cls, v in (rep.get("requests") or {}).items():
                if cls in total:
                    total[cls] += float(v or 0)
            st = (rep.get("router") or {}).get("stream") or {}
            stream["aborts"] += float(st.get("aborts") or 0)
            rs = st.get("resumes") or {}
            stream["resumes_ok"] += float(rs.get("ok") or 0)
            stream["resumes_failed"] += float(rs.get("failed") or 0)
        return {
            "enabled": True,
            "role": "router-fleet",
            "replicas": len(routers),
            "reachable": sum(1 for r in routers if r["reachable"]),
            "routers": routers,
            "requests": total,
            "stream": stream,
        }

    def stitched_traces_json(self, limit: Optional[int] = None) -> str:
        """Fleet-stitched Chrome trace JSON: the router's own ring plus
        every reachable worker's raw dump, each mapped onto the router
        clock with a round-trip-midpoint offset (error bounded by half
        the fetch RTT — the HELLO clock-sync estimate, over HTTP)."""
        from .utils import trace_stitch

        remotes = []
        for w in self.prefill + self.decode:
            if not w.reachable:
                continue
            q = f"/debug/traces?raw=1&limit={limit}" if limit \
                else "/debug/traces?raw=1"
            t0 = time.perf_counter()
            dump = self._fetch_json(w, q, timeout=5.0)
            t1 = time.perf_counter()
            if dump is None or "traces" not in dump:
                continue
            offset = float(dump.get("clock", 0.0)) - (t0 + t1) / 2.0
            remotes.append((dump, offset))
        return json.dumps(trace_stitch.stitch_chrome(
            tracing.TRACER, remotes, limit=limit,
            local_role="router"))

    def stitched_trace_json(self, trace_id: str) -> str:
        """Mesh-wide single-request export (``GET /debug/trace/{id}``):
        every worker's span ring — PLUS each worker's attached store
        rings, which the worker pre-maps into its own clock
        (``/debug/traces?raw=1&stores=1``) — stitched onto the router
        timeline as one Perfetto-loadable trace with one ``pid`` row
        per process.  Worker offsets come from the round-trip-midpoint
        estimate of the gather fetch; store rows reuse the SAME worker
        offset transitively and add the worker→store error bound on
        top, so the export's skew is self-describing end to end.
        Every gather outcome is counted in
        ``istpu_trace_stitch_total``."""
        from .utils import trace_stitch

        remotes = []
        local_pid = os.getpid()
        seen_pids = set()
        for w in self.prefill + self.decode:
            if not w.reachable:
                continue
            q = f"/debug/traces?raw=1&stores=1&trace_id={trace_id}"
            t0 = time.perf_counter()
            dump = self._fetch_json(w, q, timeout=5.0)
            t1 = time.perf_counter()
            if dump is None or "traces" not in dump:
                trace_stitch.count_stitch(
                    "error" if dump is None else "unnegotiated")
                continue
            trace_stitch.count_stitch("ok")
            offset = float(dump.get("clock", 0.0)) - (t0 + t1) / 2.0
            err = (t1 - t0) / 2.0
            dump.setdefault("role", w.role)
            # a worker's store remotes arrive PRE-MAPPED into the
            # worker clock, so the worker's single offset carries them
            # onto the router timeline; dedupe by pid — two workers
            # sharing one store node both return its ring
            for rem in dump.pop("remotes", None) or ():
                rpid = rem.get("pid")
                if rpid in seen_pids or rpid == local_pid:
                    continue
                seen_pids.add(rpid)
                rem_err = float(rem.get("clock_offset_err_s") or 0.0)
                remotes.append((rem, offset, err + rem_err))
            # an in-process worker (local_fleet) shares the router's
            # ring — its spans are already in the local tracer
            wpid = int(dump.get("pid", -1))
            if wpid != local_pid and wpid not in seen_pids:
                seen_pids.add(wpid)
                remotes.append((dump, offset, err))
        return json.dumps(trace_stitch.stitch_chrome(
            tracing.TRACER, remotes, trace_id=trace_id,
            local_role="router"))

    # -- critical-path attribution (router grain) --

    def critpath_note(self, trace_id: str, **fields) -> None:
        """Record/extend the router's own measurement of one request."""
        with self._cp_lock:
            note = self._cp_notes.get(trace_id)
            if note is None:
                note = {"trace_id": trace_id}
                self._cp_notes[trace_id] = note
                while len(self._cp_notes) > self._cp_cap:
                    self._cp_notes.popitem(last=False)
            note.update(fields)

    def critpath_report(self,
                        limit: Optional[int] = None) -> Dict[str, Any]:
        """The router's ``GET /debug/critpath``: every worker's stage
        rows grouped by trace id and remapped to router grain
        (``critpath.merge_mesh_rows`` — a decode worker's queue is the
        fleet's ``decode_queue``, a prefill worker's whole row is
        TTFT-side), with the router's own note supplying the measured
        TTFT so the unclaimed remainder lands in ``unattributed``.
        Same answer shape as a worker's snapshot: p50/p99 per stage,
        dominant stage, worst-offender trace ids, per lane and
        overall."""
        from . import critpath

        with self._cp_lock:
            notes = {tid: dict(n) for tid, n in self._cp_notes.items()}
        by_trace: "OrderedDict[str, List[Dict[str, Any]]]" = OrderedDict()
        workers = []
        for w in self.prefill + self.decode:
            snap = self._fetch_json(w, "/debug/critpath", timeout=5.0) \
                if w.reachable else None
            workers.append({"endpoint": w.endpoint, "role": w.role,
                            "reachable": snap is not None,
                            "rows": len((snap or {}).get("rows") or ())})
            for row in (snap or {}).get("rows") or ():
                tid = row.get("trace_id")
                if not tid:
                    continue
                row.setdefault("role", (snap or {}).get("role") or w.role)
                by_trace.setdefault(tid, []).append(row)
        merged = [critpath.merge_mesh_rows(rows, note=notes.get(tid))
                  for tid, rows in by_trace.items()]
        lanes: Dict[str, List[Dict[str, Any]]] = {}
        for r in merged:
            lanes.setdefault(r.get("lane") or "-", []).append(r)
        out = {
            "enabled": True,
            "role": "router",
            "stages": list(critpath.STAGES),
            "ttft_stages": list(critpath.TTFT_STAGES),
            "generated_at": round(time.time(), 3),
            "workers": workers,
            "notes": len(notes),
            "overall": critpath.aggregate(merged),
            "lanes": {lane: critpath.aggregate(rws)
                      for lane, rws in lanes.items()},
        }
        tail = merged
        if limit is not None and limit >= 0:
            tail = tail[len(tail) - min(limit, len(tail)):]
        out["rows"] = tail
        out["returned"] = len(tail)
        return out

    def metrics_text(self) -> str:
        """Router registry plus the process-global one (the stitch
        gather counter ``istpu_trace_stitch_total`` lives there, shared
        with the library's wire-side gathers)."""
        text = self.metrics.to_prometheus_text()
        shared = default_registry()
        if shared is not self.metrics:
            text += shared.to_prometheus_text(exclude=self.metrics.names())
        return text


def _make_handler(fd: FrontDoor):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            Logger.debug("fd " + fmt % args)

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
            path = self.path.split("?", 1)[0]
            if not self._fault_gate():
                return
            if path == "/healthz":
                self._json(200, fd.health())
            elif path == "/metrics":
                data = fd.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/debug/fleet":
                from urllib.parse import parse_qs

                q = parse_qs(urlsplit(self.path).query)
                if (q.get("merged") or ["0"])[0] not in ("", "0", "false"):
                    # fleet-merged view across router replicas (peers
                    # from --peers / ISTPU_FD_PEERS)
                    self._json(200, fd.fleet_report_merged())
                else:
                    self._json(200, fd.fleet_report())
            elif path == "/debug/usage":
                # the fleet usage ledger: every worker's joined
                # /debug/usage folded into one per-tenant view
                self._json(200, fd.usage_rollup())
            elif path == "/debug/traces":
                from urllib.parse import parse_qs

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                data = fd.stitched_traces_json(limit=limit).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/debug/critpath":
                from urllib.parse import parse_qs

                q = parse_qs(urlsplit(self.path).query)
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = None
                self._json(200, fd.critpath_report(limit=limit))
            elif path.startswith("/debug/trace/"):
                # one request's mesh-stitched timeline (?stitched=1 is
                # accepted and implied — this endpoint always stitches)
                tid = path[len("/debug/trace/"):]
                if not tid:
                    self._json(400, {"error": "trace id required"})
                else:
                    data = fd.stitched_trace_json(tid).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
            else:
                self._json(404, {"error": "not found"})

        def _fault_gate(self) -> bool:
            """Router-plane fault gate (scenario ``router_death``), the
            serve-plane grammar matched on the request path at entry.
            ``/debug/*`` is never gated — it IS the chaos control plane,
            and a ``*`` rule must not lock out its own clear."""
            path = self.path.split("?", 1)[0]
            if path.startswith("/debug/"):
                return True
            if not fd.faults.armed:
                return True
            rule = fd.faults.match(path.upper())
            if rule is None:
                return True
            action = rule["action"]
            if action == "delay":
                time.sleep(rule["delay_s"])
                return True
            if action == "stall":
                while fd.faults.active(rule["id"]):
                    time.sleep(0.05)
                return True
            if action == "drop_conn":
                # an abrupt close with no status line: what a SIGKILLed
                # router looks like to its clients — the loadgen's
                # router-list failover is the mitigation under test
                try:
                    self.connection.close()
                except OSError:
                    pass
                return False
            if action == "error":
                status = int(rule.get("error_status") or 500)
                self._json(status, {"error": "injected fault"})
                fd.count_code(status)
                return False
            return True

        def do_POST(self):
            if self.path.split("?", 1)[0] == "/debug/faults":
                # arm/clear router-plane fault rules (chaos only; never
                # itself fault-matched).  Body: a rule list,
                # {"rules": [...]}, or {"scenario": name} — e.g.
                # {"scenario": "router_death"}.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"[]")
                    if isinstance(body, dict) and body.get("scenario"):
                        armed = fd.faults.arm_scenario(
                            str(body["scenario"]))
                    else:
                        rules = body.get("rules", []) \
                            if isinstance(body, dict) else body
                        armed = fd.faults.arm(rules)
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"armed": armed})
                return
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                self._json(404, {"error": "not found"})
                fd.count_code(404)
                return
            if not self._fault_gate():
                return
            self._cp_t0 = time.perf_counter()
            self._cp_first: Optional[float] = None
            self._cp_lane: Optional[str] = None
            # an inbound X-Istpu-Trace CONTINUES the caller's trace (a
            # loadgen-minted id joins the client's own TTFT measurement
            # to this request's stage rows and stitched timeline)
            tid = self.headers.get("X-Istpu-Trace") or None
            with tracing.trace("http.request", trace_id=tid,
                               path=self.path, tier="frontdoor") as tr:
                status = self._route(tr.trace_id)
            if status is not None:
                fd.count_code(status)
            # the router's own measurement (client-observed TTFT/e2e):
            # what /debug/critpath joins to worker stage rows by trace
            # id to name the unattributed remainder
            fd.critpath_note(
                tr.trace_id,
                lane=self._cp_lane or "-",
                status=status,
                ttft_s=((self._cp_first - self._cp_t0)
                        if self._cp_first is not None else None),
                e2e_s=time.perf_counter() - self._cp_t0,
                wall_done=round(time.time(), 3),
            )

        def _route(self, trace_id: str) -> Optional[int]:
            """One request through both legs.  Returns the status sent
            to the client (None = connection dropped before a status)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                self._json(400, {"error": "invalid JSON body"})
                return 400
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return 400
            body.pop("_chat", None)
            # the critpath lane mirrors the workers' lane label: the
            # named tenant when one was given, the priority otherwise
            tenant = body.get("tenant")
            self._cp_lane = tenant if isinstance(tenant, str) and tenant \
                else str(body.get("priority", 0) or 0)
            # prefill leg — skipped for scoring-only requests (nothing
            # to decode, nothing worth handing off)
            try:
                scoring_only = bool(body.get("echo")) and \
                    int(body.get("max_tokens", 16) or 0) == 0
            except (TypeError, ValueError):
                scoring_only = False  # the worker will 400 it
            if not scoring_only:
                handoff = fd.prefill_handoff(body, trace_id)
                if "reject" in handoff:
                    status, payload = handoff["reject"]
                    self._json(status, payload
                               or {"error": "rejected by prefill pool"})
                    return status
            # decode leg (prefix-affine, failover before first byte)
            return self._proxy_decode(body, trace_id)

        def _proxy_decode(self, body: Dict[str, Any],
                          trace_id: str) -> Optional[int]:
            stem = affinity_stem(body, fd.affinity_tokens)
            raw = json.dumps(body)
            cands = fd.decode_candidates(stem)
            # session affinity layered over the rendezvous order: a
            # pinned session's worker moves to the head of the SAME
            # failover list — the pin makes placement fast, never
            # correct (any decode worker adopts from the store)
            sid = body.get("session")
            sid = sid if isinstance(sid, str) and sid else None
            pinned = fd.session_pin(sid)
            if pinned is not None:
                head = next((w for w in cands if w.endpoint == pinned),
                            None)
                if head is not None:
                    cands = [head] + [w for w in cands if w is not head]
            attempts = 0
            with tracing.span("fd.decode_dispatch"):
                for w in cands:
                    if not w.breaker.allow():
                        continue
                    if attempts:
                        fd._c_retry.inc()
                    attempts += 1
                    w.begin()
                    # the worker that ultimately served (a mid-stream
                    # resume splices onto a survivor; _relay_sse updates)
                    self._served_w = w
                    try:
                        status = self._proxy_one(w, raw, trace_id, stem)
                    finally:
                        w.end()
                    if status is not None:
                        sw = self._served_w or w
                        if sid is not None:
                            # result judged by who actually SERVED:
                            # hit = the pinned worker; miss = a pin
                            # existed but a survivor served (drain /
                            # failover / mid-stream resume — re-pin
                            # there); fallback = no pin yet (prefix-
                            # affinity placement)
                            res = ("fallback" if pinned is None else
                                   "hit" if sw.endpoint == pinned
                                   else "miss")
                            fd._c_session_aff.labels(res).inc()
                            fd.session_bind(sid, sw.endpoint)
                        return status
                    # transport failure before any byte forwarded:
                    # fail over to the next affinity candidate
            self._json(503, {"error": "no decode worker available"})
            return 503

        def _proxy_one(self, w: WorkerState, raw: str, trace_id: str,
                       stem: Optional[str] = None) -> Optional[int]:
            """Forward the request to one decode worker and stream the
            answer back.  None = transport failure with NOTHING yet
            forwarded (caller may fail over); any int = a status line
            went to the client (terminal either way)."""
            try:
                conn = http.client.HTTPConnection(
                    w.host, w.port, timeout=fd.request_timeout_s)
                headers = {"Content-Type": "application/json",
                           "X-Istpu-Trace": trace_id}
                conn.request("POST", self.path, raw, headers)
                resp = conn.getresponse()
            except OSError:
                w.breaker.record_failure()
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                return None
            w.breaker.record_success()
            try:
                ctype = resp.getheader("Content-Type", "application/json")
                if resp.status == 200 and ctype.startswith(
                        "text/event-stream"):
                    return self._relay_sse(w, resp, raw, trace_id, stem)
                data = resp.read()
                if self._cp_first is None:
                    self._cp_first = time.perf_counter()
                self.send_response(resp.status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                ra = resp.getheader("Retry-After")
                if ra:  # admission sheds keep their Retry-After
                    self.send_header("Retry-After", ra)
                self.end_headers()
                self.wfile.write(data)
                return resp.status
            except (BrokenPipeError, ConnectionResetError):
                return -1  # client went away; worker cancels on its own
            finally:
                conn.close()

        def _relay_sse(self, w: WorkerState, resp, raw: str,
                       trace_id: str, stem: Optional[str]) -> int:
            """Stream an SSE body through, resuming across decode
            deaths (docs/design.md resumption contract).  The relay
            counts forwarded completion tokens as the emitted-count
            WATERMARK; on an upstream transport death it re-dispatches
            the same body + trace id to a survivor with the resume
            headers and splices the survivor's stream onto the SAME
            client socket after a ``: istpu-resume`` SSE comment — the
            client sees a stall, never an error, and the watermark
            suppression on the survivor keeps the splice byte-exact.
            Only when NO survivor can continue does the old abort
            contract apply: an SSE error event + [DONE], counted in
            istpu_fd_stream_aborts_total (and resumes{failed})."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            cur_w, cur_resp = w, resp
            cur_conn = None  # resume-opened upstream (caller owns resp's)
            watermark = 0    # completion tokens already forwarded
            saw_done = False
            try:
                while True:
                    try:
                        while True:
                            line = cur_resp.readline()
                            if not line:
                                break
                            if self._cp_first is None:  # first byte out:
                                self._cp_first = time.perf_counter()
                            if line.startswith(b"data: "):
                                data = line[6:].strip()
                                if data == b"[DONE]":
                                    saw_done = True
                                else:
                                    try:
                                        ev = json.loads(data)
                                        ch = (ev.get("choices") or [{}])[0]
                                        watermark += len(
                                            ch.get("token_ids") or ())
                                    except (ValueError, AttributeError,
                                            TypeError):
                                        pass
                            self.wfile.write(line)
                            if line == b"\n":  # event boundary: flush
                                self.wfile.flush()
                        if saw_done:
                            self.wfile.flush()
                            return 200
                        # EOF before [DONE]: the upstream died TIDILY —
                        # a SIGKILLed worker's socket closes with a FIN,
                        # not an RST, so truncation (not an exception) is
                        # what death usually looks like here
                        raise OSError("upstream EOF before [DONE]")
                    except (BrokenPipeError, ConnectionResetError):
                        return -1  # client disconnect: workers cancel
                    except OSError:
                        cur_w.breaker.record_failure()
                        got = self._resume_stream(
                            cur_w, raw, trace_id, stem, watermark)
                        if got is None:
                            fd._c_resume.labels("failed").inc()
                            fd._c_abort.inc()
                            try:
                                err = json.dumps(
                                    {"error": f"decode worker "
                                              f"{cur_w.endpoint} died "
                                              f"mid-stream; retry"})
                                self.wfile.write(
                                    f"data: {err}\n\ndata: [DONE]\n\n"
                                    .encode())
                                self.wfile.flush()
                            except OSError:
                                pass
                            return 200
                        if cur_conn is not None:
                            cur_conn.close()
                            cur_w.end()
                        cur_w, cur_conn, cur_resp = got
                        self._served_w = cur_w
                        fd._c_resume.labels("ok").inc()
                        try:
                            # an SSE comment is protocol-transparent:
                            # clients that care (loadgen resumption
                            # accounting) count the splice marker,
                            # everyone else ignores it
                            self.wfile.write(b": istpu-resume\n\n")
                            self.wfile.flush()
                        except OSError:
                            return -1
            finally:
                if cur_conn is not None:
                    cur_conn.close()
                    cur_w.end()

        def _resume_stream(self, dead: WorkerState, raw: str,
                           trace_id: str, stem: Optional[str],
                           watermark: int
                           ) -> Optional[Tuple[WorkerState, Any, Any]]:
            """Re-dispatch a died-mid-stream request to a survivor.  The
            survivor gets the SAME body and trace id plus the resume
            headers: it fetches the store checkpoint by trace id, adopts
            the KV pages through its normal guarded prefill probe, and
            suppresses everything below the forwarded-token watermark.
            Returns ``(worker, conn, resp)`` with inflight begun on the
            worker (the caller owns end()/close()), or None when no
            survivor could continue the stream."""
            for nw in fd.decode_candidates(stem):
                if nw.endpoint == dead.endpoint:
                    continue
                if not nw.breaker.allow():
                    continue
                nw.begin()
                conn = None
                try:
                    conn = http.client.HTTPConnection(
                        nw.host, nw.port, timeout=fd.request_timeout_s)
                    conn.request(
                        "POST", self.path, raw,
                        {"Content-Type": "application/json",
                         "X-Istpu-Trace": trace_id,
                         "X-Istpu-Resume": "1",
                         "X-Istpu-Resume-Watermark": str(watermark)})
                    resp = conn.getresponse()
                except OSError:
                    nw.breaker.record_failure()
                    if conn is not None:
                        conn.close()
                    nw.end()
                    continue
                if resp.status == 200 and resp.getheader(
                        "Content-Type", "").startswith("text/event-stream"):
                    nw.breaker.record_success()
                    fd._c_retry.inc()
                    return nw, conn, resp
                # a non-stream answer (409 resume-unsupported request,
                # 429 shed, 5xx fault): this survivor cannot continue
                # the splice — try the next candidate
                conn.close()
                nw.end()
            return None

    return Handler


def local_fleet(store_port: int, n_prefill: int = 1, n_decode: int = 1,
                *, block_tokens: int = 4, n_blocks: int = 256,
                max_batch: int = 8, decode_chunk: int = 4,
                model_id: str = "fleet-tiny", port: int = 0,
                poll_s: float = 0.5, max_queue: Optional[int] = None,
                n_routers: int = 1, device=None):
    """An in-process tiny-model fleet over a running store node: N
    prefill + M decode ``ServingServer``s (own SHM connections, shared
    deterministic TINY weights) behind ``n_routers`` ``FrontDoor``
    replicas over the SAME pools (each naming the others as peers) —
    the zero-setup target for the disagg smoke and the chaos tests.
    ``kv_quant=None`` keeps handoff byte-exact, so fleet decode tokens
    must equal a monolith's.

    The workers are the port's engines on ``device`` (``None``: the GPU,
    raising when there is none; the tests pass ``"cpu"``), over TINY in
    float32 with weights drawn by ``init_params`` from a generator seeded
    0 on that device.

    Returns ``(fd, workers, close)`` — ``fd`` is the FIRST router
    replica, ``workers`` maps role → list of servers and additionally
    ``"router"`` → every replica; ``close()`` tears everything down (not
    the store)."""
    import torch

    from . import lib as ist
    from . import resolve_device
    from .engine import InferenceEngine
    from .kv import PagedCacheConfig
    from .models import TINY, init_params, scaled
    from .serve import ServingServer

    dev = resolve_device(device)
    cfg = scaled(TINY, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def make_pc():
        return PagedCacheConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, n_blocks=n_blocks,
            block_tokens=block_tokens, dtype=cfg.dtype,
        )

    conns, engines, servers = [], [], {"prefill": [], "decode": []}
    for role, count in (("prefill", n_prefill), ("decode", n_decode)):
        for _ in range(count):
            conn = ist.InfinityConnection(ist.ClientConfig(
                host_addr="127.0.0.1", service_port=store_port,
                connection_type=ist.TYPE_SHM, op_timeout_s=30.0,
                log_level="warning"))
            conn.connect()
            conns.append(conn)
            eng = InferenceEngine(params, cfg, make_pc(), conn=conn,
                                  model_id=model_id, kv_quant=None,
                                  device=dev)
            eng.decode_chunk = decode_chunk
            engines.append(eng)
            srv = ServingServer(eng, port=0, max_batch=max_batch,
                                model_id=model_id, role=role,
                                max_queue=max_queue)
            srv.start()
            servers[role].append(srv)
    prefill_urls = [f"http://127.0.0.1:{s.port}" for s in servers["prefill"]]
    decode_urls = [f"http://127.0.0.1:{s.port}" for s in servers["decode"]]
    routers = compose_routers(prefill_urls, decode_urls, n_routers,
                              port=port, poll_s=poll_s)
    servers["router"] = routers
    fd = routers[0]

    def close() -> None:
        for r in routers:
            r.close()
        for role in ("prefill", "decode"):
            for s in servers[role]:
                s.close()
        for e in engines:
            e.transfer.close()  # unpins the pool before its unmap
        for c in conns:
            c.close()

    return fd, servers, close


def compose_routers(prefill_urls: List[str], decode_urls: List[str],
                    n_routers: int = 1, *, port: int = 0,
                    poll_s: float = 0.5) -> List[FrontDoor]:
    """``n_routers`` started ``FrontDoor`` replicas over the same worker
    pools, each naming the others as peers; the first listens on ``port``
    (0: an ephemeral one), the rest on ephemeral ports."""
    routers: List[FrontDoor] = []
    for i in range(max(1, n_routers)):
        r = FrontDoor(prefill_urls, decode_urls,
                      port=port if i == 0 else 0, poll_s=poll_s)
        r.start()
        routers.append(r)
    # each replica names its siblings (the fleet-merged /debug/fleet
    # view); routing itself never consults peers — zero coordination
    for r in routers:
        r.peers = [f"http://127.0.0.1:{o.port}"
                   for o in routers if o is not r]
        r._g_replicas.set(1 + len(r.peers))
    return routers


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(
        "istpu-frontdoor",
        description="disaggregated-fleet front door: routes prefill to "
                    "the least-loaded prefill worker, hands KV off "
                    "through the store, and dispatches decode by "
                    "prefix affinity")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--prefill-workers", default=None,
                    help="comma-separated prefill worker base URLs "
                         "(serve.py --role prefill); default env "
                         "ISTPU_PREFILL_WORKERS.  Empty = no prefill "
                         "pool: every request decodes cold (recompute)")
    ap.add_argument("--decode-workers", default=None,
                    help="comma-separated decode worker base URLs "
                         "(serve.py --role decode); default env "
                         "ISTPU_DECODE_WORKERS.  Required")
    ap.add_argument("--poll-interval", type=float, default=1.0,
                    help="seconds between /healthz+/metrics polls of "
                         "every worker")
    ap.add_argument("--handoff-timeout", type=float, default=120.0,
                    help="prefill leg deadline (s): past it the request "
                         "degrades to recompute-on-decode")
    ap.add_argument("--request-timeout", type=float, default=600.0,
                    help="decode leg deadline (s)")
    ap.add_argument("--affinity-tokens", type=int, default=16,
                    help="prompt-stem length (tokens) keying decode "
                         "placement: same stem, same decode worker")
    ap.add_argument("--peers", default=None,
                    help="comma-separated sibling router base URLs "
                         "(default env ISTPU_FD_PEERS).  Replicas need "
                         "no coordination — peers only feed the "
                         "istpu_fd_router_replicas gauge and the "
                         "fleet-merged /debug/fleet?merged=1 view")
    ap.add_argument("--log-level", default="info")
    args = ap.parse_args(argv)
    Logger.set_log_level(args.log_level)

    def split(spec: Optional[str], env: str) -> List[str]:
        spec = spec or os.environ.get(env, "")
        return [u.strip() for u in spec.split(",") if u.strip()]

    prefill = split(args.prefill_workers, "ISTPU_PREFILL_WORKERS")
    decode = split(args.decode_workers, "ISTPU_DECODE_WORKERS")
    if not decode:
        ap.error("--decode-workers (or ISTPU_DECODE_WORKERS) is required")
    fd = FrontDoor(prefill, decode, host=args.host, port=args.port,
                   poll_s=args.poll_interval,
                   handoff_timeout_s=args.handoff_timeout,
                   request_timeout_s=args.request_timeout,
                   affinity_tokens=args.affinity_tokens,
                   peers=split(args.peers, "ISTPU_FD_PEERS"))
    fd.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        fd.close()
    return 0


if __name__ == "__main__":
    main()
