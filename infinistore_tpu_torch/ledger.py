"""Per-request lifecycle ledger: one structured record per served request.

The serving metrics (`istpu_serve_*` histograms) answer "how is the
fleet doing"; they cannot answer "where did *this* request's 1.4 s go".
The ledger is the per-request view: every request that leaves the
scheduler — completed, cancelled, or dropped by an engine fault — folds
its lifecycle stamps into one record (submit → admit → store lookup
hit/miss → first token → per-chunk token deliveries → done), joined to
the trace id the HTTP handler bound at submission, with a
**latency-attribution waterfall** derived from the stamps the scheduler
already keeps:

* ``queue_s``  — submit → prefill start (admission);
* ``store_s``  — wall time of the store hops inside prefill
  (prefix lookup + page load, measured by the engine);
* ``prefill_s`` — prefill start → the last prefill chunk returning the
  request's state, minus the store share (the compute half of TTFT);
* ``first_hold_s`` — that state → the first visible token: the decode
  chunk that samples the first token and the boundary that shows it
  (0 without the scheduler's ``t_prefilled`` stamp: then ``prefill_s``
  runs to the first visible token);
* ``decode_s`` — first token → retirement, minus the stream share;
* ``stream_s`` — accumulated time inside the ``on_token`` delivery
  callback (slow SSE consumers and handler-queue backpressure land
  here, not in "decode").

The six slices sum to the end-to-end latency, so ``shares`` is a
waterfall, not a soup of overlapping timers.

Records live in a bounded ring (``ISTPU_LEDGER_RING``, default 256) and
are exported at the serving front-end's ``GET /debug/requests``
(``?limit=N`` caps the tail returned).  Each record also carries
``step_ids`` — the engine steps that served the request (stamped by the
scheduler when a ``StepProfiler`` is attached) — so ledger rows join
the per-step attribution records at ``GET /debug/engine``.  Each record is also emitted as
one line through the shared ``infinistore_tpu`` logger at INFO with the
request's OWN trace id stamped (``trace_id=``), so grepping the server
log for a trace id from a Perfetto export finds the matching ledger
line — logs, traces, and the ledger join on one key.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# token-delivery stamps kept per record: enough to see chunk cadence
# (decode-chunk boundaries) without letting a 100k-token request bloat
# the ring
MAX_STAMPS = 64


def _r(x: Optional[float], nd: int = 6) -> Optional[float]:
    return None if x is None else round(x, nd)


def build_record(req, outcome: str,
                 wall: Optional[float] = None) -> Dict[str, Any]:
    """Fold a finished ``scheduler.Request`` into one ledger record.

    Pure in the request (reads stamps, mutates nothing) so tests can
    feed synthetic requests with injected clocks.  ``outcome`` is
    ``done`` / ``cancelled`` / ``error``; missing stamps (a request
    cancelled while still queued has no ``t_admit``) degrade the
    waterfall gracefully — whatever window exists is attributed, the
    rest is zero."""
    t_submit = req.t_submit
    t_admit = req.t_admit or None
    t_first = req.t_first or None
    t_done = req.t_done or None
    t_prefilled = getattr(req, "t_prefilled", 0.0) or None
    n_out = len(req.output)
    e2e = (t_done - t_submit) if t_done else None
    ttft = (t_first - t_submit) if t_first else None
    tpot = ((t_done - t_first) / (n_out - 1)
            if t_done and t_first and n_out > 1 else None)

    st = req.state
    reused = getattr(st, "reused_chunks", 0) if st is not None else 0
    local = getattr(st, "local_chunks", 0) if st is not None else 0
    store = getattr(st, "store_chunks", 0) if st is not None else 0
    store_s = getattr(st, "store_load_s", 0.0) if st is not None else 0.0

    # the waterfall: each slice is a disjoint window of the request's
    # end-to-end wall time (stream time is carved OUT of decode, store
    # time OUT of prefill), so the slices sum to e2e
    queue_s = ((t_admit or t_done or t_submit) - t_submit)
    # prefill start -> first visible token, minus the store share, split
    # where the last chunk returned the state: prefill before it, the hold
    # until the first token shows (a chunk boundary) after it
    prefill_s = first_hold_s = 0.0
    if t_first and t_admit:
        prefill_s = max(0.0, (t_first - t_admit) - store_s)
        if t_prefilled:
            first_hold_s = min(prefill_s, t_first - t_prefilled)
            prefill_s -= first_hold_s
    stream_s = getattr(req, "t_stream_s", 0.0)
    decode_s = max(0.0, (t_done - t_first) - stream_s) \
        if t_done and t_first else 0.0
    waterfall = {
        "queue_s": _r(queue_s), "store_s": _r(store_s),
        "prefill_s": _r(prefill_s), "first_hold_s": _r(first_hold_s),
        "decode_s": _r(decode_s), "stream_s": _r(stream_s),
    }
    total = sum(v for v in waterfall.values() if v) or 1.0
    shares = {k[:-2]: _r((waterfall[k] or 0.0) / total, 4) for k in waterfall}

    events = [("submit", 0.0)]
    if t_admit:
        events.append(("admit", _r(t_admit - t_submit)))
    if t_first:
        events.append(("first_token", _r(t_first - t_submit)))
    if t_done:
        events.append((outcome if outcome != "done" else "done",
                       _r(t_done - t_submit)))
    # handler staging -> scheduler submit (the pre-engine share of the
    # CLIENT's TTFT; outside the e2e window, so reported beside the
    # waterfall rather than inside it).  0.0 for direct library callers.
    t_stage = getattr(req, "t_stage", 0.0)
    admission_wait_s = max(0.0, t_submit - t_stage) if t_stage else 0.0
    return {
        "req_id": req.req_id,
        "trace_id": getattr(req, "trace_id", None),
        # lane label = tenant axis: the named tenant when one was given,
        # the stringified priority otherwise (usage-ledger join key)
        "lane": (getattr(req, "tenant", None) or str(req.priority)),
        "outcome": outcome,
        "prompt_tokens": len(req.tokens),
        "output_tokens": n_out,
        "max_new_tokens": req.max_new_tokens,
        "wall_done": _r(wall if wall is not None else time.time(), 3),
        "ttft_s": _r(ttft),
        "tpot_s": _r(tpot),
        "e2e_s": _r(e2e),
        "admission_wait_s": _r(admission_wait_s),
        "store": {
            "reused_chunks": reused, "local_chunks": local,
            "store_chunks": store, "hit": store > 0, "load_s": _r(store_s),
        },
        "waterfall": waterfall,
        "shares": shares,
        "events": events,
        "token_stamps": list(getattr(req, "stamps", ())),
        # engine steps this request rode (newest window, capped by the
        # scheduler) — join key against the step profiler's
        # /debug/engine records: a slow request's waterfall points at
        # the exact steps (and their dispatch/stall/retrace records)
        # that served it
        "step_ids": list(getattr(req, "step_ids", ())),
    }


class RequestLedger:
    """Bounded ring of per-request lifecycle records.

    Thread-safe: the scheduler records from the engine thread (and
    ``cancel`` from handler threads); ``tail`` reads from HTTP handler
    threads.  ``recorded`` counts lifetime records, so ring overflow is
    observable (``recorded - len(tail())`` records scrolled away)."""

    def __init__(self, capacity: Optional[int] = None, log: bool = True,
                 sink=None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("ISTPU_LEDGER_RING", "") or 256)
            except ValueError:
                capacity = 256
        self.capacity = max(1, capacity)
        self._ring: "deque" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._log = log
        # called with each finished record (the stage ledger's fold
        # hook); guarded — a raising sink must never take down the
        # engine loop that records retirements
        self._sink = sink
        self.recorded = 0

    def record(self, req, outcome: str) -> Dict[str, Any]:
        rec = build_record(req, outcome)
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1
        if self._sink is not None:
            try:
                self._sink(rec)
            except Exception:  # noqa: BLE001 — observability stays off
                pass           # the engine loop's failure path
        if self._log:
            # one line per request through the SHARED logger, stamped
            # with the request's own trace id (the logging filter
            # honors a pre-set trace_id), so `grep trace_id=...` joins
            # server logs with the trace ring and this ledger
            logging.getLogger("infinistore_tpu").info(
                "ledger req=%s lane=%s outcome=%s ttft_ms=%s tpot_ms=%s "
                "e2e_ms=%s out=%d store_hit=%s",
                rec["req_id"], rec["lane"], outcome,
                _ms(rec["ttft_s"]), _ms(rec["tpot_s"]), _ms(rec["e2e_s"]),
                rec["output_tokens"], rec["store"]["hit"],
                extra={"trace_id": rec["trace_id"] or "-"},
            )
        return rec

    def tail(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last records; ``limit`` caps the tail returned."""
        with self._lock:
            recs = list(self._ring)
        if limit is not None and limit >= 0:
            recs = recs[len(recs) - min(limit, len(recs)):]
        return recs

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """The ``/debug/requests`` payload."""
        recs = self.tail(limit)
        return {
            "capacity": self.capacity,
            "recorded": self.recorded,
            "returned": len(recs),
            "records": recs,
        }


def _ms(s: Optional[float]) -> Optional[float]:
    return None if s is None else round(s * 1e3, 2)
