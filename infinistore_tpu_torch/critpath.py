"""Span-derived stage ledger: canonical per-request latency attribution.

The request ledger answers "where did *this* request's time go" with a
five-slice waterfall; the metrics answer "how is the fleet doing" in
aggregate.  Neither names the **stage** that owns TTFT across the
disaggregated path (router → prefill → store → decode), which is the
question every latency regression reduces to.  This module folds every
retired request into one canonical stage decomposition:

* ``admission_wait``    — HTTP handler staging → scheduler submit;
* ``queue_wait``        — submit → prefill admission (prefill worker);
* ``prefill_compute``   — prefill window minus the store share;
* ``kv_flush``          — the `/v1/prefill` flush barrier (annotated by
  the handler after retirement — it runs outside the engine window);
* ``store_transfer``    — wall time inside store hops (lookup + load);
* ``decode_queue``      — the decode worker's pre-admission share
  (router-grain remap; always 0 at worker grain);
* ``first_token``       — first-token delivery gap past prefill (the
  ledger's ``first_hold_s``: the decode chunk that samples and shows it);
* ``per_token_decode``  — steady-state decode + stream delivery;
* ``unattributed``      — wall clock nothing above claims (stitch gaps,
  router overhead) — reported explicitly, never silently dropped.

Rows land in a bounded ring joinable to `/debug/requests` by trace id,
and every stage observation feeds ``istpu_critpath_stage_seconds``
(labels ``stage``, ``lane``), so Prometheus can trend per-stage p99
without the ring.  ``GET /debug/critpath`` serves :meth:`snapshot`:
p50/p99 TTFT by stage, the dominant stage, and worst-offender trace
ids, per lane and overall.  The fold itself runs in the request
ledger's sink (one dict of float math per retirement, off the step hot
path); untraced requests never touch this module mid-request, keeping
the no-trace fast path at one contextvar read.

The router merges worker rows by trace id (:func:`merge_mesh_rows`):
a prefill worker's whole row is TTFT-side, a decode worker's
queue/compute remap to ``decode_queue``/``first_token``, and the gap
between the router-measured TTFT and the mapped stage sum is the
``unattributed`` remainder.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

STAGES = (
    "admission_wait",
    "queue_wait",
    "prefill_compute",
    "kv_flush",
    "store_transfer",
    "decode_queue",
    "first_token",
    "per_token_decode",
    "unattributed",
)

# every stage on the TTFT path (everything except steady-state decode):
# the decomposition /debug/critpath sums against measured TTFT
TTFT_STAGES = tuple(s for s in STAGES if s != "per_token_decode")

# router-grain remap of a decode worker's row: its own admission/queue
# window is the fleet's decode_queue, its "prefill" (prefix adoption +
# compute up to the first emitted token) is the fleet's first_token
_DECODE_REMAP = {
    "admission_wait": "decode_queue",
    "queue_wait": "decode_queue",
    "prefill_compute": "first_token",
}

# a prefill worker's throwaway decode token is handoff cost, not fleet
# decode: the whole row folds into the TTFT side
_PREFILL_REMAP = {
    "first_token": "prefill_compute",
    "per_token_decode": "prefill_compute",
}

_ROLE_REMAP = {"decode": _DECODE_REMAP, "prefill": _PREFILL_REMAP}


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def decompose(rec: Dict[str, Any]) -> Dict[str, float]:
    """Map one request-ledger record onto the canonical stages (pure;
    seconds).  The waterfall slices are disjoint and sum to e2e, so the
    stage sum equals ``admission_wait + e2e`` up to rounding — any
    positive residual lands in ``unattributed``."""
    wf = rec.get("waterfall") or {}
    adm = rec.get("admission_wait_s") or 0.0
    queue = wf.get("queue_s") or 0.0
    store = wf.get("store_s") or 0.0
    prefill = wf.get("prefill_s") or 0.0
    # prefilled -> first visible token: the hold for the decode chunk
    # that samples and shows the first token
    hold = wf.get("first_hold_s") or 0.0
    decode = wf.get("decode_s") or 0.0
    stream = wf.get("stream_s") or 0.0
    ttft = rec.get("ttft_s")
    stamps = rec.get("token_stamps") or ()
    # first-token delivery gap: prefill produced the token at t_first,
    # the first chunk-boundary stamp is when it became visible
    first_gap = 0.0
    if stamps and ttft:
        first_gap = min(max(0.0, float(stamps[0][0]) - ttft),
                        decode + stream)
    stages = {s: 0.0 for s in STAGES}
    stages["admission_wait"] = adm
    stages["queue_wait"] = queue
    stages["prefill_compute"] = prefill
    stages["store_transfer"] = store
    stages["first_token"] = hold + first_gap
    stages["per_token_decode"] = max(0.0, decode + stream - first_gap)
    e2e = rec.get("e2e_s")
    if e2e:
        claimed = sum(stages.values())
        stages["unattributed"] = max(0.0, (adm + e2e) - claimed)
    return stages


def merge_mesh_rows(worker_rows: List[Dict[str, Any]],
                    note: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Fold one request's per-worker rows (each tagged with its worker's
    ``role``) into one router-grain row.  ``note`` is the router's own
    measurement for the request (``ttft_s``/``e2e_s``/``lane``); the
    gap between router TTFT and the mapped stage sum is reported as
    ``unattributed`` — the acceptance remainder, visible not dropped."""
    stages = {s: 0.0 for s in STAGES}
    lane = None
    trace_id = None
    roles: List[str] = []
    for row in worker_rows:
        remap = _ROLE_REMAP.get(row.get("role") or "", {})
        for s, v in (row.get("stages") or {}).items():
            if s in stages:
                stages[remap.get(s, s)] += v or 0.0
        lane = lane or row.get("lane")
        trace_id = trace_id or row.get("trace_id")
        if row.get("role"):
            roles.append(row["role"])
    ttft_sum = sum(stages[s] for s in TTFT_STAGES)
    ttft = (note or {}).get("ttft_s")
    e2e = (note or {}).get("e2e_s")
    if ttft:
        stages["unattributed"] += max(0.0, ttft - ttft_sum)
    return {
        "trace_id": trace_id,
        "lane": (note or {}).get("lane") or lane,
        "role": "router",
        "roles": roles,
        "outcome": "done",
        "ttft_s": ttft if ttft else ttft_sum,
        "e2e_s": e2e if e2e else sum(stages.values()),
        "stages": stages,
    }


def aggregate(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """p50/p99 TTFT + per-stage quantiles, the dominant stage, and
    worst-offender trace ids over a set of rows (pure; used by the
    worker snapshot AND the router's merged view so both grains answer
    with one shape)."""
    ttfts = sorted(r["ttft_s"] for r in rows if r.get("ttft_s"))
    per_stage: Dict[str, List[float]] = {s: [] for s in STAGES}
    for r in rows:
        for s in STAGES:
            per_stage[s].append((r.get("stages") or {}).get(s) or 0.0)
    for s in STAGES:
        per_stage[s].sort()
    stage_p50 = {s: round(_pct(per_stage[s], 0.50) * 1e3, 3)
                 for s in STAGES}
    stage_p99 = {s: round(_pct(per_stage[s], 0.99) * 1e3, 3)
                 for s in STAGES}
    ttft_p50 = round(_pct(ttfts, 0.50) * 1e3, 3)
    ttft_p99 = round(_pct(ttfts, 0.99) * 1e3, 3)
    # share of p99 TTFT per TTFT-path stage — the stage-budget watchdog's
    # input (an approximation: per-stage p99 over TTFT p99, the standard
    # "who owns the tail" reading)
    share_p99 = {
        s: (round(stage_p99[s] / ttft_p99, 4) if ttft_p99 > 0 else 0.0)
        for s in TTFT_STAGES
    }
    dominant = max(TTFT_STAGES, key=lambda s: stage_p50[s]) \
        if rows else None
    worst = sorted((r for r in rows if r.get("ttft_s")),
                   key=lambda r: -(r["ttft_s"] or 0.0))[:3]
    return {
        "count": len(rows),
        "ttft_p50_ms": ttft_p50,
        "ttft_p99_ms": ttft_p99,
        "ttft_stage_p50_sum_ms": round(
            sum(stage_p50[s] for s in TTFT_STAGES), 3),
        "stage_p50_ms": stage_p50,
        "stage_p99_ms": stage_p99,
        "stage_share_p99": share_p99,
        "dominant_stage": dominant,
        "worst": [{"trace_id": r.get("trace_id"),
                   "ttft_ms": round((r["ttft_s"] or 0.0) * 1e3, 3),
                   "dominant_stage": max(
                       TTFT_STAGES,
                       key=lambda s, _r=r: (_r.get("stages") or {})
                       .get(s) or 0.0)}
                  for r in worst],
    }


class StageLedger:
    """Bounded ring of stage rows + the per-stage histogram families.

    Thread-safe: folds arrive from the engine thread (the request
    ledger's sink), ``annotate`` from handler threads, snapshots from
    HTTP handlers."""

    def __init__(self, capacity: int = 256, metrics=None,
                 role: str = "monolith"):
        self.capacity = max(1, capacity)
        self.role = role
        self._ring: deque = deque(maxlen=self.capacity)
        self._by_trace: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self.recorded = 0
        self._h_stage = None
        if metrics is not None:
            self._h_stage = metrics.histogram(
                "istpu_critpath_stage_seconds",
                "Canonical per-request stage decomposition (seconds) by "
                "stage and lane — the fleet-wide latency-attribution "
                "families /debug/critpath summarizes",
                labelnames=("stage", "lane"),
            )

    # -- recording --

    def fold(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """The request-ledger sink: one retired request -> one stage row
        (plain float math; never raises into the engine loop — the
        ledger guards the call, this keeps the body cheap)."""
        stages = decompose(rec)
        adm = rec.get("admission_wait_s") or 0.0
        ttft = rec.get("ttft_s")
        e2e = rec.get("e2e_s")
        row = {
            "trace_id": rec.get("trace_id"),
            "req_id": rec.get("req_id"),
            "lane": rec.get("lane"),
            "role": self.role,
            "outcome": rec.get("outcome"),
            # client-facing: measured from handler staging, so the sum
            # of TTFT stages reproduces what the CALLER saw
            "ttft_s": (adm + ttft) if ttft else None,
            "e2e_s": (adm + e2e) if e2e else None,
            "wall_done": rec.get("wall_done"),
            "stages": stages,
        }
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                old = self._ring[0]
                if old.get("trace_id"):
                    self._by_trace.pop(old["trace_id"], None)
            self._ring.append(row)
            if row["trace_id"]:
                self._by_trace[row["trace_id"]] = row
            self.recorded += 1
        if self._h_stage is not None:
            lane = row["lane"] or "-"
            for s, v in stages.items():
                self._h_stage.labels(stage=s, lane=lane).observe(v)
        return row

    def annotate(self, trace_id: Optional[str], stage: str,
                 seconds: float) -> bool:
        """Add externally-timed work to a retired request's row by trace
        id (the `/v1/prefill` flush barrier runs AFTER retirement, on
        the handler thread).  Best-effort: False for unknown ids."""
        if not trace_id or stage not in STAGES:
            return False
        with self._lock:
            row = self._by_trace.get(trace_id)
            if row is None:
                return False
            row["stages"][stage] = (row["stages"].get(stage) or 0.0) \
                + seconds
            if row.get("ttft_s") is not None and stage in TTFT_STAGES:
                row["ttft_s"] += seconds
        if self._h_stage is not None:
            self._h_stage.labels(stage=stage,
                                 lane=row.get("lane") or "-") \
                .observe(seconds)
        return True

    # -- export --

    def rows(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit >= 0:
            out = out[len(out) - min(limit, len(out)):]
        return out

    def shares(self) -> Dict[str, float]:
        """Per-stage share of p99 TTFT over the current ring — the
        stage-budget watchdog's probe payload."""
        rows = self.rows()
        if not rows:
            return {}
        return aggregate(rows)["stage_share_p99"]

    def snapshot(self, limit: Optional[int] = None,
                 include_rows: bool = True) -> Dict[str, Any]:
        """The ``/debug/critpath`` payload: overall + per-lane
        aggregates, stage taxonomy, and (optionally) the row tail."""
        rows = self.rows()
        lanes: Dict[str, List[Dict[str, Any]]] = {}
        for r in rows:
            lanes.setdefault(r.get("lane") or "-", []).append(r)
        out = {
            "enabled": True,
            "role": self.role,
            "capacity": self.capacity,
            "recorded": self.recorded,
            "stages": list(STAGES),
            "ttft_stages": list(TTFT_STAGES),
            "generated_at": round(time.time(), 3),
            "overall": aggregate(rows),
            "lanes": {lane: aggregate(rws) for lane, rws in lanes.items()},
        }
        if include_rows:
            tail = rows
            if limit is not None and limit >= 0:
                tail = tail[len(tail) - min(limit, len(tail)):]
            out["rows"] = tail
            out["returned"] = len(tail)
        return out
