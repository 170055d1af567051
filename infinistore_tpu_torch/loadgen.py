"""Open-loop load generation for the serving front-end.

The serving stack had only ever been driven closed-loop (a handful of
clients, each waiting for its response before sending the next) — a
shape that can never overload anything and therefore can never find the
knee of the latency curve.  This module is the open-loop harness the
SLO work needs: requests fire on an **arrival process** (Poisson or
deterministic) independent of completions, exactly the way tenant
traffic arrives, so pushing the arrival rate past capacity produces the
real failure shape (queue growth → TTFT blowup → SLO misses) instead of
self-throttling.  DistServe/Mooncake-style serving work optimizes
**goodput** — requests per second that complete AND meet their SLOs —
and that is the headline number ``summarize`` computes.

Pieces:

* ``arrival_offsets`` — the arrival process as a pure function (seeded
  RNG in, offsets out), so timing math is testable without a clock;
* ``LoadConfig`` — arrival rate/process, prompt/output-length mix,
  priority-lane weights, and a shared-prefix population (``n_prefixes``
  prefixes of ``prefix_len`` tokens; each request prepends one with
  probability ``prefix_frac`` — the system-prompt shape that makes the
  store tier's prefix reuse matter under load);
* ``run_load`` — fires one schedule against a live server (or a LIST of
  router replicas: requests spread round-robin and fail over to the
  next replica on connect error).  The default pacer is a single
  asyncio event loop + a hand-rolled streaming HTTP/1.1 client, so ONE
  process sustains tens of thousands of concurrent SSE sessions — a
  thread per in-flight stream caps out three orders of magnitude
  earlier.  ``pacer="thread"`` keeps the original thread-per-request
  pacer as an escape hatch, and it is ALSO the deterministic-test seam:
  injecting ``clock``/``sleep``/``post`` selects it automatically so
  the pacing math stays drivable with a virtual clock and no sockets;
* ``summarize`` — per-lane TTFT/TPOT p50/p99 (nearest-rank, the repo's
  one percentile definition), SLO attainment, goodput, and the
  resumption ledger (``resumed``/``stalled``/``max_stall_ms`` — a
  mid-stream decode death that the mesh spliced onto a survivor shows
  up here as a stall, NOT as an error);
* ``sweep`` — the goodput-vs-rate curve: one ``run_load`` +
  ``summarize`` per arrival rate.

Conversation mode (``SessionConfig`` / ``make_sessions`` /
``run_sessions``) layers multi-turn sessions over the same open-loop
pacer: SESSION arrivals are open-loop (Poisson/deterministic, exactly
like single-shot requests), while turns WITHIN a session are closed-loop
by construction — a user cannot type turn 3 before reading turn 2.
Each turn's prompt is the prior context plus new user tokens and carries
a ``"session"`` id, which is the traffic shape that makes the store
tier's cross-turn KV persistence measurable (sessions.py derives the
re-prefill waste from it).  ``session_summary`` reduces the per-turn
results to the contract numbers: per-turn TTFT and its slope.

``bench_serve.py`` (repo root) is the CLI over this module; its
``--json-out`` record joins the bench-schema family
(docs/observability.md).
"""

from __future__ import annotations

import asyncio
import http.client
import json
import random
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)
from urllib.parse import urlsplit

from .utils.metrics import nearest_rank

Urls = Union[str, Sequence[str]]


def _norm_urls(url: Urls) -> List[str]:
    """One URL or a router-replica list → a non-empty list of base
    URLs.  Every client entry point takes either spelling."""
    urls = [url] if isinstance(url, str) else list(url)
    if not urls:
        raise ValueError("need at least one target URL")
    return [u if "//" in u else f"http://{u}" for u in urls]


def arrival_offsets(rate: float, n: int, process: str = "poisson",
                    rng: Optional[random.Random] = None) -> List[float]:
    """Arrival times (seconds from t0) for ``n`` requests at ``rate``
    req/s.  ``deterministic``: evenly spaced 1/rate apart.  ``poisson``:
    exponential inter-arrivals (the memoryless process real independent
    tenants produce — bursts included, which is the point).  Pure given
    the RNG, so tests assert the math without any clock."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    if n < 0:
        raise ValueError("n must be >= 0")
    if process == "deterministic":
        return [i / rate for i in range(n)]
    if process != "poisson":
        raise ValueError(f"unknown arrival process {process!r}")
    rng = rng or random.Random(0)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


@dataclass
class LoadConfig:
    """One load run's shape.  ``mix`` rows are ``(weight, prompt_tokens,
    max_tokens)``; ``lanes`` rows are ``(priority, weight)`` — the
    priority value becomes the server-side lane label."""

    rate: float = 4.0
    n_requests: int = 32
    process: str = "poisson"
    seed: int = 0
    mix: Sequence[Tuple[float, int, int]] = ((1.0, 24, 8),)
    # lane rows are (lane, weight); a lane may be an int priority (the
    # classic spelling) or a STRING tenant id ("acme") — named tenants
    # ride the priority field as a string and the server maps them onto
    # the tenant/lane label (usage ledger, quotas, per-lane SLO metrics)
    lanes: Sequence[Tuple[Any, float]] = ((0, 1.0),)
    # shared-prefix population: tenant/system-prompt traffic shape
    n_prefixes: int = 4
    prefix_len: int = 16
    prefix_frac: float = 0.5
    vocab: int = 256          # token ids drawn in [0, vocab)
    stream: bool = True       # SSE streaming (client-observed TTFT)
    timeout_s: float = 120.0  # per-request HTTP timeout
    # a 429-shed request may honor the server's Retry-After once: sleep
    # (capped at retry_cap_s) and re-attempt a single time.  Off by
    # default — the open-loop measurement should see raw shed behavior
    honor_retry_after: bool = False
    retry_cap_s: float = 10.0
    extra_body: Dict[str, Any] = field(default_factory=dict)


def _weighted_choice(rng: random.Random, rows, key=lambda r: r[-1]):
    total = sum(key(r) for r in rows)
    x = rng.random() * total
    for r in rows:
        x -= key(r)
        if x <= 0:
            return r
    return rows[-1]


def make_requests(cfg: LoadConfig) -> List[Dict[str, Any]]:
    """The request population for one run: token-id prompts (no
    tokenizer needed server-side), lane-tagged, with a shared-prefix
    subset.  Deterministic in ``cfg.seed``."""
    rng = random.Random(cfg.seed)
    prefixes = [
        [rng.randrange(cfg.vocab) for _ in range(cfg.prefix_len)]
        for _ in range(max(0, cfg.n_prefixes))
    ]
    out = []
    for _ in range(cfg.n_requests):
        _w, plen, mtok = _weighted_choice(rng, list(cfg.mix),
                                          key=lambda r: r[0])
        lane, _w = _weighted_choice(rng, list(cfg.lanes))
        prompt: List[int] = []
        if prefixes and rng.random() < cfg.prefix_frac:
            prompt += prefixes[rng.randrange(len(prefixes))]
        need = max(1, plen - len(prompt))
        prompt += [rng.randrange(cfg.vocab) for _ in range(need)]
        body = {
            "prompt": prompt, "max_tokens": int(mtok),
            "temperature": 0,
            # a string lane is a named tenant: the server maps it to the
            # tenant/lane label; integer lanes keep the classic meaning
            "priority": lane if isinstance(lane, str) else int(lane),
            "stream": bool(cfg.stream),
        }
        body.update(cfg.extra_body)
        out.append(body)
    return out


def _base_result(body: Dict[str, Any], trace_id: str) -> Dict[str, Any]:
    """The per-request result skeleton both clients fill in — one
    schema, whichever pacer produced it."""
    return {
        "ok": False, "status": 0, "error": None, "tokens": 0,
        "trace_id": trace_id,
        "lane": body.get("priority", 0),
        # a shed is not a failure: summarize counts it separately so
        # goodput/error math stays honest under admission control
        "rejected": False,
        "retry_after_s": None,
        "ttft_s": None, "tpot_s": None, "e2e_s": None,
        # resumption ledger: ": istpu-resume" SSE comments mark a
        # mid-stream splice onto a survivor (stall, NOT an error);
        # max_stall_s is the widest inter-chunk gap the client saw
        "resumed": 0, "stalled": False, "max_stall_s": None,
    }


def _finish_result(r: Dict[str, Any], t0: float, t1: float,
                   first: Optional[float], last: Optional[float]) -> None:
    tokens = r["tokens"]
    r["ok"] = r["status"] == 200 and r["error"] is None and tokens > 0
    r["ttft_s"] = (first - t0) if first is not None else None
    r["tpot_s"] = ((last - first) / (tokens - 1)
                   if r["ok"] and first is not None and last is not None
                   and tokens > 1 else None)
    r["e2e_s"] = t1 - t0
    r["stalled"] = r["resumed"] > 0


def _http_post(url: Urls, body: Dict[str, Any], timeout_s: float,
               honor_retry_after: bool = False,
               retry_cap_s: float = 10.0,
               sleep: Callable[[float], None] = time.sleep,
               start: int = 0) -> Dict[str, Any]:
    """POST one completion request (optionally honoring one 429
    Retry-After).  A shed (429) is a *rejection*, not an error: the
    result carries ``rejected: True`` + the parsed ``retry_after_s`` so
    ``summarize`` keeps the goodput math honest."""
    r = _http_post_once(url, body, timeout_s, start=start)
    if r["rejected"] and honor_retry_after:
        # a single polite re-attempt at the server's suggested time
        # (capped): rejected-then-completed counts as completed, with
        # the wait inside its e2e
        sleep(min(r.get("retry_after_s") or retry_cap_s, retry_cap_s))
        r2 = _http_post_once(url, body, timeout_s, start=start)
        r2["reattempted"] = True
        return r2
    return r


def _http_post_once(url: Urls, body: Dict[str, Any],
                    timeout_s: float, start: int = 0) -> Dict[str, Any]:
    """POST one completion request; parse the SSE stream for the
    client-observed first-token and last-token stamps plus the
    resumption ledger.  Given a router LIST, connect errors fail over
    to the next replica (rotation starts at ``start`` so a fleet of
    clients spreads across replicas); an error AFTER a response begins
    is a data point, not a retry."""
    urls = _norm_urls(url)
    # a client-minted trace id: the server/front door CONTINUES it, so
    # this request's client-observed TTFT joins its server-side stage
    # rows (/debug/critpath) and stitched timeline (/debug/trace/{id})
    # by one key — no response-header round trip needed
    trace_id = uuid.uuid4().hex
    out = _base_result(body, trace_id)
    t0 = time.perf_counter()
    first = last = None
    resp = conn = None
    for k in range(len(urls)):
        parts = urlsplit(urls[(start + k) % len(urls)])
        try:
            conn = http.client.HTTPConnection(
                parts.hostname, parts.port, timeout=timeout_s
            )
            conn.request(
                "POST", "/v1/completions", json.dumps(body),
                {"Content-Type": "application/json",
                 "X-Istpu-Trace": trace_id},
            )
            resp = conn.getresponse()
            break
        except OSError as e:  # connect/submit failure: next replica
            out["error"] = repr(e)[:200]
            if conn is not None:
                conn.close()
            resp = conn = None
    try:
        if resp is not None:
            out["error"] = None
            out["status"] = status = resp.status
            if status == 429:
                out["rejected"] = True
                # admission shed: Retry-After header first (the HTTP
                # contract), the JSON body's retry_after_s as fallback
                raw = resp.read().decode(errors="replace")
                hdr = resp.getheader("Retry-After")
                try:
                    out["retry_after_s"] = float(hdr) if hdr else None
                except ValueError:
                    out["retry_after_s"] = None
                try:
                    payload = json.loads(raw)
                    out["error"] = str(payload.get("error", raw))[:200]
                    if out["retry_after_s"] is None:
                        ra = payload.get("retry_after_s")
                        out["retry_after_s"] = (float(ra)
                                                if ra is not None else None)
                except (ValueError, TypeError):
                    out["error"] = raw[:200]
            elif status != 200:
                out["error"] = resp.read().decode(errors="replace")[:200]
            elif body.get("stream"):
                for raw in resp:
                    line = raw.strip()
                    if line.startswith(b": istpu-resume"):
                        out["resumed"] += 1
                        continue
                    if not line.startswith(b"data: "):
                        continue
                    data = line[len(b"data: "):]
                    if data == b"[DONE]":
                        break
                    ev = json.loads(data)
                    ch = ev.get("choices", [{}])[0]
                    n_new = len(ch.get("token_ids") or ())
                    if "error" in ev:
                        out["error"] = str(ev["error"])[:200]
                        break
                    if n_new:
                        now = time.perf_counter()
                        if first is None:
                            first = now
                        else:
                            gap = now - last
                            if (out["max_stall_s"] is None
                                    or gap > out["max_stall_s"]):
                                out["max_stall_s"] = gap
                        last = now
                        out["tokens"] += n_new
            else:
                payload = json.loads(resp.read())
                ch = payload.get("choices", [{}])[0]
                out["tokens"] = len(ch.get("token_ids") or ())
                first = last = time.perf_counter()
    except Exception as e:  # noqa: BLE001 — a failed request is a data point
        out["error"] = repr(e)[:200]
    finally:
        if conn is not None:
            conn.close()
    _finish_result(out, t0, time.perf_counter(), first, last)
    return out


# -- asyncio streaming client (the swarm-scale path) ------------------------


async def _a_readline(reader: asyncio.StreamReader,
                      timeout_s: float) -> bytes:
    return await asyncio.wait_for(reader.readline(), timeout_s)


async def _a_http_post_once(urls: List[str], body: Dict[str, Any],
                            timeout_s: float,
                            start: int = 0) -> Dict[str, Any]:
    """One completion request over a raw asyncio socket: hand-written
    HTTP/1.1 (``Connection: close``) + SSE line parsing, so ten
    thousand of these coexist on one event loop with no thread each.
    Same result schema and failover contract as ``_http_post_once``."""
    trace_id = uuid.uuid4().hex
    out = _base_result(body, trace_id)
    t0 = time.perf_counter()
    first = last = None
    reader = writer = None
    payload = json.dumps(body).encode()
    for k in range(len(urls)):
        parts = urlsplit(urls[(start + k) % len(urls)])
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(parts.hostname, parts.port),
                timeout_s)
            req = (
                f"POST /v1/completions HTTP/1.1\r\n"
                f"Host: {parts.hostname}:{parts.port}\r\n"
                f"Content-Type: application/json\r\n"
                f"X-Istpu-Trace: {trace_id}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n"
            ).encode() + payload
            writer.write(req)
            await asyncio.wait_for(writer.drain(), timeout_s)
            status_line = await _a_readline(reader, timeout_s)
            if not status_line:
                raise ConnectionError("empty response")
            break
        except (OSError, asyncio.TimeoutError, ConnectionError) as e:
            out["error"] = repr(e)[:200]
            if writer is not None:
                writer.close()
            reader = writer = None
    try:
        if reader is not None:
            out["error"] = None
            out["status"] = status = int(status_line.split(None, 2)[1])
            headers: Dict[str, str] = {}
            while True:
                line = await _a_readline(reader, timeout_s)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode(errors="replace").partition(":")
                headers[k.strip().lower()] = v.strip()

            async def read_body() -> bytes:
                n = headers.get("content-length")
                if n is not None:
                    return await asyncio.wait_for(
                        reader.readexactly(int(n)), timeout_s)
                return await asyncio.wait_for(reader.read(), timeout_s)

            if status == 429:
                out["rejected"] = True
                raw = (await read_body()).decode(errors="replace")
                hdr = headers.get("retry-after")
                try:
                    out["retry_after_s"] = float(hdr) if hdr else None
                except ValueError:
                    out["retry_after_s"] = None
                try:
                    pl = json.loads(raw)
                    out["error"] = str(pl.get("error", raw))[:200]
                    if out["retry_after_s"] is None:
                        ra = pl.get("retry_after_s")
                        out["retry_after_s"] = (float(ra)
                                                if ra is not None else None)
                except (ValueError, TypeError):
                    out["error"] = raw[:200]
            elif status != 200:
                out["error"] = (await read_body()).decode(
                    errors="replace")[:200]
            elif body.get("stream"):
                while True:
                    raw = await _a_readline(reader, timeout_s)
                    if not raw:
                        break
                    line = raw.strip()
                    if line.startswith(b": istpu-resume"):
                        out["resumed"] += 1
                        continue
                    if not line.startswith(b"data: "):
                        continue
                    data = line[len(b"data: "):]
                    if data == b"[DONE]":
                        break
                    ev = json.loads(data)
                    ch = ev.get("choices", [{}])[0]
                    n_new = len(ch.get("token_ids") or ())
                    if "error" in ev:
                        out["error"] = str(ev["error"])[:200]
                        break
                    if n_new:
                        now = time.perf_counter()
                        if first is None:
                            first = now
                        else:
                            gap = now - last
                            if (out["max_stall_s"] is None
                                    or gap > out["max_stall_s"]):
                                out["max_stall_s"] = gap
                        last = now
                        out["tokens"] += n_new
            else:
                pl = json.loads(await read_body())
                ch = pl.get("choices", [{}])[0]
                out["tokens"] = len(ch.get("token_ids") or ())
                first = last = time.perf_counter()
    except Exception as e:  # noqa: BLE001 — a failed request is a data point
        out["error"] = repr(e)[:200]
    finally:
        if writer is not None:
            writer.close()
    _finish_result(out, t0, time.perf_counter(), first, last)
    return out


async def _a_http_post(urls: List[str], body: Dict[str, Any],
                       timeout_s: float, honor_retry_after: bool = False,
                       retry_cap_s: float = 10.0,
                       start: int = 0) -> Dict[str, Any]:
    r = await _a_http_post_once(urls, body, timeout_s, start=start)
    if r["rejected"] and honor_retry_after:
        await asyncio.sleep(min(r.get("retry_after_s") or retry_cap_s,
                                retry_cap_s))
        r2 = await _a_http_post_once(urls, body, timeout_s, start=start)
        r2["reattempted"] = True
        return r2
    return r


def _pick_pacer(pacer: Optional[str], clock, sleep, post) -> str:
    """Explicit ``pacer`` wins; otherwise injected seams (a virtual
    clock, a fake post) select the thread pacer — they are function
    objects an event loop cannot drive — and live runs get async."""
    if pacer is not None:
        if pacer not in ("async", "thread"):
            raise ValueError(f"unknown pacer {pacer!r}")
        return pacer
    if post is not None or clock is not time.monotonic \
            or sleep is not time.sleep:
        return "thread"
    return "async"


def _tombstone(body: Dict[str, Any], off: float) -> Dict[str, Any]:
    r = _base_result(body, trace_id="")
    r.pop("trace_id")
    r["error"] = "timeout"
    r["sched_off_s"] = round(off, 6)
    r["late_s"] = 0.0
    return r


def run_load(url: Urls, cfg: LoadConfig,
             clock: Callable[[], float] = time.monotonic,
             sleep: Callable[[float], None] = time.sleep,
             post: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]]
             = None, pacer: Optional[str] = None
             ) -> Tuple[List[Dict[str, Any]], float]:
    """Fire ``cfg``'s schedule open-loop against ``url`` (one base URL
    or a router-replica list).  Returns ``(results, makespan_s)`` —
    one result per request, arrival order.

    Open-loop means the pacing loop NEVER waits for a completion.  The
    default ``async`` pacer runs every in-flight stream as a coroutine
    on ONE event loop — a single process drives 10k+ concurrent SSE
    sessions.  ``pacer="thread"`` spawns a thread per arrival (the
    original engine, kept as an escape hatch); injecting ``clock``/
    ``sleep``/``post`` selects it automatically so tests drive the
    pacing math with a virtual clock and capture fire times without
    sockets."""
    offsets = arrival_offsets(cfg.rate, cfg.n_requests, cfg.process,
                              random.Random(cfg.seed))
    bodies = make_requests(cfg)
    mode = _pick_pacer(pacer, clock, sleep, post)
    if mode == "async":
        return _run_load_async(_norm_urls(url), cfg, offsets, bodies)

    counter = iter(range(len(bodies)))
    do_post = post or (lambda b: _http_post(
        url, b, cfg.timeout_s, honor_retry_after=cfg.honor_retry_after,
        retry_cap_s=cfg.retry_cap_s, start=next(counter, 0)))
    results: List[Optional[Dict[str, Any]]] = [None] * cfg.n_requests
    threads: List[threading.Thread] = []
    t0 = clock()

    def fire(i: int, body: Dict[str, Any], late_s: float) -> None:
        r = do_post(body)
        r["sched_off_s"] = round(offsets[i], 6)
        r["late_s"] = round(late_s, 6)
        results[i] = r

    for i, off in enumerate(offsets):
        wait = off - (clock() - t0)
        if wait > 0:
            sleep(wait)
        late = max(0.0, (clock() - t0) - off)
        t = threading.Thread(target=fire, args=(i, bodies[i], late),
                             daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=cfg.timeout_s + 5)
    makespan = clock() - t0
    # a thread that never finished leaves a tombstone, not a None hole
    for i, r in enumerate(results):
        if r is None:
            results[i] = _tombstone(bodies[i], offsets[i])
    return results, makespan  # type: ignore[return-value]


def _run_load_async(urls: List[str], cfg: LoadConfig,
                    offsets: List[float],
                    bodies: List[Dict[str, Any]]
                    ) -> Tuple[List[Dict[str, Any]], float]:
    results: List[Optional[Dict[str, Any]]] = [None] * len(bodies)

    async def fire(i: int, t0: float) -> None:
        loop = asyncio.get_running_loop()
        wait = offsets[i] - (loop.time() - t0)
        if wait > 0:
            await asyncio.sleep(wait)
        late = max(0.0, (loop.time() - t0) - offsets[i])
        try:
            r = await asyncio.wait_for(
                _a_http_post(urls, bodies[i], cfg.timeout_s,
                             honor_retry_after=cfg.honor_retry_after,
                             retry_cap_s=cfg.retry_cap_s, start=i),
                cfg.timeout_s * 2 + cfg.retry_cap_s)
        except Exception as e:  # noqa: BLE001 — a failure is a data point
            r = _tombstone(bodies[i], offsets[i])
            r["error"] = ("timeout" if isinstance(e, asyncio.TimeoutError)
                          else repr(e)[:200])
            results[i] = r
            return
        r["sched_off_s"] = round(offsets[i], 6)
        r["late_s"] = round(late, 6)
        results[i] = r

    async def main() -> float:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.gather(*(fire(i, t0) for i in range(len(bodies))))
        return loop.time() - t0

    makespan = asyncio.run(main())
    for i, r in enumerate(results):
        if r is None:
            results[i] = _tombstone(bodies[i], offsets[i])
    return results, makespan  # type: ignore[return-value]


def _pcts(vals: List[float]) -> Dict[str, float]:
    vs = sorted(vals)
    return {
        "p50_ms": round(nearest_rank(vs, 0.50) * 1e3, 2),
        "p99_ms": round(nearest_rank(vs, 0.99) * 1e3, 2),
    }


def meets_slo(r: Dict[str, Any], slo_ttft_s: float,
              slo_tpot_s: float) -> bool:
    """Did one completed request meet both SLOs?  A request too short to
    have a TPOT (≤1 token) is judged on TTFT alone."""
    if not r.get("ok") or r.get("ttft_s") is None:
        return False
    if r["ttft_s"] > slo_ttft_s:
        return False
    tpot = r.get("tpot_s")
    return tpot is None or tpot <= slo_tpot_s


def summarize(results: List[Dict[str, Any]], makespan_s: float,
              slo_ttft_s: float, slo_tpot_s: float,
              rate: Optional[float] = None) -> Dict[str, Any]:
    """One run's summary: counts, achieved/goodput rates, SLO
    attainment, per-lane TTFT/TPOT percentiles, and the resumption
    ledger.  A 429-shed request counts as ``rejected``, NOT as an
    error — shedding is the server keeping its promise under overload.
    A stream the mesh spliced onto a survivor mid-generation counts as
    ``stalled``/``resumed``, NOT as an error — the client saw a pause,
    then the same bytes it would have seen; conflating either with
    failures would make the goodput math lie in both directions."""
    ok = [r for r in results if r.get("ok")]
    rejected = [r for r in results
                if r.get("rejected") and not r.get("ok")]
    met = [r for r in ok if meets_slo(r, slo_ttft_s, slo_tpot_s)]
    stalls = [r["max_stall_s"] for r in results
              if r.get("max_stall_s") is not None]
    lanes: Dict[str, Dict[str, Any]] = {}
    # lanes may mix ints and named-tenant strings: sort on the string
    # form so one population can carry both
    for lane in sorted({r["lane"] for r in results}, key=str):
        in_lane = [r for r in results if r["lane"] == lane]
        rs = [r for r in ok if r["lane"] == lane]
        ttfts = [r["ttft_s"] for r in rs if r["ttft_s"] is not None]
        tpots = [r["tpot_s"] for r in rs if r["tpot_s"] is not None]
        lanes[str(lane)] = {
            "n": len(in_lane),
            "completed": len(rs),
            "rejected": len([r for r in rejected if r["lane"] == lane]),
            "slo_met": len([r for r in rs
                            if meets_slo(r, slo_ttft_s, slo_tpot_s)]),
            "stalled": len([r for r in in_lane if r.get("stalled")]),
            "resumed": sum(r.get("resumed") or 0 for r in in_lane),
            "ttft": _pcts(ttfts) if ttfts else None,
            "tpot": _pcts(tpots) if tpots else None,
        }
    makespan_s = max(makespan_s, 1e-9)
    return {
        "offered_rate_rps": rate,
        "n": len(results),
        "completed": len(ok),
        "rejected": len(rejected),
        "errors": len(results) - len(ok) - len(rejected),
        "stalled": len([r for r in results if r.get("stalled")]),
        "resumed": sum(r.get("resumed") or 0 for r in results),
        "max_stall_ms": round(max(stalls) * 1e3, 2) if stalls else None,
        "makespan_s": round(makespan_s, 3),
        "achieved_rps": round(len(ok) / makespan_s, 3),
        "goodput_rps": round(len(met) / makespan_s, 3),
        "slo_attainment": round(len(met) / len(results), 4) if results
        else 0.0,
        "tokens": sum(r.get("tokens") or 0 for r in results),
        "lanes": lanes,
    }


# -- conversation mode ------------------------------------------------------


@dataclass
class SessionConfig:
    """One conversation run's shape.  ``rate`` paces SESSION arrivals
    (the open-loop knob); turns inside a session run sequentially with
    a think-time gap.  ``turns`` rows are ``(weight, n_turns)``;
    ``turn_tokens`` rows are ``(weight, new_user_tokens)``; ``lanes``
    rows are ``(lane, weight)`` exactly as in ``LoadConfig`` — lane
    weights ARE the tenant-skewed session popularity."""

    rate: float = 2.0          # session arrivals per second
    n_sessions: int = 16
    process: str = "poisson"
    seed: int = 0
    turns: Sequence[Tuple[float, int]] = ((1.0, 4),)
    # uniform think-time range (seconds) between a reply and the next
    # turn — 0 means agent-loop speed, humans are (2, 20)-ish
    think_s: Tuple[float, float] = (0.0, 0.0)
    # every session opens on the SAME shared system prompt: the
    # population-wide prefix the store tier should serve once
    system_prompt_len: int = 32
    turn_tokens: Sequence[Tuple[float, int]] = ((1.0, 16),)
    max_tokens: int = 8
    lanes: Sequence[Tuple[Any, float]] = ((0, 1.0),)
    vocab: int = 256
    stream: bool = True
    timeout_s: float = 120.0
    extra_body: Dict[str, Any] = field(default_factory=dict)


def make_sessions(cfg: SessionConfig) -> List[Dict[str, Any]]:
    """The session population: per session a lane, a turn count, and
    per-turn new-user-token runs + think times.  Deterministic in
    ``cfg.seed`` (same discipline as ``make_requests``), so tests
    assert the shape without a server."""
    rng = random.Random(cfg.seed)
    system = [rng.randrange(cfg.vocab)
              for _ in range(max(0, cfg.system_prompt_len))]
    lo, hi = cfg.think_s
    out = []
    for i in range(cfg.n_sessions):
        _w, n_turns = _weighted_choice(rng, list(cfg.turns),
                                       key=lambda r: r[0])
        lane, _w = _weighted_choice(rng, list(cfg.lanes))
        turns = []
        for _t in range(max(1, int(n_turns))):
            _w, ntok = _weighted_choice(rng, list(cfg.turn_tokens),
                                        key=lambda r: r[0])
            turns.append({
                "user_tokens": [rng.randrange(cfg.vocab)
                                for _ in range(max(1, int(ntok)))],
                "think_s": round(rng.uniform(lo, hi), 6) if hi > 0
                else 0.0,
            })
        out.append({
            "session": f"s{cfg.seed}-{i:04d}",
            "lane": lane if isinstance(lane, str) else int(lane),
            "system": system,
            "turns": turns,
        })
    return out


def _turn_body(cfg: SessionConfig, sess: Dict[str, Any],
               context: List[int]) -> Dict[str, Any]:
    body = {
        "prompt": list(context),
        "max_tokens": int(cfg.max_tokens),
        "temperature": 0,
        "priority": sess["lane"],
        "stream": bool(cfg.stream),
        "session": sess["session"],
    }
    body.update(cfg.extra_body)
    return body


def _session_tombstones(sessions, offsets, per_session):
    """Session-major/turn-minor result assembly with tombstones for a
    hung session's unreached turns (shared by both pacers)."""
    results: List[Dict[str, Any]] = []
    for i, sess in enumerate(sessions):
        rows = per_session[i]
        results.extend(rows)
        for t in range(len(rows) + 1, len(sess["turns"]) + 1):
            r = _tombstone({"priority": sess["lane"]}, offsets[i])
            r["session"] = sess["session"]
            r["turn"] = t
            r["prompt_tokens"] = None
            results.append(r)
    return results


def run_sessions(url: Urls, cfg: SessionConfig,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 post: Optional[Callable[[Dict[str, Any]],
                                         Dict[str, Any]]] = None,
                 pacer: Optional[str] = None
                 ) -> Tuple[List[Dict[str, Any]], float]:
    """Fire the session population open-loop: one task (async pacer,
    the default for live runs) or thread per session at its scheduled
    arrival, turns sequential inside it — each turn's prompt is the
    accumulated context (system prompt + every prior user turn) plus
    this turn's new tokens, carrying the ``"session"`` id end to end.
    ``url`` may be a router-replica list; a session sticks to its
    starting replica (affinity keeps the KV pin warm) but fails over
    on connect error.  Returns ``(results, makespan_s)``, results
    ordered session-major/turn-minor, each row tagged ``session``/
    ``turn``/``prompt_tokens`` on top of the usual per-request
    fields."""
    sessions = make_sessions(cfg)
    offsets = arrival_offsets(cfg.rate, len(sessions), cfg.process,
                              random.Random(cfg.seed))
    mode = _pick_pacer(pacer, clock, sleep, post)
    if mode == "async":
        return _run_sessions_async(_norm_urls(url), cfg, sessions, offsets)

    do_post = post or (lambda b: _http_post(url, b, cfg.timeout_s))
    per_session: List[List[Dict[str, Any]]] = [[] for _ in sessions]
    threads: List[threading.Thread] = []
    t0 = clock()

    def converse(i: int, sess: Dict[str, Any], late_s: float) -> None:
        context = list(sess["system"])
        for t, turn in enumerate(sess["turns"], start=1):
            if t > 1 and turn["think_s"]:
                sleep(turn["think_s"])
            context += turn["user_tokens"]
            r = do_post(_turn_body(cfg, sess, context))
            r["session"] = sess["session"]
            r["turn"] = t
            r["prompt_tokens"] = len(context)
            r["sched_off_s"] = round(offsets[i], 6)
            r["late_s"] = round(late_s, 6) if t == 1 else 0.0
            per_session[i].append(r)

    for i, off in enumerate(offsets):
        wait = off - (clock() - t0)
        if wait > 0:
            sleep(wait)
        late = max(0.0, (clock() - t0) - off)
        th = threading.Thread(target=converse,
                              args=(i, sessions[i], late), daemon=True)
        th.start()
        threads.append(th)
    for i, th in enumerate(threads):
        # a session's worst case is every turn timing out back to back
        think = sum(t["think_s"] for t in sessions[i]["turns"])
        th.join(timeout=cfg.timeout_s * len(sessions[i]["turns"])
                + think + 5)
    makespan = clock() - t0
    return _session_tombstones(sessions, offsets, per_session), makespan


def _run_sessions_async(urls: List[str], cfg: SessionConfig,
                        sessions: List[Dict[str, Any]],
                        offsets: List[float]
                        ) -> Tuple[List[Dict[str, Any]], float]:
    per_session: List[List[Dict[str, Any]]] = [[] for _ in sessions]

    async def converse(i: int, t0: float) -> None:
        loop = asyncio.get_running_loop()
        sess = sessions[i]
        wait = offsets[i] - (loop.time() - t0)
        if wait > 0:
            await asyncio.sleep(wait)
        late = max(0.0, (loop.time() - t0) - offsets[i])
        context = list(sess["system"])
        for t, turn in enumerate(sess["turns"], start=1):
            if t > 1 and turn["think_s"]:
                await asyncio.sleep(turn["think_s"])
            context += turn["user_tokens"]
            body = _turn_body(cfg, sess, context)
            try:
                r = await asyncio.wait_for(
                    _a_http_post(urls, body, cfg.timeout_s, start=i),
                    cfg.timeout_s * 2)
            except Exception as e:  # noqa: BLE001 — a failure is a data point
                r = _tombstone(body, offsets[i])
                r["error"] = ("timeout"
                              if isinstance(e, asyncio.TimeoutError)
                              else repr(e)[:200])
            r["session"] = sess["session"]
            r["turn"] = t
            r["prompt_tokens"] = len(context)
            r["sched_off_s"] = round(offsets[i], 6)
            r["late_s"] = round(late, 6) if t == 1 else 0.0
            per_session[i].append(r)

    async def main() -> float:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.gather(*(converse(i, t0)
                               for i in range(len(sessions))))
        return loop.time() - t0

    makespan = asyncio.run(main())
    return _session_tombstones(sessions, offsets, per_session), makespan


def session_summary(results: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce conversation-mode results to the persistence-contract
    numbers: per-turn completion counts and mean TTFT, plus the
    least-squares TTFT-vs-turn slope — the one scalar that says "flat"
    (store holding context across turns) or "growing" (every turn
    re-prefilling) — and the resumption ledger (stalled turns are
    spliced streams, not failures).  Pure, so tests feed synthetic
    rows."""
    by_turn: Dict[int, Dict[str, Any]] = {}
    for r in results:
        t = r.get("turn")
        if t is None:
            continue
        d = by_turn.setdefault(int(t), {"n": 0, "completed": 0,
                                        "ttfts": []})
        d["n"] += 1
        if r.get("ok"):
            d["completed"] += 1
            if r.get("ttft_s") is not None:
                d["ttfts"].append(r["ttft_s"])
    per_turn: Dict[str, Any] = {}
    pts: List[Tuple[float, float]] = []
    for t in sorted(by_turn):
        d = by_turn[t]
        mean = (sum(d["ttfts"]) / len(d["ttfts"])) if d["ttfts"] else None
        per_turn[str(t)] = {
            "n": d["n"], "completed": d["completed"],
            "ttft_mean_ms": round(mean * 1e3, 2) if mean is not None
            else None,
        }
        if mean is not None:
            pts.append((float(t), mean))
    slope = None
    if len(pts) >= 2:
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        den = sum((x - mx) ** 2 for x, _ in pts)
        if den > 0:
            slope = sum((x - mx) * (y - my) for x, y in pts) / den
    sessions = {r["session"] for r in results if r.get("session")}
    turn_rows = [r for r in results if r.get("turn") is not None]
    stalls = [r["max_stall_s"] for r in turn_rows
              if r.get("max_stall_s") is not None]
    return {
        "sessions": len(sessions),
        "turns": len(turn_rows),
        "completed": len([r for r in turn_rows if r.get("ok")]),
        "stalled": len([r for r in turn_rows if r.get("stalled")]),
        "resumed": sum(r.get("resumed") or 0 for r in turn_rows),
        "max_stall_ms": round(max(stalls) * 1e3, 2) if stalls else None,
        "per_turn": per_turn,
        "ttft_slope_ms_per_turn": round(slope * 1e3, 3)
        if slope is not None else None,
    }


def sweep(url: Urls, base: LoadConfig, rates: Sequence[float],
          slo_ttft_s: float, slo_tpot_s: float,
          cooldown_s: float = 0.5,
          on_point: Optional[Callable[[Dict[str, Any]], None]] = None,
          pacer: Optional[str] = None,
          ) -> List[Dict[str, Any]]:
    """The goodput-vs-rate curve: one open-loop run per arrival rate
    (fresh seed-derived schedule each, same population shape).  The
    short cooldown lets the previous point's stragglers drain so one
    point's backlog doesn't pollute the next measurement."""
    from dataclasses import replace

    curve = []
    for i, rate in enumerate(rates):
        cfg = replace(base, rate=float(rate), seed=base.seed + i)
        results, makespan = run_load(url, cfg, pacer=pacer)
        point = summarize(results, makespan, slo_ttft_s, slo_tpot_s,
                          rate=float(rate))
        curve.append(point)
        if on_point is not None:
            on_point(point)
        if cooldown_s and rate != rates[-1]:
            time.sleep(cooldown_s)
    return curve
