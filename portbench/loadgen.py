"""The load generator: a child process that sends one run's traffic.

Run as ``python -m portbench.loadgen``.  It reads one JSON command per line
on standard input and answers each with one JSON line on standard output:

* ``{"cmd": "run", "url": ..., "mix": ..., "seed": ..., "vocab": ...,
  "t0": ..., "window_s": ..., "drain_s": ..., "system_only": bool}``: sends
  the plan of ``traffic.plan(mix, seed, window_s, vocab)`` with the window
  opening at ``t0`` (``time.monotonic()``, shared with the parent), stops
  sending at ``t0 + window_s`` and waits for in-flight requests until
  ``drain_s`` later; a request unfinished then counts as failed.  The
  traffic starts ``lead_s`` before ``t0``.  With
  ``system_only`` it sends each tenant's system prompt once instead
  (one token each) and returns when they are done;
* ``{"cmd": "exit"}``.

It runs in its own interpreter so that neither its pacing nor its stream
parsing shares the server's.  Every time is ``time.monotonic()``: a
request's ``due`` is when the plan says it is sent (an open loop's arrival,
or the previous turn's last token plus the think time; a closed-loop
client's previous answer), so a late send shows as ``sent - due`` and
counts in the latency.  This is a frozen copy of the open-loop pacer and
streaming client of ``infinistore_tpu_torch/loadgen.py``, timed from the
due time instead of the send.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
import uuid
from typing import Any, Dict, List

if __package__ in (None, ""):
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import traffic  # noqa: E402


async def _sleep_until(t: float) -> None:
    wait = t - time.monotonic()
    if wait > 0:
        await asyncio.sleep(wait)


async def post(host: str, port: int, body: Dict[str, Any],
               deadline: float) -> Dict[str, Any]:
    """One streamed completion over a raw socket (HTTP/1.1, SSE).
    Returns the send and token times, the token ids and the outcome; any
    fault, or the deadline, leaves ``ok`` false."""
    out: Dict[str, Any] = {"ok": False, "done": False, "error": None,
                           "tokens": [],
                           "trace_id": uuid.uuid4().hex, "sent": None,
                           "first": None, "last": None, "events": []}
    payload = json.dumps(body).encode()
    writer = None

    async def talk() -> None:
        nonlocal writer
        reader, writer = await asyncio.open_connection(host, port)
        out["sent"] = time.monotonic()
        writer.write((
            f"POST /v1/completions HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"X-Istpu-Trace: {out['trace_id']}\r\n"
            f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
        ).encode() + payload)
        await writer.drain()
        status = (await reader.readline()).split(None, 2)
        if len(status) < 2 or status[1] != b"200":
            out["error"] = f"status {status[1:2]}"
            return
        while (await reader.readline()) not in (b"\r\n", b"\n", b""):
            pass
        while True:
            line = await reader.readline()
            if not line:
                out["error"] = "stream ended without [DONE]"
                return
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[6:]
            if data == b"[DONE]":
                out["done"] = True
                return
            ev = json.loads(data)
            if "error" in ev:
                out["error"] = str(ev["error"])[:200]
                return
            new = ev.get("choices", [{}])[0].get("token_ids") or []
            if new:
                now = time.monotonic()
                if out["first"] is None:
                    out["first"] = now
                out["last"] = now
                out["tokens"].extend(new)
                out["events"].append((now, len(new)))

    try:
        await asyncio.wait_for(talk(), max(0.0, deadline - time.monotonic()))
    except asyncio.TimeoutError:
        out["error"] = "unfinished at the end of the drain"
    except (OSError, ValueError) as e:
        out["error"] = repr(e)[:200]
    finally:
        if writer is not None:
            writer.close()
    out["ok"] = out["done"] and len(out["tokens"]) == body["max_tokens"]
    if out["error"] is None and not out["ok"]:
        out["error"] = (f"{len(out['tokens'])} tokens for max_tokens "
                        f"{body['max_tokens']}")
    return out


def _body(prompt: List[int], max_tokens: int, sampling: Dict[str, Any],
          **extra) -> Dict[str, Any]:
    return {"prompt": prompt, "max_tokens": max_tokens, "stream": True,
            **sampling, **extra}


def _record(r: Dict[str, Any], due: float, prompt: List[int],
            max_tokens: int, greedy: bool, **tags) -> Dict[str, Any]:
    """The row the parent reads: times, sizes and outcome; a greedy
    request keeps its prompt and tokens for the reference."""
    row = {"due": due, "sent": r["sent"], "first": r["first"],
           "last": r["last"], "ok": r["ok"], "done": r["done"],
           "error": r["error"],
           "n_tokens": len(r["tokens"]), "prompt_len": len(prompt),
           "max_tokens": max_tokens, "greedy": greedy,
           "trace_id": r["trace_id"], "events": r["events"], **tags}
    if greedy:
        row["prompt"] = list(prompt)
        row["output"] = list(r["tokens"])
    return row


async def _sessions(host, port, p, t_start, t_close, deadline):
    rows: List[Dict[str, Any]] = []

    async def converse(s):
        due = t_start + s["arrival_s"]
        context = list(p["system"][s["tenant"]])
        for k, turn in enumerate(s["turns"]):
            if due >= t_close:
                return
            await _sleep_until(due)
            context += turn["user"]
            r = await post(host, port, _body(
                context, turn["max_tokens"], turn["sampling"],
                session=s["id"], tenant=f"t{s['tenant']}"), deadline)
            rows.append(_record(r, due, context, turn["max_tokens"],
                                s["greedy"], session=s["id"], turn=k,
                                tenant=s["tenant"]))
            if not r["ok"]:
                return
            context += r["tokens"]
            if k + 1 < len(s["turns"]):
                due = r["last"] + s["turns"][k + 1]["think_s"]

    await asyncio.gather(*(converse(s) for s in p["sessions"]))
    return rows


async def _closed(host, port, p, vocab, t_start, t_close, deadline):
    rows: List[Dict[str, Any]] = []
    by_client: Dict[int, List[dict]] = {}
    for req in p["requests"]:
        by_client.setdefault(req["client"], []).append(req)
    first = {c: traffic.prompt_ids(rs[0], vocab)
             for c, rs in by_client.items()}

    async def client(c, reqs):
        await _sleep_until(t_start)
        due = t_start
        for i, req in enumerate(reqs):
            if due >= t_close:
                return
            prompt = first[c] if i == 0 else traffic.prompt_ids(req, vocab)
            r = await post(host, port, _body(
                prompt, req["max_tokens"], req["sampling"]), deadline)
            rows.append(_record(r, due, prompt, req["max_tokens"],
                                req["greedy"], client=c, req=req["id"]))
            due = time.monotonic()
        if due < t_close:  # the plan ran out: a failure, never a quiet gap
            rows.append({"due": due, "sent": None, "first": None,
                         "last": None, "ok": False, "done": False,
                         "error": "the plan ran out of requests",
                         "n_tokens": 0, "prompt_len": 0, "max_tokens": 0,
                         "greedy": False, "trace_id": "", "events": [],
                         "client": c})

    await asyncio.gather(*(client(c, rs) for c, rs in by_client.items()))
    return rows


async def _system_prompts(host, port, p, deadline):
    rows = await asyncio.gather(*(
        post(host, port, _body(list(s), 1, {"temperature": 0.0}), deadline)
        for s in p["system"]))
    return [{"ok": r["ok"], "error": r["error"]} for r in rows]


def run(cmd: Dict[str, Any]) -> Dict[str, Any]:
    p = traffic.plan(cmd["mix"], cmd["seed"],
                     cmd["window_s"] + cmd.get("lead_s", 0.0), cmd["vocab"])
    t0 = cmd["t0"]
    t_start = t0 - cmd.get("lead_s", 0.0)
    t_close = t0 + cmd["window_s"]
    deadline = t_close + cmd["drain_s"]
    host, port = cmd["host"], cmd["port"]
    if cmd.get("system_only"):
        rows = asyncio.run(_system_prompts(host, port, p,
                                           time.monotonic() + cmd["drain_s"]))
    elif p["loop"] == "open_sessions":
        rows = asyncio.run(_sessions(host, port, p, t_start, t_close,
                                     deadline))
    else:
        rows = asyncio.run(_closed(host, port, p, cmd["vocab"], t_start,
                                   t_close, deadline))
    return {"rows": rows, "t0": t0, "t_close": t_close,
            "ended": time.monotonic()}


def main() -> None:
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "exit":
            return
        sys.stdout.write(json.dumps(run(cmd)) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
