"""Spans and work counts around the calls into the program, from the
benchmark's side.

``StepRecorder.install(server)`` wraps the server's ``Scheduler.step`` and
the engine's ``prefill_start``, ``prefill_step`` and ``decode_batch`` on
that one server's objects.  For every scheduler step it keeps the host
times, the decode-step histogram's running sum, the steps each decode
dispatch ran, and the work the step did as token positions: each prompt
range it prefilled (``[a, b)`` of a prompt whose first uncached position is
``start``) and each run of tokens it delivered (output indices ``lo..hi``
of a prompt of length ``P``).  Progress is read from the requests
themselves (prompt, output so far, a partial prefill's offset), never from
launch shapes.  It also starts and stops a ``trace.Profiler`` at step
boundaries, when armed, and sets the profiler's markers.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

from .trace import Profiler

DECODE_HIST = "istpu_serve_decode_step_seconds"


def _progress(sched) -> Dict[int, tuple]:
    """req_id -> (request, prompt length, prefilled uncached tokens,
    uncached tokens, delivered tokens) for every admitted request."""
    out = {}
    for r in list(sched.active):
        st = r.state
        S = len(r.tokens) - st.reused_chunks * sched.engine.pc.block_tokens
        out[r.req_id] = (r, len(r.tokens), S, S,
                         min(len(r.output), r.max_new_tokens))
    for r, pp in list(sched._prefilling):
        out[r.req_id] = (r, len(r.tokens), min(pp.off, pp.S), pp.S, 0)
    return out


def _finished(r, T: int) -> tuple:
    S = len(r.tokens) - (r.state.reused_chunks * T if r.state else 0)
    return (r, len(r.tokens), S, S, min(len(r.output), r.max_new_tokens))


class StepRecorder:
    def __init__(self):
        self.steps: List[Dict[str, Any]] = []
        self._n = 0
        self._cur: Optional[Dict[str, Any]] = None
        self.profiler: Optional[Profiler] = None
        self._trace_from = self._trace_to = None
        self.lock = threading.Lock()

    def arm(self, profiler: Profiler, t_from: float, t_to: float) -> None:
        """Profile the scheduler steps that start at or after ``t_from``
        (``time.monotonic()``), until the first step that ends at or after
        ``t_to``."""
        self.profiler, self._trace_from, self._trace_to = \
            profiler, t_from, t_to

    def _marker(self, name: str):
        p = self.profiler
        if p is not None and p.started and not p.stopped:
            from torch.profiler import record_function

            return record_function(name)
        return contextlib.nullcontext()

    def install(self, server) -> None:
        sched, engine = server.sched, server.engine
        T = engine.pc.block_tokens
        step, decode_batch = sched.step, engine.decode_batch
        prefill_start, prefill_step = engine.prefill_start, engine.prefill_step

        def wrapped_step():
            self._n += 1
            n = self._n
            p = self.profiler
            t0 = time.monotonic()
            if p is not None and p.started and not p.stopped \
                    and t0 >= self._trace_to:
                p.stop()  # the engine idled past the span's end
            if (p is not None and not p.started
                    and self._trace_from <= t0 < self._trace_to):
                p.start()
            before = _progress(sched)
            rec = {"n": n, "t0": t0, "decode_steps": 0,
                   "profiled": bool(p and p.started and not p.stopped)}
            self._cur = rec
            with self._marker(f"pb.step#{n}"):
                retired = step()
            rec["t1"] = time.monotonic()
            self._cur = None
            after = _progress(sched)
            for r in retired:
                after[r.req_id] = _finished(r, T)
            rec["prefill"], rec["decode"] = self._work(before, after)
            h = server.metrics.family_hist(DECODE_HIST)
            rec["hist_sum"] = h[1] if h else 0.0
            if rec["profiled"] and rec["t1"] >= self._trace_to:
                p.stop()
            with self.lock:
                self.steps.append(rec)
            return retired

        def wrapped_decode_batch(states, n_steps, *a, **kw):
            if self._cur is not None:
                self._cur["decode_steps"] += n_steps
            with self._marker("pb.decode_batch"):
                return decode_batch(states, n_steps, *a, **kw)

        def wrapped_prefill_start(*a, **kw):
            with self._marker("pb.prefill_start"):
                return prefill_start(*a, **kw)

        def wrapped_prefill_step(*a, **kw):
            with self._marker("pb.prefill_step"):
                return prefill_step(*a, **kw)

        sched.step = wrapped_step
        engine.decode_batch = wrapped_decode_batch
        engine.prefill_start = wrapped_prefill_start
        engine.prefill_step = wrapped_prefill_step

    @staticmethod
    def _work(before, after):
        prefill, decode = [], []
        for rid, (r, P, done1, S, out1) in after.items():
            _, _, done0, _, out0 = before.get(rid, (r, P, 0, S, 0))
            start = P - S
            if done1 > done0:
                # [a, b) of the prompt; ``last`` when the prompt's last
                # position is in it (its logits make the first token)
                prefill.append((start + done0, start + done1, start,
                                done1 == S))
            # output index 1 comes from the prefill; decode makes 2..n
            lo = max(out0 + 1, 2)
            if out1 >= lo:
                decode.append((P, lo, out1))
        return prefill, decode

    def snapshot(self) -> List[Dict[str, Any]]:
        with self.lock:
            return list(self.steps)
