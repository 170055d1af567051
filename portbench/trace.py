"""The device trace of a traced run, and its reduction.

``Profiler`` starts and stops ``torch.profiler``'s Kineto backend on the
thread that serves (the engine's): CUPTI records the device's operations
from every thread, and the CPU markers the step recorder sets there
(``pb.step#<n>``, ``pb.prefill_start``, ``pb.prefill_step``,
``pb.decode_batch``) ride the same clock.  Stopping returns the raw
results without building Python events for them; ``reduce`` reads them
once the run is over.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

MARKER = re.compile(r"pb\.step#(\d+)$")

# what the host was doing during an idle gap of the device, by the
# innermost marker around the gap's middle
GAP_LABELS = {
    "pb.decode_batch": "host in decode_batch (tables, sampling inputs, "
                       "token sync)",
    "pb.prefill_step": "host in prefill_step (chunk inputs, eager forward "
                       "dispatch)",
    "pb.prefill_start": "host in prefill_start (prefix lookup, pages)",
    "pb.step": "host in the scheduler step outside engine calls "
               "(admission, retirement, streaming)",
    None: "host between scheduler steps (engine loop, request intake)",
}


class Profiler:
    """One Kineto session, started and stopped on the calling thread."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler as P

        kw = {"use_device": "cuda"} if cuda else {}
        self._p = P.profile(use_kineto=True, **kw)
        self.result = None
        self.started = self.stopped = False

    def start(self) -> None:
        self._p._prepare_trace()
        self._p._start_trace()
        self.started = True

    def stop(self) -> None:
        from torch.autograd import profiler as P

        self.result = P._disable_profiler()
        self.stopped = True


def _is_device(e) -> bool:
    """An operation on the device: not a CPU event, and not the device-side
    copy of a CPU marker's range (a user annotation)."""
    return (str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation()
            and not e.name().startswith("pb."))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(result, top: int = 10) -> Optional[Dict[str, Any]]:
    """The span of the profiled scheduler steps (first marker's start to
    the last's end), the device's busy time in it (the union of its
    operations' intervals), each kernel's summed time, and the idle gaps
    labelled by what the host was doing; None without a marker."""
    steps: Dict[int, Tuple[int, int]] = {}
    cpu: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in result.events():
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            dev.append((s, s + d, name))
            continue
        m = MARKER.match(name)
        if m:
            steps[int(m.group(1))] = (s, s + d)
            cpu.append((s, s + d, "pb.step"))
        elif name in GAP_LABELS:
            cpu.append((s, s + d, name))
    if not steps:
        return None
    lo = min(a for a, _ in steps.values())
    hi = max(b for _, b in steps.values())
    clipped = [(max(a, lo), min(b, hi), n) for a, b, n in dev
               if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _ in clipped])
    kernels: Dict[str, float] = {}
    for a, b, n in clipped:
        kernels[n] = kernels.get(n, 0.0) + (b - a) * 1e-9
    gaps: Dict[str, float] = {}
    prev = lo
    cpu.sort()
    nxt, active = 0, []  # markers open at the sweep point (nested)
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            mid = (a + prev) // 2
            while nxt < len(cpu) and cpu[nxt][0] <= mid:
                active.append(cpu[nxt])
                nxt += 1
            active = [c for c in active if c[1] > mid]
            # nested markers: the one that started last is innermost
            label = GAP_LABELS[max(active)[2] if active else None]
            gaps[label] = gaps.get(label, 0.0) + (a - prev) * 1e-9
        prev = max(prev, b)
    rank = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {
        "steps": sorted(steps),
        "span_s": (hi - lo) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in rank[:top]],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top],
        },
    }


def kernel_seconds(red: Dict[str, Any], *needles: str) -> float:
    """Summed device time of the kernels whose name holds a needle."""
    return sum(s for n, s in red["kernels"].items()
               if any(x in n for x in needles))
