"""Shared arithmetic of the metric readers: the work of a span of
scheduler steps, from the step recorder's token positions and
``work.py``."""

from __future__ import annotations

from typing import Dict, List

from . import trace as trace_mod
from . import work

K1 = ("paged_decode_kernel",)
K2_K3 = ("flash_prefix_bf16_kernel", "flash_causal_bf16_kernel")


def span_work(run, steps: List[dict]) -> Dict[str, float]:
    """Over ``steps``: model operations (``flops``), the prefill attention's
    summed bound (``prefill_attn_bound_s``, per prompt range), K1's
    summed bound (``k1_bound_s``), and the tokens prefilled and decoded."""
    cfg, peak = run.config, run.peak
    out = {"flops": 0.0, "prefill_attn_bound_s": 0.0, "k1_bytes": 0.0,
           "prefill_tokens": 0, "decode_tokens": 0}
    for s in steps:
        for a, b, start, last in s["prefill"]:
            out["flops"] += work.prefill_flops(cfg, a, b)
            if last:
                out["flops"] += work.head_flops(cfg)
            out["prefill_tokens"] += b - a
            if peak:
                out["prefill_attn_bound_s"] += work.bound_s(
                    work.attn_flops(cfg, a, b),
                    work.attn_bytes(cfg, a, b, start), peak)
        for P, lo, hi in s["decode"]:
            for i in range(lo, hi + 1):
                ctx = P + i - 1  # keys output i's step attends to
                out["flops"] += work.decode_flops(cfg, ctx)
                out["k1_bytes"] += work.decode_ctx_bytes(cfg, ctx)
            out["decode_tokens"] += hi - lo + 1
    out["k1_bound_s"] = (out["k1_bytes"] / peak["hbm_bytes_per_s"]
                         if peak else 0.0)
    return out


def kernel_s(run, needles) -> float:
    return trace_mod.kernel_seconds(run.trace, *needles) if run.trace else 0.0


def share(num: float, den: float):
    """``num / den`` in percent, or None where there is nothing to read."""
    if not den or not num:
        return None
    return 100.0 * num / den
