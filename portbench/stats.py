"""Percentiles over requests, with a failed request counted as a miss."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest rank: the ceil(q * n)-th smallest value; ``inf`` entries
    (failed requests) sort last.  None for no values."""
    vs = sorted(values)
    if not vs:
        return None
    return vs[min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))]


def ttft_s(row) -> float:
    """Due time to first token; a failed request misses every limit."""
    if not row["ok"] or row["first"] is None:
        return math.inf
    return row["first"] - row["due"]


def tpot_s(row) -> Optional[float]:
    """(last - first token) / (tokens - 1) of a finished request with two
    tokens or more."""
    if not row["ok"] or row["n_tokens"] < 2:
        return None
    return (row["last"] - row["first"]) / (row["n_tokens"] - 1)
