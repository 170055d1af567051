"""tpot_p95_ms: 95th percentile, over the requests that finished in the
window, of (last token - first token) / (tokens - 1)."""

from portbench import stats


def read(run):
    p = stats.percentile([t for t in map(stats.tpot_s, run.finished_rows())
                          if t is not None], 0.95)
    return None if p is None else 1e3 * p
