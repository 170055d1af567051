"""output_tok_s: tokens streamed to the clients inside the window, over
the window's length."""


def read(run):
    n = sum(k for r in run.rows for t, k in r["events"]
            if run.t_open <= t < run.t_close)
    return n / run.window_s if n else None
