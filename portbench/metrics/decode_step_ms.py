"""decode_step_ms (engine decode graphs): the growth of
``istpu_serve_decode_step_seconds``' sum over the window's scheduler
steps, over the decode steps their dispatches ran."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    before = [s for s in run.steps if s["n"] < steps[0]["n"]]
    s0 = before[-1]["hist_sum"] if before else 0.0
    n = sum(s["decode_steps"] for s in steps)
    return 1e3 * (steps[-1]["hist_sum"] - s0) / n if n else None
