"""loop_host_ms (HTTP front end): the engine loop's host time between two
scheduler steps, the wait for work left out: the mean, over the window's
scheduler steps, of the wall seconds of the ``loop.*`` phases other than
``loop.wait`` that the step profiler's record carries as ``loop`` (the
store flush, request intake and the bookkeeping after the step before)."""


def read(run):
    gaps = [sum(p["wall_s"] for name, p in r["loop"].items()
                if name != "loop.wait")
            for r in run.stepprof
            if run.t_open <= r["t_mono"] < run.t_close and "loop" in r]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
