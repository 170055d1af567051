"""decode_prep_ms (engine decode graphs): the host time the engine spends
before a decode dispatch (argument checks, page acquisition, the block
table, the graph's input copies, penalties: the ``decode.prep`` phase of
the step profiler's records), summed over the window's scheduler steps,
over the decode dispatches they made."""


def read(run):
    prep, n = 0.0, 0
    for r in run.stepprof:
        if run.t_open <= r["t_mono"] < run.t_close:
            phase = (r.get("phases") or {}).get("decode.prep")
            if phase:
                prep += phase["wall_s"]
            n += r.get("dispatches", {}).get("decode", 0)
    return 1e3 * prep / n if n and prep else None
