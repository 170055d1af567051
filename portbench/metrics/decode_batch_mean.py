"""decode_batch_mean (scheduler): the mean number of active sequences in
the step profiler's records of the window's steps that dispatched a
decode chunk."""


def read(run):
    b = [r["batch"]["active"] for r in run.stepprof
         if run.t_open <= r["t_mono"] < run.t_close
         and r.get("dispatches", {}).get("decode") and "batch" in r]
    return sum(b) / len(b) if b else None
