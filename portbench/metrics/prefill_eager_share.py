"""prefill_eager_share (engine prefill graphs): of the uncached prompt
positions the window's scheduler steps prefilled, the share an eager
forward computed rather than a prefill graph: the step profiler's work
counters ``prefill_tokens_eager`` over ``prefill_tokens_graph`` +
``prefill_tokens_eager``, counted by the engine at launch, in percent."""


def read(run):
    eager = graph = 0
    for r in run.stepprof:
        if run.t_open <= r["t_mono"] < run.t_close:
            work = r.get("work") or {}
            eager += work.get("prefill_tokens_eager", 0)
            graph += work.get("prefill_tokens_graph", 0)
    return 100.0 * eager / (eager + graph) if eager + graph else None
