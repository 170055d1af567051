"""mfu.batch (whole model step): the model operations the traced span's
tokens need, as for ``mfu.serve``, over the span's wall time times the
bf16 peak, in percent."""

from portbench.reduce import share, span_work


def read(run):
    if not run.peak or not run.trace:
        return None
    return share(span_work(run, run.span_steps())["flops"],
                 run.trace["span_s"] * run.peak["bf16_flops_per_s"])
