"""mfu.serve (whole model step): the model operations the traced span's
tokens need (uncached prompt tokens and delivered tokens at the active
weights, attention over each context, the LM head once per prompt and per
decoded token) over the device's busy time in the span times the bf16
peak, in percent.  Busy time and not wall time: in an open loop the wall
time is set by the offered rate."""

from portbench.reduce import share, span_work


def read(run):
    if not run.peak or not run.trace:
        return None
    return share(span_work(run, run.span_steps())["flops"],
                 run.trace["busy_s"] * run.peak["bf16_flops_per_s"])
