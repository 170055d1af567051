"""k1_roofline (kernel K1, ``ops/csrc/paged_decode.cu``): the bytes the
traced span's delivered tokens need from the paged cache (every K and V of
each token's context once, its q and output) over the HBM peak, divided by
K1's device time in the span, in percent."""

from portbench.reduce import K1, kernel_s, share, span_work


def read(run):
    if not run.peak:
        return None
    return share(span_work(run, run.span_steps())["k1_bound_s"],
                 kernel_s(run, K1))
