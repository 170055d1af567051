"""prefill_attn_roofline (kernels K2 + K3, ``ops/csrc/flash_attention.cu``):
for each prompt range the traced span prefilled, the larger of its causal
attention's operations over the bf16 peak and its bytes over the HBM peak;
their sum over K2's and K3's device time in the span, in percent."""

from portbench.reduce import K2_K3, kernel_s, share, span_work


def read(run):
    if not run.peak:
        return None
    return share(span_work(run, run.span_steps())["prefill_attn_bound_s"],
                 kernel_s(run, K2_K3))
