"""device_idle_share (device): the share of the traced span in which no
operation ran on the device (``torch.profiler``'s trace), in percent."""


def read(run):
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
