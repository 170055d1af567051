"""setup_s: process start until the window opens (weights drawn, kernels
built or loaded, graphs captured, system prompts and the warm-up burst
served)."""


def read(run):
    return run.setup_s
