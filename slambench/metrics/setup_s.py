"""setup_s (s, lower, host_clock): from the start of the process to the
window's first call: CUDA's start, the kernels' build or load, rendering
the sequence on the card, building the entry and its warm-up calls."""


def read(run):
    return run.setup_s
