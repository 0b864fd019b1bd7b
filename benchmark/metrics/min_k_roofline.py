"""Kernels: `min_k_kernel` (`xla_cpu_min_k`), its bound time over its
device time in the window, in %."""

SPANS = {}


def read(run):
    return run.trace.roofline(["min_k_kernel"])
