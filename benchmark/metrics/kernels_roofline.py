"""Kernels: every hand-written kernel with a bound in `rooflines/` that ran
in the window, their bound times summed over their device times, in %."""

SPANS = {}


def read(run):
    return run.trace.roofline(list(run.trace.rooflines))
