"""Device: the share of the window in which no operation (kernel, copy or
set) ran on the card, from the profiler's trace, in %."""

SPANS = {}


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.ops else None
