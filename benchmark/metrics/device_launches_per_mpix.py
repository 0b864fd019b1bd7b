"""Device: kernels the profiler saw launched in the window, per Mpix."""

SPANS = {}


def read(run):
    t = run.trace
    return len(t.kernels) / t.mpix if t.kernels else None
