"""End to end, host clock: every texel of the window's finished textures
over the window's whole time, in Mpix/s."""

SPANS = {}


def read(run):
    return run.window.mpix / run.window.seconds
