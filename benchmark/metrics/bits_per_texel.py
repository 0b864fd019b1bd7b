"""End to end, host count: .basis bytes x 8 over texels, over every
texture of the window (download and disk size)."""

SPANS = {}


def read(run):
    return 8.0 * run.window.basis_bytes / run.window.texels
