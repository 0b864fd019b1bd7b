"""End to end, host clock: from the start of the run to the end of the
warm-up (imports, the card, the kernels' builds where the checkout has
none, the texture pool, the warm-up call)."""

SPANS = {}


def read(run):
    return run.setup_s
