"""Device: bytes the program uploads to the card per texture (the program's
counter `upload_bytes`: the ETC1S pixels and neighbour arrays, the UASTC
uint8 pixels), MB per Mpix of the window."""

from ..program_spans import of
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_COUNTERS = ("upload_bytes",)


def read(run):
    prog = of(run)
    c = prog.counters.get(PROGRAM_COUNTERS[0]) if prog else None
    return None if c is None else c[1] / 1e6 / run.trace.mpix
