"""ETC1S back end, the drain: each call's tail after its last texture went to
the assembly pool, until the pool has finished and shut down (the
program's span `etc1s.drain`, in `compressor.py`), ms per Mpix of the
window."""

from ..program_spans import ms_per_mpix
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_SPANS = ("etc1s.drain",)


def read(run):
    return ms_per_mpix(run, PROGRAM_SPANS[0])
