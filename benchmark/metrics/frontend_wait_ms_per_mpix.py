"""ETC1S frontend, waiting on the card: the main thread blocked in each
texture's five fetches (the program's span `etc1s.frontend.wait`, in
`codecs/etc1s/frontend.py` `_run_one`), ms per Mpix of the window."""

from ..program_spans import ms_per_mpix
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_SPANS = ("etc1s.frontend.wait",)


def read(run):
    return ms_per_mpix(run, PROGRAM_SPANS[0])
