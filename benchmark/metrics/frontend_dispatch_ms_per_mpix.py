"""ETC1S frontend, dispatch: each texture's uploads and launches on the main
thread (the program's span `etc1s.frontend.dispatch`, in
`codecs/etc1s/frontend.py` `_run_one`), ms per Mpix of the window."""

from ..program_spans import ms_per_mpix
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_SPANS = ("etc1s.frontend.dispatch",)


def read(run):
    return ms_per_mpix(run, PROGRAM_SPANS[0])
