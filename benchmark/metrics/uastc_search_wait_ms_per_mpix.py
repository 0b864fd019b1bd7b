"""UASTC search and packing, waiting on the card: the main thread blocked in
each texture's fetch of its blocks (the program's span `uastc.search.wait`,
in `codecs/uastc/encode.py` `_search_and_pack`), ms per Mpix of the
window."""

from ..program_spans import ms_per_mpix
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_SPANS = ("uastc.search.wait",)


def read(run):
    return ms_per_mpix(run, PROGRAM_SPANS[0])
