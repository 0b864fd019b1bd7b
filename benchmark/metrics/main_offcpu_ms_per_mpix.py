"""Entry: the main thread's time off a core inside its host work (the
program's spans `program_spans.HOST_WORK`: prep, dispatch, finalize, the
UASTC upload and containers; never a wait on the card or the drain), wall
time less the thread's CPU time, ms per Mpix of the window: time spent
waiting for the interpreter lock or a core."""

from ..program_spans import HOST_WORK, of, offcpu_s
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_SPANS = HOST_WORK


def read(run):
    prog = of(run)
    s = offcpu_s(prog) if prog else None
    return None if s is None else 1e3 * s / run.trace.mpix
