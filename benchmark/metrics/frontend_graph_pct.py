"""ETC1S frontend: the share of the window's frontend runs that replayed a
captured CUDA graph (the program's counter
`etc1s.frontend.graph_replays` over its spans `etc1s.frontend.dispatch`,
one of each a texture, in `codecs/etc1s/frontend.py` `_run_one`), in %.
None where the program counts no graph: no capture and no replay."""

from ..program_spans import of
from ..program_spans import reader_getattr as __getattr__  # noqa: F401

PROGRAM_COUNTERS = ("etc1s.frontend.graph_replays",
                    "etc1s.frontend.graph_captures")
PROGRAM_SPANS = ("etc1s.frontend.dispatch",)


def read(run):
    prog = of(run)
    if prog is None or not any(c in prog.counters for c in PROGRAM_COUNTERS):
        return None
    runs = sum(1 for s in prog.spans if s.name == PROGRAM_SPANS[0])
    replays = prog.counters.get(PROGRAM_COUNTERS[0], (0, 0.0))[0]
    return 100.0 * replays / runs if runs else None
