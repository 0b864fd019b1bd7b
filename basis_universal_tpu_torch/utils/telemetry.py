"""Copy of `basis_universal_tpu/utils/telemetry.py`.

The program's span and counter recorder, the convar registry and the
device trace.

Spans and counters, off by default. `record(True)` switches the recorder on
for the process and `drain()` returns and clears what it holds. Off, a site
tests one module-global flag: `span` hands back a shared no-op context and
`count` returns, with no clock read and no allocation. On, each `span`
records its name, its start and end in `time.perf_counter()` seconds (the
clock the benchmark's device trace is aligned to), its thread and whether
that is the main thread, its parent (the enclosing span on the thread, or
one handed over from another thread), the call and texture it belongs to
(a per-process call number and the texture's index in the call, inherited
from the parent), and the thread's CPU seconds over it
(`time.thread_time()`). `count(name, amount)` adds one and the amount to a
counter. While `start_device_trace` runs, each span also opens
`torch.profiler.record_function(name)`, so the Chrome trace shows the
program's spans above the card's rows.

The convars mirror the reference's global registry: named numeric
variables with ranges, listable and settable at run time
(basisu_enc.h:4611-4720). The device trace is a torch.profiler trace of the
host and the CUDA card (`start_device_trace` / `stop_device_trace`).
"""

import contextlib
import itertools
import pathlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# --- spans and counters ------------------------------------------------------

_ON = False                         # the recorder's switch (`record`)
_SPANS: List["Span"] = []           # closed spans, in the order they closed
_COUNTERS: Dict[str, List[float]] = {}      # name -> [count, total]
_COUNT_LOCK = threading.Lock()
_LOCAL = threading.local()  # .stack: the thread's open spans; .last: its last
_CALLS = itertools.count()
_MAIN = threading.main_thread().ident
_OFF = contextlib.nullcontext()


class Span:
    """One span of the program's work; a context manager that records
    itself when it closes."""

    __slots__ = ("name", "start", "end", "thread", "main", "parent", "call",
                 "texture", "cpu", "_cpu0", "_profiled")

    def __init__(self, name: str, texture: Optional[int],
                 parent: Optional["Span"], call: Optional[int]):
        self.name, self.texture, self.parent, self.call = (
            name, texture, parent, call)
        self.start = self.end = self.cpu = 0.0
        self._profiled = None

    def __enter__(self):
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        if self.parent is not None:
            if self.call is None:
                self.call = self.parent.call
            if self.texture is None:
                self.texture = self.parent.texture
        self.thread = threading.get_ident()
        self.main = self.thread == _MAIN
        stack.append(self)
        if _TRACE:
            import torch

            self._profiled = torch.profiler.record_function(self.name)
            self._profiled.__enter__()
        # the wall clock's reads enclose the CPU clock's: cpu <= end - start
        self.start = time.perf_counter()
        self._cpu0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        self.cpu = time.thread_time() - self._cpu0
        self.end = time.perf_counter()
        if self._profiled is not None:
            self._profiled.__exit__(*exc)
            self._profiled = None
        _LOCAL.stack.pop()
        _LOCAL.last = self
        _SPANS.append(self)

    def __repr__(self):
        return (f"Span({self.name!r}, call={self.call}, "
                f"texture={self.texture}, {self.end - self.start:.6f} s)")


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def record(on: bool = True):
    """Switch the recorder on or off for the whole process."""
    global _ON
    _ON = bool(on)


def recording() -> bool:
    return _ON


def span(name: str, texture: Optional[int] = None,
         parent: Optional[Span] = None, new_call: bool = False):
    """A context that records one span while the recorder is on. texture:
    the texture's index in its call (else the parent's); parent: the span
    that caused this one, where it ran on another thread (else the enclosing
    span on this thread); new_call: the span is a call of the program's
    entry and takes the next call number (else the parent's)."""
    if not _ON:
        return _OFF
    return Span(name, texture, parent, next(_CALLS) if new_call else None)


def last() -> Optional[Span]:
    """The span this thread closed last, to hand to work that it causes on
    another thread; None while the recorder is off."""
    return getattr(_LOCAL, "last", None) if _ON else None


def count(name: str, amount: float):
    """Add one and amount to the counter name while the recorder is on."""
    if _ON:
        with _COUNT_LOCK:
            c = _COUNTERS.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += amount


def drain() -> Tuple[List[Span], Dict[str, Tuple[int, float]]]:
    """(closed spans in the order they closed, {counter: (count, total)}),
    cleared from the recorder."""
    global _SPANS
    spans, _SPANS = _SPANS, []
    with _COUNT_LOCK:
        counters = {k: (int(c), t) for k, (c, t) in _COUNTERS.items()}
        _COUNTERS.clear()
    return spans, counters


# --- convars -----------------------------------------------------------------

@dataclass
class Convar:
    name: str
    value: float
    default: float
    min_value: float
    max_value: float
    description: str = ""


class ConvarRegistry:
    """Named runtime-tunable variables (the reference's convar system)."""

    def __init__(self):
        self._vars: Dict[str, Convar] = {}

    def register(self, name: str, default: float, min_value: float,
                 max_value: float, description: str = "") -> Convar:
        cv = Convar(name, default, default, min_value, max_value, description)
        self._vars[name] = cv
        return cv

    def set(self, name: str, value: float) -> bool:
        cv = self._vars.get(name)
        if cv is None:
            return False
        cv.value = min(max(float(value), cv.min_value), cv.max_value)
        return True

    def get(self, name: str, default: Optional[float] = None) -> Optional[float]:
        cv = self._vars.get(name)
        return cv.value if cv else default

    def list(self):
        return sorted(self._vars.values(), key=lambda c: c.name)


CONVARS = ConvarRegistry()
CONVARS.register("etc1s_endpoint_rdo_thresh", 1.5, 1.0, 4.0,
                 "ETC1S endpoint RDO error threshold multiplier")
CONVARS.register("etc1s_selector_rdo_thresh", 1.25, 1.0, 4.0,
                 "ETC1S selector RDO error threshold multiplier")
CONVARS.register("uastc_ls_iters", 1, 0, 4,
                 "UASTC least-squares endpoint refinement iterations")


# --- device profiling --------------------------------------------------------

_TRACE = {}     # the running trace: {"prof": profile, "log_dir": Path}


def start_device_trace(log_dir: str, device="cuda"):
    """Begin a torch.profiler trace of the host and, for a CUDA `device`,
    of the card (CPU + CUDA activities); a CUDA device without CUDA
    raises. `stop_device_trace` ends it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..codecs.etc1s.frontend import resolve_device

    if _TRACE:
        raise RuntimeError("a device trace is already running")
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _TRACE.update(prof=prof, log_dir=pathlib.Path(log_dir))


def stop_device_trace():
    """End the trace begun by `start_device_trace`: synchronise the card,
    write the Chrome trace into the log directory (`trace.json`, which
    chrome://tracing and Perfetto open) and return the profiler, whose
    `key_averages()` give the time of each kernel and operator."""
    import torch

    if not _TRACE:
        raise RuntimeError("no device trace is running")
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    log_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    return prof
