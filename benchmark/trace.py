"""The traced run's instruments: host spans around named functions of the
program, the device trace of `torch.profiler` over the window, and what the
metric readers read from them.

Spans. For each label a metric reader asks for (its `SPANS`), the named
module functions are wrapped for the traced run only; each call records its
label, start, end and whether it ran on the main thread. The program is not
edited and runs unwrapped in the untraced runs.

Device. The profiler records CUDA activity alone (no host ops, whose
recording would slow the host path the cells measure). A marker kernel
(`torch.cuda._sleep`) launched right after a synchronise at each end of
the window puts the device clock beside the host's.
"""

import dataclasses
import importlib
import re
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# the resolution at which idle time is credited to the host's work
GAP_BIN_S = 20e-6


@dataclasses.dataclass
class Span:
    label: str
    start: float
    end: float
    main: bool


class Spans:
    """Wraps "module:function" names with span recorders; `undo` restores
    them."""

    def __init__(self, wanted: Dict[str, List[str]]):
        self.records: List[Span] = []
        self._undo = []
        main = threading.main_thread().ident
        for label, names in wanted.items():
            for name in names:
                mod_name, fn_name = name.split(":")
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, fn_name)
                self._undo.append((mod, fn_name, fn))
                setattr(mod, fn_name, self._wrap(label, fn, main))

    def _wrap(self, label, fn, main):
        records = self.records

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                records.append(Span(label, t0, time.perf_counter(),
                                    threading.get_ident() == main))
        return wrapped

    def undo(self):
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo = []


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float        # host-clock seconds
    dur: float
    kind: str           # "kernel", "memcpy" or "memset"


MARKER = "spin_kernel"
# host seconds between the profiler's start and the first marker, and
# between the last marker and its stop, so that neither marker lies at the
# edge of the traced span
GUARD_S = 0.05


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _kineto_ops(prof):
    """(name, start ns, duration ns) of every device activity."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), start, dur))
    return out


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marks = []

    def _mark(self):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.torch.cuda._sleep(1000)
        self.torch.cuda.synchronize()
        self.marks.append(t)

    def __enter__(self):
        self.prof.__enter__()
        time.sleep(GUARD_S)
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        time.sleep(GUARD_S)
        self.prof.__exit__(*exc)

    def ops(self) -> List[DeviceOp]:
        """Device activity on the host clock, markers left out."""
        raw = _kineto_ops(self.prof)
        found = sorted(s for n, s, _ in raw if MARKER in n)
        starts = [s for n, s, _ in raw if MARKER not in n]
        offset = marker_offset(found, self.marks, starts)
        if len(found) != len(self.marks):
            print(f"device trace: {len(found)} of {len(self.marks)} markers "
                  "found; the clocks aligned by it alone", file=sys.stderr)
        return [DeviceOp(n, s * 1e-9 - offset, d * 1e-9, _kind(n))
                for n, s, d in raw if MARKER not in n]


def marker_offset(found, marks, starts) -> float:
    """Seconds from the host's clock to the device trace's: found, the
    device ns of the markers in the trace; marks, the host seconds of the
    start and end markers; starts, the ns of the other activity.
    Where the trace lost one marker, the other sets the offset alone: the
    start marker precedes all other activity, the end marker follows it.
    Raises where none is found (the card was not traced)."""
    if len(found) == len(marks):
        return float(np.mean([m * 1e-9 - t for m, t in zip(found, marks)]))
    if len(found) == 1 and len(marks) == 2:
        first = min(starts, default=found[0])
        return found[0] * 1e-9 - marks[0 if found[0] <= first else 1]
    raise RuntimeError(f"device trace: {len(found)} of {len(marks)} markers "
                       f"found among {len(starts)} records; is CUPTI "
                       "tracing the card?")


def short_name(name: str) -> str:
    """A device op's name without its return type, anonymous namespaces and
    argument list, at most 64 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:64]


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """What a traced run saw, as the metric readers read it."""

    def __init__(self, window, window_start: float, spans: List[Span],
                 ops: List[DeviceOp], textures: List[dict], rooflines: dict):
        self.window = window
        self.t0 = window_start
        self.t1 = window_start + window.seconds
        self.window_s = window.seconds
        self.mpix = window.mpix
        self.spans = spans
        self.ops = [o for o in ops if o.start + o.dur > self.t0
                    and o.start < self.t1]
        self.kernels = [o for o in self.ops if o.kind == "kernel"]
        self.textures = textures            # one shape dict a finished one
        self.rooflines = rooflines
        clipped = [(max(o.start, self.t0), min(o.start + o.dur, self.t1))
                   for o in self.ops]
        self.busy_s = sum(e - s for s, e in _union(clipped))
        # [launches, device seconds] by name: a window holds some hundred
        # thousand launches of a few hundred kernels
        self.by_name = {}
        for o in self.ops:
            entry = self.by_name.setdefault(o.name, [0, 0.0, o.kind])
            entry[0] += 1
            entry[1] += o.dur

    def span_s(self, label: str) -> float:
        return sum(s.end - s.start for s in self.spans if s.label == label)

    def has_spans(self, label: str) -> bool:
        return any(s.label == label for s in self.spans)

    def kernel_time(self, pattern: str):
        """(launches, device seconds) of kernels whose name holds the
        pattern as a whole word."""
        rx = re.compile(rf"(?<![A-Za-z0-9_])(?:{pattern})(?![A-Za-z0-9_])")
        n = seconds = 0
        for name, (count, dur, kind) in self.by_name.items():
            if kind == "kernel" and rx.search(name):
                n += count
                seconds += dur
        return n, float(seconds)

    def _bound(self, name: str):
        """(launches seen, launches expected, device s, bound s) of a
        kernel with a bound, for the window's textures."""
        mod = self.rooflines[name]
        per_tex = [mod.launches(t) for t in self.textures]
        launches, seconds = self.kernel_time(mod.KERNEL)
        return (launches, sum(len(p) for p in per_tex), seconds,
                sum(sum(p) for p in per_tex))

    def roofline(self, names) -> Optional[float]:
        """Sum of bound times over sum of device times of these kernels, in
        %; each kernel's bound scaled down by the share of its expected
        launches that ran, where fewer ran. None where none ran."""
        bound = dev = 0.0
        for name in names:
            launches, expected, seconds, b = self._bound(name)
            if launches and expected:
                bound += min(1.0, launches / expected) * b
                dev += seconds
        return 100.0 * bound / dev if dev > 0 else None

    def roofline_lines(self) -> List[str]:
        """Each kernel with a bound: launches seen and expected, device and
        bound seconds, share."""
        out = []
        for name in self.rooflines:
            launches, expected, seconds, bound = self._bound(name)
            if launches or expected:
                share = (f"{100 * bound / seconds:.4f}%" if seconds
                         else "not run")
                out.append(f"roofline {name}: launches {launches} of "
                           f"{expected} expected, device {seconds:.6f} s, "
                           f"bound {bound:.6f} s, {share}")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle gaps by what
        the host was doing, in seconds."""
        by_name = {}
        for name, (_count, dur, _kind) in self.by_name.items():
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps()[:top]]}

    def idle_gaps(self):
        """[(label, seconds)] of device idle time in the window, each bin of
        GAP_BIN_S credited to what the main thread was in, else to what
        another thread was in, else to "none"; longest first."""
        n = max(1, int(np.ceil(self.window_s / GAP_BIN_S)))

        def bins(intervals):
            se = np.asarray(intervals, np.float64).reshape(-1, 2)
            ab = np.clip((se - self.t0) / GAP_BIN_S, 0, n).astype(np.int64)
            ab = ab[ab[:, 1] > ab[:, 0]]
            mask = np.zeros(n + 1, np.int64)
            np.add.at(mask, ab[:, 0], 1)
            np.add.at(mask, ab[:, 1], -1)
            return np.cumsum(mask)[:n] > 0

        idle = ~bins([(o.start, o.start + o.dur) for o in self.ops])
        out = {}
        for main in (True, False):
            labels = sorted({s.label for s in self.spans if s.main == main})
            for label in labels:
                hit = idle & bins([(s.start, s.end) for s in self.spans
                                   if s.label == label and s.main == main])
                if hit.any():
                    out[label] = (out.get(label, 0.0)
                                  + float(hit.sum()) * GAP_BIN_S)
                    idle &= ~hit
        out["none"] = float(idle.sum()) * GAP_BIN_S
        return sorted(out.items(), key=lambda kv: -kv[1])
