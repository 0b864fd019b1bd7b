"""Copy of `basis_universal_tpu/utils/telemetry.py`.

Tracing/profiling, debug output, and the convar registry.

Mirrors the reference's auxiliary subsystems (SURVEY.md §5):
  - interval_timer + per-stage timing prints (basisu_enc.h:4086,
    basis_compressor's stage debug_printf's)
  - debug_printf/error_printf gated by runtime flags (basisu_comp.h m_debug)
  - the global convar registry: named numeric variables with ranges,
    listable/settable at runtime (basisu_enc.h:4611-4720; exposed through
    JS/CLI in the reference)
Stage timers bracket device dispatch+sync; deeper kernel-level profiling
goes through torch.profiler (start_device_trace/stop_device_trace below),
which writes a Chrome trace of the host and the CUDA card.
"""

import contextlib
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

_debug_enabled = False


def enable_debug_printf(flag: bool = True):
    global _debug_enabled
    _debug_enabled = flag


def debug_printf(fmt, *args):
    if _debug_enabled:
        print(fmt % args if args else fmt, file=sys.stderr)


def error_printf(fmt, *args):
    print("ERROR: " + (fmt % args if args else fmt), file=sys.stderr)


class IntervalTimer:
    """Wall-clock stage timer (interval_timer analog)."""

    def __init__(self):
        self._start = time.perf_counter()

    def start(self):
        self._start = time.perf_counter()

    def get_elapsed_secs(self) -> float:
        return time.perf_counter() - self._start

    def get_elapsed_ms(self) -> float:
        return 1000.0 * self.get_elapsed_secs()


@dataclass
class StageStats:
    calls: int = 0
    total_secs: float = 0.0


class StageTimers:
    """Accumulating per-stage timers; the compressor's 'Total time' style
    stage breakdown. Thread-unsafe by design (single pipeline)."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stages.setdefault(name, StageStats())
            s.calls += 1
            s.total_secs += dt
            debug_printf("%s: %.3f secs", name, dt)

    def report(self) -> str:
        lines = [f"{k}: {v.total_secs:.3f}s over {v.calls} call(s)"
                 for k, v in sorted(self.stages.items())]
        return "\n".join(lines)


GLOBAL_TIMERS = StageTimers()


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
