"""The program's own spans and counters in a traced run, and what the
readers of `metrics/` read from them.

The port records them itself (`basis_universal_tpu_torch/utils/telemetry.py`:
spans on the host clock the device trace is aligned to, each with its
thread, parent and thread CPU time; the `upload_bytes` counter). A reader
of them names no program function in `SPANS`: it takes `reader_getattr` as
its module's `__getattr__`, and the harness's read of `SPANS`, which a
traced run makes for each per-layer reader just before the window (an
untraced run imports none), switches the recorder on (`arm`). The first
reading after the window switches it off and drains it (`of`), keeps the
spans that lie inside the window, and prints to standard error each span
name's time and the window's idle time credited to the program's spans
(`idle_gaps`). A program without the recorder gives every reader None.

    python3 -m benchmark.program_spans --workload <cell> --seed <n> \
        --seconds <s>

runs one traced run of a cell with every reader of this module added to
it, for the split of a cell whose manifest lists none of them.
"""

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import trace

# the main thread's host work: wall time less thread CPU time is time spent
# waiting for the interpreter lock or a core (never a wait on the card)
HOST_WORK = ("etc1s.prep", "etc1s.frontend.dispatch",
             "etc1s.frontend.finalize", "uastc.prep", "uastc.upload",
             "uastc.search.dispatch", "uastc.container")
# the readers of this module, by metric
READERS = ("frontend_dispatch_ms_per_mpix", "frontend_wait_ms_per_mpix",
           "assembly_drain_ms_per_mpix", "uastc_search_wait_ms_per_mpix",
           "main_offcpu_ms_per_mpix", "upload_mb_per_mpix")


@dataclasses.dataclass
class Program:
    spans: list                         # the recorder's spans in the window
    counters: Dict[str, Tuple[int, float]]


def _telemetry():
    """The port's recorder, or None where the port has none."""
    try:
        from basis_universal_tpu_torch.utils import telemetry
    except ImportError:
        return None
    if not all(hasattr(telemetry, f) for f in ("record", "recording",
                                               "drain")):
        return None
    return telemetry


def arm():
    """Empty the recorder and switch it on."""
    tm = _telemetry()
    if tm is not None:
        tm.drain()
        tm.record(True)


def reader_getattr(name: str):
    """A reader module's `__getattr__`: its `SPANS` are none, and reading
    them switches the recorder on."""
    if name == "SPANS":
        arm()
        return {}
    raise AttributeError(name)


def of(run) -> Optional[Program]:
    """The traced run's program spans and counters, drained at the first
    reading; None where the recorder was not on."""
    if "_program" not in vars(run):
        run._program = _drain(run.trace)
    return run._program


def _drain(t) -> Optional[Program]:
    tm = _telemetry()
    if tm is None or not tm.recording():
        return None
    tm.record(False)
    spans, counters = tm.drain()
    prog = Program([s for s in spans if s.start >= t.t0 and s.end <= t.t1],
                   counters)
    for text in summary(t, prog):
        print(text, file=sys.stderr)
    return prog


def span_s(prog: Program, name: str) -> Optional[float]:
    """Seconds in spans of this name, None where there is none."""
    d = [s.end - s.start for s in prog.spans if s.name == name]
    return float(sum(d)) if d else None


def ms_per_mpix(run, name: str) -> Optional[float]:
    prog = of(run)
    s = span_s(prog, name) if prog else None
    return None if s is None else 1e3 * s / run.trace.mpix


def offcpu_s(prog: Program) -> Optional[float]:
    """The main thread's host-work spans: wall less thread CPU seconds."""
    d = [(s.end - s.start) - s.cpu for s in prog.spans
         if s.main and s.name in HOST_WORK]
    return float(sum(d)) if d else None


def _depth(s) -> int:
    """Enclosing spans on the span's own thread."""
    n, p = 0, s.parent
    while p is not None and p.thread == s.thread:
        n, p = n + 1, p.parent
    return n


def idle_gaps(t, prog: Program) -> List[Tuple[str, float]]:
    """[(name, seconds)] of the window's device idle time, each bin of
    `trace.GAP_BIN_S` credited to the innermost program span open on the
    main thread, else the innermost one open on another thread, else to
    the wrappers' labels as `trace.Trace.idle_gaps` credits them, else to
    "none"; longest first."""
    n = max(1, int(np.ceil(t.window_s / trace.GAP_BIN_S)))

    def bins(intervals):
        se = np.asarray(intervals, np.float64).reshape(-1, 2)
        ab = np.clip((se - t.t0) / trace.GAP_BIN_S, 0, n).astype(np.int64)
        ab = ab[ab[:, 1] > ab[:, 0]]
        mask = np.zeros(n + 1, np.int64)
        np.add.at(mask, ab[:, 0], 1)
        np.add.at(mask, ab[:, 1], -1)
        return np.cumsum(mask)[:n] > 0

    idle = ~bins([(o.start, o.start + o.dur) for o in t.ops])
    out = {}

    def credit(label, intervals):
        nonlocal idle
        hit = idle & bins(intervals)
        if hit.any():
            out[label] = out.get(label, 0.0) + float(hit.sum()) * \
                trace.GAP_BIN_S
            idle &= ~hit

    for main in (True, False):
        mine = [(s, _depth(s)) for s in prog.spans if s.main == main]
        for depth in sorted({d for _, d in mine}, reverse=True):
            for name in sorted({s.name for s, d in mine if d == depth}):
                credit(name, [(s.start, s.end) for s, d in mine
                              if d == depth and s.name == name])
    for main in (True, False):
        for label in sorted({s.label for s in t.spans if s.main == main}):
            credit(label, [(s.start, s.end) for s in t.spans
                           if s.label == label and s.main == main])
    out["none"] = float(idle.sum()) * trace.GAP_BIN_S
    return sorted(out.items(), key=lambda kv: -kv[1])


def summary(t, prog: Program) -> List[str]:
    """Each span name's count, wall and thread CPU ms per Mpix, the
    counters, and the idle gaps credited to the program's spans."""
    out = []
    for name in sorted({s.name for s in prog.spans}):
        mine = [s for s in prog.spans if s.name == name]
        wall = sum(s.end - s.start for s in mine)
        cpu = sum(s.cpu for s in mine)
        out.append(f"program span {name}: {len(mine)}, wall "
                   f"{1e3 * wall / t.mpix:.4f} ms/Mpix, cpu "
                   f"{1e3 * cpu / t.mpix:.4f} ms/Mpix")
    for name, (count, total) in sorted(prog.counters.items()):
        out.append(f"program counter {name}: {count}, {total}")
    gaps = [[k, round(v, 6)] for k, v in idle_gaps(t, prog)]
    out.append(f"program idle gaps: {json.dumps(gaps)}")
    return out


def main(argv) -> int:
    from . import harness, manifest

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    start = time.perf_counter()
    bench = manifest.manifest()
    harness.pin_host(manifest.config(
        manifest.workload(args.workload, bench)["config"]))
    for m in bench["per_layer"]:
        if m["name"] in READERS and args.workload not in m["workloads"]:
            m["workloads"].append(args.workload)
    line, _, _ = harness.measure(args.workload, args.seed, args.seconds,
                                 True, start, bench=bench)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
