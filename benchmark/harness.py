"""One run of one cell: set-up, the measured window, the traced run's
readings, the check, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up pins the host (`pin_host`: the configuration's thread counts, the
harness's allocator settings), makes the cell's pool of distinct textures
on the card from the seed, and warms up with one `compress_batch` call of
the cell's own size and mix, the pool's first textures. The window
(`window.py`) runs `basis_universal_tpu_torch.compressor.compress_batch`
back to back from the next textures on. With `--trace 1` the same window
runs under the spans and the device trace (`trace.py`) and reports the
per-layer metrics instead of the end-to-end ones. The check (`check.py`)
runs once the window has closed and the memory peak is read. Standard
error gets the set-up's phases, each call's seconds and, last, each number
the check compared beside its limit.

Exit codes: 0 with a result line; 2 for bad arguments; 3 without the
card(s) the cell asks for; 4 where JAX, Flax or the JAX package was
loaded. A missing program raises ImportError (exit 1).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

from . import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "basis_universal_tpu")


# glibc's mallopt parameters and the values every run sets: freed memory is
# kept (no mmap of large blocks, no trimming, 1 GiB of top pad), so that the
# host path does not page-fault its large arrays afresh in some calls and
# not in others. The same for every cell and both sides of a comparison.
MALLOPT = {"M_TRIM_THRESHOLD": (-1, -1), "M_TOP_PAD": (-2, 1 << 30),
           "M_MMAP_MAX": (-4, 0)}


def pin_host(cfg: dict):
    """The host settings, before the program loads: the configuration's
    BLAS / OpenMP thread counts, and glibc's allocator made to keep what is
    freed (`MALLOPT`). Raises where glibc refuses a setting."""
    os.environ.update(cfg["host"]["env"])
    libc = ctypes.CDLL(None)
    for name, (param, value) in MALLOPT.items():
        if libc.mallopt(ctypes.c_int(param), ctypes.c_int(value)) != 1:
            raise OSError(f"mallopt({name}, {value}) refused")


def _params(cfg: dict, device: str):
    from basis_universal_tpu_torch.compressor import CompressorParams
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat

    kw = dict(cfg["params"])
    kw["tex_format"] = BasisTexFormat[kw["tex_format"]]
    return CompressorParams(**kw, device=device)


def texture_shapes(win, pool, cfg, mix) -> list:
    """Each finished texture's shapes, as the rooflines read them."""
    from .reference.quality import etc1s_clusters
    from .texgen import has_alpha

    out = []
    for call in win.calls:
        for i in call.pool_index[:len(call.outputs)]:
            h, w = pool[i].shape[:2]
            alpha = has_alpha(i, mix.get("alpha_share", 0.0))
            blocks = (h // 4) * (w // 4)
            slices = 2 if alpha and cfg["codec"] == "etc1s" else 1
            q = cfg["params"].get("quality_level", 128)
            e, s = etc1s_clusters(q, blocks * slices)
            out.append(dict(codec=cfg["codec"], blocks=blocks * slices,
                            alpha=alpha, endpoint_clusters=min(e, blocks),
                            selector_clusters=min(s, blocks)))
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class Run:
    """What the metric readers read: `window`, `setup_s`, `trace`."""

    def __init__(self, window, setup_s, trace=None):
        self.window, self.setup_s, self.trace = window, setup_s, trace


def measure(cell: str, seed: int, seconds: float, traced: bool, start: float,
            device: str = "cuda", encode=None, bench: dict = None,
            marks=()):
    """Set-up, window, readings and check of one run; returns the result
    dict (the line's keys) and the check's numbers. encode replaces
    `compress_batch` (the tests' faults and the controls); marks: the
    set-up's phases so far, [(name, clock at its end)]."""
    import torch

    from . import check, texgen, window

    marks = [*marks, ("harness", time.perf_counter())]
    bench = bench or manifest.manifest()
    w = manifest.workload(cell, bench)
    cfg, mix = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    torch.set_num_threads(int(cfg["host"]["torch_threads"]))
    if encode is None:
        from basis_universal_tpu_torch import compressor

        params = _params(cfg, device)

        def encode(textures):
            return compressor.compress_batch(textures, params)
    marks.append(("program", time.perf_counter()))
    torch.zeros(1, device=device)
    marks.append(("context", time.perf_counter()))
    pool = texgen.make_pool(seed, mix, device)
    marks.append(("pool", time.perf_counter()))
    # one call of the window's own size and mix: the window's first call
    # finds its memory and its kernels ready
    per_call = mix["textures_per_call"]
    encode(pool[:per_call])
    if device != "cpu":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - start
    last = start
    phases = []
    for name, t in marks:
        phases.append(f"{name} {t - last:.3f} s")
        last = t
    print(f"set-up: {', '.join(phases)}", file=sys.stderr)

    kind = "per_layer" if traced else "end_to_end"
    wanted = manifest.metrics_of(cell, kind, bench)
    readers = {m["name"]: manifest.reader(m["name"]) for m in wanted}
    spans = dev = None
    if traced:
        from . import trace

        labels = {}
        for r in readers.values():
            for label, names in r.SPANS.items():
                labels.setdefault(label, []).extend(names)
        spans = trace.Spans(labels)
        dev = trace.DeviceTrace()
        dev.__enter__()
    try:
        win = window.run(encode, pool, per_call, seconds,
                         first=per_call % len(pool))
    finally:
        if traced:
            dev.__exit__(None, None, None)
            spans.undo()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    run = Run(win, setup_s)
    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                         else "cpu"),
                "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    result = {}
    if traced:
        from . import trace

        run.trace = trace.Trace(win, win.start, spans.records, dev.ops(),
                                texture_shapes(win, pool, cfg, mix),
                                manifest.rooflines())
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        for text in run.trace.roofline_lines():
            print(text, file=sys.stderr)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    t_check = time.perf_counter()
    correct, numbers, failed, verdicts = check.run(
        win, pool, cfg, cfg["check"]["limits"], seed,
        mix["check_textures"], device=device)
    calls = " ".join(f"{c.seconds:.3f}" for c in win.calls)
    print(f"timing: set-up {setup_s:.3f} s, window {win.seconds:.3f} s "
          f"({len(win.calls)} calls, {win.textures} textures: {calls}), "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    attempted = sum(len(c.pool_index) for c in win.calls)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info, **result,
            "checks": {name: check.entry(v, lim) for name, v, lim in numbers}}
    return line, numbers, verdicts


def main(argv, start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.manifest()
    w = manifest.workload(args.workload, bench)
    cfg = manifest.config(w["config"])
    pin_host(cfg)
    import torch

    marks = [("import torch", time.perf_counter())]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"{args.workload} needs {w['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 3
    marks.append(("card query", time.perf_counter()))
    from .check import describe

    line, numbers, verdicts = measure(args.workload, args.seed,
                                      args.seconds, bool(args.trace), start,
                                      bench=bench, marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    for v in verdicts:
        if not v["valid"] or v["unstable"]:
            print(f"texture {v['where']}: {v['problem'] or 'unstable'}",
                  file=sys.stderr)
    for name, v, lim in numbers:
        print(f"check {name} {v} limit {describe(lim)}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
