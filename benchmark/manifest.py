"""Finds what a cell is made of by name: `BENCHMARK.json` at the root of the
checkout, `configs/<config>.json`, `traffic/<mix>.json`,
`metrics/<metric>.py`, `rooflines/<kernel>.py` and
`controls/<control>.py`. A new cell, mix, metric, kernel or control is a
new file and a new entry; nothing here names one."""

import importlib
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: dict = None) -> dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def metrics_of(cell: str, kind: str, bench: dict = None) -> list:
    """The manifest's `end_to_end` or `per_layer` entries this cell
    reports: those without `workloads`, and those that list it."""
    bench = bench or manifest()
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """metrics/<metric>.py: `read(run)` -> a number, or None where the run
    holds nothing to read (`harness.Run`: the window, the set-up time and,
    traced, the trace); `SPANS`, the program functions it needs timed,
    {label: ["module:function", ...]}."""
    return importlib.import_module(f"{__package__}.metrics.{metric}")


def control(name: str):
    """controls/<name>.py: `encoder(params)` -> a function that takes the
    program's place in the window and breaks a guarantee."""
    return importlib.import_module(f"{__package__}.controls.{name}")


def control_encoder(entry: dict, params):
    """One of a configuration's `controls` (the first is the check's
    control, the others the faults its limits are read against; the
    readings and the tests run them, a run never does): the program with
    some of its parameters lowered, {"name", "params"}, or a module of
    controls/, {"name", "module"}. -> encode(textures)."""
    if "module" in entry:
        return control(entry["module"]).encoder(params)
    import dataclasses

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat

    kw = dict(entry["params"])
    if "tex_format" in kw:
        kw["tex_format"] = BasisTexFormat[kw["tex_format"]]
    lower = dataclasses.replace(params, **kw)

    def encode(textures):
        return compressor.compress_batch(textures, lower)
    return encode


def rooflines() -> dict:
    """Every rooflines/<kernel>.py by kernel: `KERNEL` (a pattern of the
    kernel's name in the device trace) and `launches(tex)`, each launch's
    least seconds for one texture."""
    out = {}
    for path in sorted((HERE / "rooflines").glob("*.py")):
        if not path.stem.startswith("_"):
            out[path.stem] = importlib.import_module(
                f"{__package__}.rooflines.{path.stem}")
    return out
