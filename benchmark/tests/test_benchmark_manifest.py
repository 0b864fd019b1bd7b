"""BENCHMARK.json keeps to the benchmark's contract, and everything it names
is found by name, so that a new cell is a new file and a new entry."""

import json
import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.manifest()


def test_manifest_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert bench["command"][1].startswith(bench["paths"][0] + "/")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells, 14 runs each and 2 more, fits 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts(bench):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
            for key in ("why", "layer", "source"):
                if key in e and kind != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    assert len(names) == len(set(names))


def test_end_to_end_metrics(bench):
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in by_name and by_name["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        e2e = {m["name"] for m in manifest.metrics_of(cell, "end_to_end",
                                                       bench)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(cell, "per_layer", bench)


def test_per_layer_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        cells = {w["name"] for w in bench["workloads"]}
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in manifest.metrics_of(
                cell, "end_to_end", bench)}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_named_file_is_found(bench):
    files = set()
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = manifest.config(c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert cfg["controls"]
        for entry in cfg["controls"]:
            assert ("params" in entry) != ("module" in entry)
            if "module" in entry:
                assert callable(manifest.control(entry["module"]).encoder)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cfg, mix = manifest.config(w["config"]), manifest.traffic(
            w["traffic"])
        assert mix["pool"] % mix["textures_per_call"] == 0
        assert set(cfg["check"]["limits"]) >= {"bad_files",
                                               "unstable_files"}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(manifest.reader(m["name"]).read)
    kernels = manifest.rooflines()
    assert "min_k_kernel" in kernels and "mode_trial_kernel" in kernels
    for mod in kernels.values():
        assert isinstance(mod.KERNEL, str) and callable(mod.launches)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.fixture
def added_files():
    """New files in the benchmark's folders, removed afterwards."""
    made = []

    def add(rel, text):
        path = manifest.HERE / rel
        assert not path.exists()
        path.write_text(text)
        made.append(path)
    try:
        yield add
    finally:
        for path in made:
            path.unlink()


def test_a_new_cell_needs_only_new_files(added_files, tmp_path, monkeypatch,
                                         bench):
    """A traffic mix, a metric reader and a kernel's bound are new files, a
    cell a new entry; the harness finds each by name, editing nothing."""
    added_files("traffic/zz_tiny.json", json.dumps(
        dict(width=8, height=8, textures_per_call=2, pool=4,
             check_textures=2)))
    added_files("metrics/zz_calls_per_s.py",
                "SPANS = {}\n\n\ndef read(run):\n"
                "    return len(run.window.calls) / run.window.seconds\n")
    added_files("rooflines/zz_kernel.py",
                'KERNEL = "zz_kernel"\n\n\ndef launches(tex):\n'
                "    return [1e-6]\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append(dict(new["workloads"][0],
                                 name="etc1s_q128.zz_tiny", traffic="zz_tiny"))
    new["per_layer"].append(dict(new["per_layer"][0], name="zz_calls_per_s",
                                 unit="1/s", workloads=["etc1s_q128.zz_tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    b = manifest.manifest()
    w = manifest.workload("etc1s_q128.zz_tiny", b)
    assert manifest.traffic(w["traffic"])["width"] == 8
    wanted = manifest.metrics_of(w["name"], "per_layer", b)
    assert "zz_calls_per_s" in [m["name"] for m in wanted]
    assert manifest.reader("zz_calls_per_s").SPANS == {}
    assert manifest.rooflines()["zz_kernel"].launches({}) == [1e-6]
