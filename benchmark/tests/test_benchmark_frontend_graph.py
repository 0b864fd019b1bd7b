"""`frontend_graph_pct`'s reader on a recorded counter drain: the replays
over the window's frontend runs, and None where the program counts no
graph (a program without them, or without the recorder)."""

import pytest

from benchmark import harness, manifest, program_spans
from benchmark.tests.test_benchmark_program_spans import (
    FakeRecorder, made_up, span)

NAME = "frontend_graph_pct"


def _run(monkeypatch, counters, dispatches=4):
    t, spans, _ = made_up()
    spans = spans + [span("etc1s.frontend.dispatch", 10.3 + 0.1 * i,
                          10.35 + 0.1 * i) for i in range(dispatches - 1)]
    fake = FakeRecorder(spans, counters)
    monkeypatch.setattr(program_spans, "_telemetry", lambda: fake)
    assert manifest.reader(NAME).SPANS == {}
    fake.window()
    return harness.Run(t.window, 1.0, t)


@pytest.mark.parametrize("replays,want", [(4, 100.0), (3, 75.0), (0, 0.0)])
def test_replays_over_the_windows_frontend_runs(monkeypatch, replays, want):
    counters = {"upload_bytes": (16, 2e6),
                "etc1s.frontend.graph_captures": (1, 1.0)}
    if replays:
        counters["etc1s.frontend.graph_replays"] = (replays, float(replays))
    run = _run(monkeypatch, counters)
    assert manifest.reader(NAME).read(run) == pytest.approx(want)


def test_none_without_the_counters(monkeypatch):
    run = _run(monkeypatch, {"upload_bytes": (16, 2e6)})
    assert manifest.reader(NAME).read(run) is None
    monkeypatch.setattr(program_spans, "_telemetry", lambda: None)
    t, _, _ = made_up()
    assert manifest.reader(NAME).read(harness.Run(t.window, 1.0, t)) is None


def test_the_manifest_entry():
    (m,) = [m for m in manifest.manifest()["per_layer"] if m["name"] == NAME]
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["layer"] == "ETC1S frontend" and m["moves"] == "encode_mpix_s"
    assert m["workloads"] == ["etc1s_q128.build_kodak"]


def test_the_counters_are_the_ports():
    """The port counts what the reader reads, by these names."""
    import inspect

    from basis_universal_tpu_torch.codecs.etc1s import frontend

    src = inspect.getsource(frontend)
    reader = manifest.reader(NAME)
    for name in reader.PROGRAM_COUNTERS + reader.PROGRAM_SPANS:
        assert f'"{name}"' in src
