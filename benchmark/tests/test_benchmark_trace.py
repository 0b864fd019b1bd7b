"""The traced run's arithmetic on a made-up trace: busy time, idle gaps
credited to the host's work, op names, and the metric readers."""

import types

import pytest

from benchmark import harness, manifest, trace


def make(ops, spans, seconds=1.0, mpix=2.0):
    win = types.SimpleNamespace(seconds=seconds, mpix=mpix, calls=[])
    return trace.Trace(win, 10.0, spans,
                       [trace.DeviceOp(n, s, d, trace._kind(n))
                        for n, s, d in ops], [], manifest.rooflines())


def test_busy_time_is_the_union_inside_the_window():
    t = make([("k1", 10.1, 0.2), ("k2", 10.2, 0.2),   # overlap: 10.1-10.4
              ("Memcpy HtoD (Pageable -> Device)", 10.5, 0.1),
              ("k3", 10.95, 0.1),                      # half inside
              ("k4", 9.0, 0.5)], [])                   # before the window
    assert t.busy_s == pytest.approx(0.45)
    assert len(t.kernels) == 3 and len(t.ops) == 4


@pytest.mark.parametrize("lost", [None, 0, 1])
def test_marker_offset_survives_one_lost_marker(lost):
    """Host marks at 10 s and 55 s, the device clock 3 s ahead, activity
    between them; either marker alone gives the same offset."""
    marks = [10.0, 55.0]
    found = [int((t + 3.0) * 1e9) for t in marks]
    starts = [int(13.5e9), int(50e9)]
    if lost is not None:
        del found[lost]
    assert trace.marker_offset(found, marks, starts) == pytest.approx(3.0)


def test_marker_offset_needs_a_marker():
    with pytest.raises(RuntimeError, match="0 of 2 markers"):
        trace.marker_offset([], [10.0, 55.0], [1])


def test_idle_gaps_credit_the_main_thread_first():
    spans = [trace.Span("frontend", 10.0, 10.5, True),
             trace.Span("assembly", 10.3, 11.0, False),
             trace.Span("prep", 10.8, 10.9, True)]
    t = make([("k", 10.0, 0.1)], spans)
    gaps = dict(t.idle_gaps())
    assert gaps["frontend"] == pytest.approx(0.4, abs=1e-4)
    assert gaps["prep"] == pytest.approx(0.1, abs=1e-4)
    assert gaps["assembly"] == pytest.approx(0.4, abs=1e-4)
    assert gaps.get("none", 0.0) == pytest.approx(0.0, abs=1e-4)
    assert sum(gaps.values()) == pytest.approx(0.9, abs=1e-4)


def test_breakdown_names_and_order():
    t = make([("void (anonymous namespace)::min_k_kernel<true>(float "
               "const*, int)", 10.0, 0.3),
              ("void at::native::(anonymous namespace)::foo<1>(int)", 10.4,
               0.1),
              ("Memset (Device)", 10.6, 0.05)], [])
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["min_k_kernel<true>",
                                               "at::native::foo<1>",
                                               "Memset"]
    assert b["idle_gaps"][0][0] == "none"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_per_layer_readers():
    spans = [trace.Span("prep", 10.0, 10.2, True),
             trace.Span("assembly", 10.1, 10.6, False),
             trace.Span("assembly", 10.2, 10.4, False)]
    t = make([("k", 10.0, 0.25), ("j", 10.5, 0.25)], spans)
    run = harness.Run(t.window, 1.0, t)

    def read(name):
        return manifest.reader(name).read(run)
    assert read("host_prep_ms_per_mpix") == pytest.approx(100.0)
    assert read("host_assembly_ms_per_mpix") == pytest.approx(350.0)
    assert read("frontend_ms_per_mpix") is None
    assert read("uastc_search_ms_per_mpix") is None
    assert read("device_idle_pct") == pytest.approx(50.0)
    assert read("device_launches_per_mpix") == pytest.approx(1.0)
    assert read("kernels_roofline") is None
    assert read("min_k_roofline") is None


def test_end_to_end_readers():
    win = types.SimpleNamespace(seconds=4.0, mpix=10.0, texels=10_000_000,
                                basis_bytes=1_250_000)
    run = harness.Run(win, 12.5)
    assert manifest.reader("encode_mpix_s").read(run) == 2.5
    assert manifest.reader("window_mpix_s").read(run) == 2.5
    assert manifest.reader("bits_per_texel").read(run) == 1.0
    assert manifest.reader("setup_s").read(run) == 12.5


def test_every_reader_names_functions_the_port_has():
    import importlib

    for m in manifest.manifest()["per_layer"]:
        for names in manifest.reader(m["name"]).SPANS.values():
            for name in names:
                mod, fn = name.split(":")
                assert callable(getattr(importlib.import_module(mod), fn))


def test_spans_wrap_and_restore():
    from basis_universal_tpu_torch import compressor

    original = compressor._rdo_thresholds
    s = trace.Spans({"x": ["basis_universal_tpu_torch.compressor:"
                           "_rdo_thresholds"]})
    assert compressor._rdo_thresholds is not original
    compressor._rdo_thresholds(compressor.CompressorParams(device="cpu"))
    s.undo()
    assert compressor._rdo_thresholds is original
    assert [(r.label, r.main) for r in s.records] == [("x", True)]
