"""The readers of the program's own spans and counters
(`program_spans.py`) on a made-up trace: each metric, the idle time credited
to the program's spans before the wrappers' labels, the recorder switched on
by the harness's read of `SPANS` and drained once; and every span name and
counter a reader reads is one the port emits, through `compress_batch` on
the CPU."""

import types

import numpy as np
import pytest

from benchmark import harness, manifest, program_spans, trace

MAIN, WORKER = 1, 2


def span(name, start, end, thread=MAIN, parent=None, cpu=None):
    return types.SimpleNamespace(
        name=name, start=start, end=end, thread=thread, main=thread == MAIN,
        parent=parent, cpu=end - start if cpu is None else cpu)


class FakeRecorder:
    """The port's recorder as the readers see it: its switch and drain;
    `window()` records the made-up spans and counters."""

    def __init__(self, spans, counters):
        self.on, self.held, self.made = False, ([], {}), (spans, counters)
        self.drains = 0

    def window(self):
        self.held = self.made

    def record(self, on=True):
        self.on = on

    def recording(self):
        return self.on

    def drain(self):
        self.drains += 1
        out, self.held = self.held, ([], {})
        return out


def made_up():
    """A 1 s window from 10 s, 2 Mpix: the card busy 10.0-10.1; the main
    thread in one call with a dispatch, a wait and the drain; a pool thread
    in an assembly and its RDO; the wrappers' spans; one span before the
    window."""
    call = span("compress_batch", 10.0, 10.9)
    disp = span("etc1s.frontend.dispatch", 10.1, 10.3, parent=call,
                cpu=0.15)
    wait = span("etc1s.frontend.wait", 10.3, 10.4, parent=call)
    drain = span("etc1s.drain", 10.85, 10.9, parent=call, cpu=0.0)
    asm = span("etc1s.assembly", 10.2, 10.95, WORKER, parent=disp)
    rdo = span("etc1s.assembly.rdo", 10.85, 10.95, WORKER, parent=asm)
    early = span("etc1s.frontend.wait", 9.0, 9.5)
    spans = [disp, wait, rdo, asm, drain, call, early]
    wrappers = [trace.Span("frontend", 10.1, 10.4, True),
                trace.Span("assembly", 10.2, 10.97, False)]
    win = types.SimpleNamespace(seconds=1.0, mpix=2.0, calls=[])
    t = trace.Trace(win, 10.0, wrappers, [trace.DeviceOp("k", 10.0, 0.1,
                                                         "kernel")],
                    [], manifest.rooflines())
    return t, spans, {"upload_bytes": (3, 7e6)}


@pytest.fixture
def recorder(monkeypatch):
    t, spans, counters = made_up()
    fake = FakeRecorder(spans, counters)
    monkeypatch.setattr(program_spans, "_telemetry", lambda: fake)
    return fake, harness.Run(t.window, 1.0, t)


def read(name, run):
    return manifest.reader(name).read(run)


def test_readers_read_the_window_once(recorder):
    fake, run = recorder
    for name in program_spans.READERS:
        assert manifest.reader(name).SPANS == {}
    assert fake.on and fake.drains == len(program_spans.READERS)
    fake.window()
    assert read("frontend_dispatch_ms_per_mpix", run) == pytest.approx(100.0)
    assert read("frontend_wait_ms_per_mpix", run) == pytest.approx(50.0)
    assert read("assembly_drain_ms_per_mpix", run) == pytest.approx(25.0)
    assert read("uastc_search_wait_ms_per_mpix", run) is None
    assert read("main_offcpu_ms_per_mpix", run) == pytest.approx(25.0)
    assert read("upload_mb_per_mpix", run) == pytest.approx(3.5)
    assert not fake.on and fake.drains == len(program_spans.READERS) + 1
    assert len(program_spans.of(run).spans) == 6        # the early one out


def test_idle_credited_to_program_spans_innermost_main_first(recorder):
    fake, run = recorder
    fake.record(True)
    fake.window()
    gaps = dict(program_spans.idle_gaps(run.trace, program_spans.of(run)))
    want = {"etc1s.frontend.dispatch": 0.2, "etc1s.frontend.wait": 0.1,
            "etc1s.drain": 0.05, "compress_batch": 0.45,
            "etc1s.assembly.rdo": 0.05, "assembly": 0.02, "none": 0.03}
    assert set(gaps) == set(want)
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v, abs=1e-4), k
    # the wrappers' own crediting is unchanged
    assert dict(run.trace.idle_gaps())["frontend"] == pytest.approx(
        0.3, abs=1e-4)


def test_without_the_recorder_every_reader_is_none(monkeypatch):
    t, _, _ = made_up()
    monkeypatch.setattr(program_spans, "_telemetry", lambda: None)
    run = harness.Run(t.window, 1.0, t)
    for name in program_spans.READERS:
        assert manifest.reader(name).SPANS == {}
        assert read(name, run) is None


def test_reading_spans_switches_the_ports_recorder_on():
    from basis_universal_tpu_torch.utils import telemetry

    try:
        telemetry.record(False)
        assert manifest.reader("upload_mb_per_mpix").SPANS == {}
        assert telemetry.recording()
        with pytest.raises(AttributeError):
            manifest.reader("upload_mb_per_mpix").NOTHING
    finally:
        telemetry.record(False)
        telemetry.drain()


def test_readers_are_the_manifests():
    bench = manifest.manifest()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in program_spans.READERS:
        assert by_name[name]["source"] in ("program_span", "program_counter")
        assert by_name[name]["moves"] == "encode_mpix_s"


def test_every_name_a_reader_reads_is_emitted():
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.utils import telemetry

    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(2)]
    names, counters = set(), set()
    for fmt in (BasisTexFormat.ETC1S, BasisTexFormat.UASTC_LDR_4x4):
        params = compressor.CompressorParams(tex_format=fmt, device="cpu")
        telemetry.drain()
        telemetry.record(True)
        try:
            compressor.compress_batch(images, params)
        finally:
            telemetry.record(False)
        spans, counts = telemetry.drain()
        names |= {s.name for s in spans}
        counters |= set(counts)
    assert set(program_spans.HOST_WORK) <= names
    for name in program_spans.READERS:
        reader = manifest.reader(name)
        read_spans = set(getattr(reader, "PROGRAM_SPANS", ()))
        read_counters = set(getattr(reader, "PROGRAM_COUNTERS", ()))
        assert read_spans or read_counters
        assert read_spans <= names and read_counters <= counters, name
    telemetry.record(False)
