"""The port's span and counter recorder (`utils/telemetry.py`) on the CPU:
off it records nothing; on, spans carry their parents, call and texture
ids across threads and their thread's CPU time, counters add, and `drain`
empties it; its spans reach the profiler only while the device trace runs.
Then through `compressor.compress_batch`: every span of the entry, the
frontend, the assembly pool and the UASTC search, once per texture or per
call, the main thread's spans tiling the call, and the `upload_bytes`
counter against the arrays handed to the device."""

import concurrent.futures as cf
import sys
import threading
import time

import numpy as np
import pytest
import torch

from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.codecs.etc1s import frontend
from basis_universal_tpu_torch.formats.constants import BasisTexFormat
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu_torch.utils import telemetry

ETC1S_PER_TEXTURE = ("etc1s.frontend.dispatch", "etc1s.frontend.wait",
                     "etc1s.frontend.finalize", "etc1s.assembly",
                     "etc1s.assembly.rdo", "etc1s.assembly.palettes",
                     "etc1s.assembly.pack", "etc1s.assembly.write")
UASTC_PER_TEXTURE = ("uastc.upload", "uastc.search.dispatch",
                     "uastc.search.wait", "uastc.container")


@pytest.fixture
def recorder():
    """The recorder switched on, and off and empty afterwards."""
    telemetry.drain()
    telemetry.record(True)
    try:
        yield telemetry
    finally:
        telemetry.record(False)
        telemetry.drain()


def test_off_records_nothing():
    telemetry.record(False)
    telemetry.drain()
    assert telemetry.span("a") is telemetry.span("b", texture=1)
    with telemetry.span("a", new_call=True) as s:
        telemetry.count("c", 5)
    assert s is None and telemetry.last() is None
    assert telemetry.drain() == ([], {})


def test_parents_and_ids_cross_to_a_worker_thread(recorder):
    with telemetry.span("call", new_call=True) as call:
        with telemetry.span("stage", texture=2) as stage:
            pass
        handed = telemetry.last()

        def job():
            with telemetry.span("job", parent=handed) as j:
                with telemetry.span("job.step") as step:
                    pass
            return j, step

        with cf.ThreadPoolExecutor(1) as ex:
            j, step = ex.submit(job).result(timeout=60)
    assert handed is stage and stage.parent is call
    assert (stage.call, stage.texture) == (call.call, 2)
    assert j.parent is stage and step.parent is j
    assert (j.call, j.texture) == (step.call, step.texture) == (call.call, 2)
    assert call.main and stage.main and not j.main and not step.main
    assert j.thread == step.thread != call.thread
    with telemetry.span("next", new_call=True) as nxt:
        pass
    assert nxt.call == call.call + 1 and nxt.parent is None


def test_thread_cpu_is_at_most_the_wall_time(recorder):
    with telemetry.span("busy") as busy:
        t = time.perf_counter()
        while time.perf_counter() - t < 0.05:
            pass
    with telemetry.span("asleep") as asleep:
        time.sleep(0.05)
    for s in (busy, asleep):
        assert 0.0 <= s.cpu <= s.end - s.start
    assert busy.cpu > 0.25 * (busy.end - busy.start)
    assert asleep.cpu < 0.5 * (asleep.end - asleep.start)


def test_counters_add_across_threads(recorder):
    """16 threads count and record at a short switch interval: no update
    is lost."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(500):
                telemetry.count("n", k)
                with telemetry.span("s"):
                    pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    telemetry.count("m", 2.5)
    spans, counters = telemetry.drain()
    assert counters == {"n": (16 * 500, 500 * sum(range(16))), "m": (1, 2.5)}
    assert len(spans) == 16 * 500


def test_drain_empties(recorder):
    with telemetry.span("a"):
        telemetry.count("c", 3)
    spans, counters = telemetry.drain()
    assert [s.name for s in spans] == ["a"] and counters == {"c": (1, 3)}
    assert telemetry.drain() == ([], {})


def test_spans_reach_the_profiler_only_while_the_device_trace_runs(
        recorder, tmp_path):
    x = torch.ones(32, 32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with telemetry.span("outside.trace"):
            (x @ x).sum()
    assert not any(e.key == "outside.trace" for e in prof.key_averages())
    telemetry.start_device_trace(tmp_path, device="cpu")
    with telemetry.span("inside.trace"):
        (x @ x).sum()
    prof = telemetry.stop_device_trace()
    keys = {e.key for e in prof.key_averages()}
    assert "inside.trace" in keys and "outside.trace" not in keys
    assert "inside.trace" in (tmp_path / "trace.json").read_text()
    assert [s.name for s in telemetry.drain()[0]] == ["outside.trace",
                                                      "inside.trace"]


# --- through compress_batch ------------------------------------------------

def _textures(n, seed):
    return [synthetic_texture(64, 64, seed=seed + i, alpha=False)[0][..., :3]
            for i in range(n)]


@pytest.fixture(scope="module")
def traced():
    """3 ETC1S and 2 UASTC textures through compress_batch, the recorder
    on, each call's spans and counters; and the same calls with it off."""
    etc1s = _textures(3, 40)
    uastc = _textures(2, 50)
    p_etc1s = compressor.CompressorParams(device="cpu")
    p_uastc = compressor.CompressorParams(
        tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2, device="cpu")
    telemetry.drain()
    out = {}
    for name, images, params in (("etc1s", etc1s, p_etc1s),
                                 ("uastc", uastc, p_uastc)):
        telemetry.record(True)
        try:
            files = compressor.compress_batch(images, params)
        finally:
            telemetry.record(False)
        spans, counters = telemetry.drain()
        off = compressor.compress_batch(images, params)
        out[name] = dict(images=images, params=params, files=files,
                         off=off, spans=spans, counters=counters)
    assert telemetry.drain() == ([], {})
    return out


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("codec,per_call,per_texture,n", [
    ("etc1s", ("compress_batch", "etc1s.prep", "etc1s.drain"),
     ETC1S_PER_TEXTURE, 3),
    ("uastc", ("compress_batch", "uastc.prep"), UASTC_PER_TEXTURE, 2)])
def test_each_span_once_a_call_or_a_texture(traced, codec, per_call,
                                            per_texture, n):
    run = traced[codec]
    by_name = _by_name(run["spans"])
    assert set(by_name) == set(per_call) | set(per_texture)
    (call,) = by_name["compress_batch"]
    for name in per_call:
        assert len(by_name[name]) == 1
    for name in per_texture:
        assert sorted(s.texture for s in by_name[name]) == list(range(n))
    assert all(s.call == call.call for s in run["spans"])
    assert [f.basis_data for f in run["files"]] == \
        [f.basis_data for f in run["off"]]


@pytest.mark.parametrize("codec", ["etc1s", "uastc"])
def test_main_thread_spans_tile_the_call(traced, codec):
    spans = traced[codec]["spans"]
    (call,) = [s for s in spans if s.name == "compress_batch"]
    main = sorted((s for s in spans if s.main and s is not call),
                  key=lambda s: s.start)
    assert main and all(s.parent is call for s in main)
    assert call.start <= main[0].start and main[-1].end <= call.end
    for a, b in zip(main, main[1:]):
        assert a.end <= b.start, (a, b)
    covered = sum(s.end - s.start for s in main)
    assert covered > 0.9 * (call.end - call.start)


def test_assembly_follows_its_textures_frontend(traced):
    by_name = _by_name(traced["etc1s"]["spans"])
    waits = {s.texture: s for s in by_name["etc1s.frontend.wait"]}
    for a in by_name["etc1s.assembly"]:
        assert not a.main
        assert a.parent.name == "etc1s.frontend.finalize" and a.parent.main
        assert (a.call, a.texture) == (a.parent.call, a.parent.texture)
        assert a.start >= waits[a.texture].end
    for name in ETC1S_PER_TEXTURE[4:]:
        for s in by_name[name]:
            assert s.parent.name == "etc1s.assembly"
            assert s.thread == s.parent.thread


def test_upload_bytes_are_the_arrays_handed_to_the_device(traced):
    want_etc1s = []
    params = traced["etc1s"]["params"]
    for img in traced["etc1s"]["images"]:
        slices = compressor._prepare_slices([img], params)
        left, up = compressor._slice_neighbors(slices)
        blocks = np.concatenate([s["blocks"] for s in slices])
        # the pixels, the fill indices of empty k-means seeds, the neighbours
        knobs, _, _ = frontend._knobs_and_neighbors(
            len(blocks), compressor._frontend_params(params, len(blocks)), None)
        (fill,) = frontend.fill_indices([0], len(blocks), knobs["num_e"])
        want_etc1s += [blocks.nbytes, fill.nbytes, left.nbytes, up.nbytes]
    assert traced["etc1s"]["counters"] == {
        "upload_bytes": (len(want_etc1s), sum(want_etc1s))}
    want_uastc = []
    for img in traced["uastc"]["images"]:
        (s,), _ = compressor._prep_uastc_slices([img],
                                                traced["uastc"]["params"])
        want_uastc.append(s["px"].astype(np.uint8).nbytes)
    assert traced["uastc"]["counters"] == {
        "upload_bytes": (len(want_uastc), sum(want_uastc))}
    assert sum(want_etc1s) == 3 * 256 * (48 + 8) + 3 * 144 * 8
    assert sum(want_uastc) == 2 * 256 * 64
