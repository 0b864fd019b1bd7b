"""The check that decides `correct`, driven through the harness on the CPU at
a small size (the look for a card skipped, everything else as in a run):
sound runs pass; each control and each fault a cell can have fails."""

import dataclasses
import time

import numpy as np
import pytest

from benchmark import check, harness, manifest
from benchmark.reference import verify

SEED = 2 ** 31 + 99
TINY = dict(width=64, height=64, textures_per_call=4, pool=8,
            check_textures=4)
CELLS = ["etc1s_q128.build_kodak", "uastc_l2.build_kodak_rgba"]
REAL_TRAFFIC = manifest.traffic


def tiny(**kw):
    """Each cell's own mix (its alpha share) at a size the CPU runs."""
    return lambda name: {**REAL_TRAFFIC(name), **TINY, **kw}


@pytest.fixture(autouse=True)
def tiny_traffic(monkeypatch):
    monkeypatch.setattr(manifest, "traffic", tiny())


def run(cell, encode=None, seconds=0.0):
    line, numbers, verdicts = harness.measure(
        cell, SEED, seconds, False, time.perf_counter(), device="cpu",
        encode=encode)
    return line, {n: v for n, v, _ in numbers}


def program(cell):
    from basis_universal_tpu_torch import compressor

    cfg = manifest.config(manifest.workload(cell)["config"])
    params = harness._params(cfg, "cpu")
    return params, lambda tex: compressor.compress_batch(tex, params)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line, values = run(cell, seconds=0.5)
    assert line["correct"], line["checks"]
    assert values["bad_files"] == 0 and values["unstable_files"] == 0
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 4 and line["failed"] == 0
    assert {"encode_mpix_s", "setup_s"} <= set(line["metrics"])


def controls(cell):
    """The configuration's control (its first entry) and the faults planted
    by a module of controls/; the other lowered parameters are read on the
    card at the cell's size (readings.py), where the sizes they change
    differ (quality 127's selector codebook is quality 128's at 64x64)."""
    entries = manifest.config(manifest.workload(cell)["config"])["controls"]
    return entries[:1] + [c for c in entries[1:] if "module" in c]


@pytest.mark.parametrize("cell, entry", [
    (cell, c) for cell in CELLS for c in controls(cell)],
    ids=lambda x: x if isinstance(x, str) else x["name"])
def test_the_control_is_not_correct(cell, entry):
    params, _ = program(cell)
    line, values = run(cell, manifest.control_encoder(entry, params))
    assert not line["correct"], line["checks"]


def stale(encode):
    """A step that returns its state unchanged: every call after the first
    gives back the first call's outputs."""
    first = []

    def broken(tex):
        if not first:
            first.append(encode(tex))
        return first[0]
    return broken


def half_left_out(encode):
    def broken(tex):
        return encode(tex)[:len(tex) // 2]
    return broken


def byte_altered(encode):
    """One output's answer altered where it is produced: a byte of its
    first slice's data."""
    def broken(tex):
        outs = encode(tex)
        data = bytearray(outs[1].basis_data)
        data[-3] ^= 0x10
        outs[1] = dataclasses.replace(outs[1], basis_data=bytes(data))
        return outs
    return broken


def answers_swapped(encode):
    """Two textures' files, each sound, handed back in each other's place."""
    def broken(tex):
        outs = encode(tex)
        outs[0], outs[1] = outs[1], outs[0]
        return outs
    return broken


@pytest.mark.parametrize("fault", [stale, half_left_out, byte_altered,
                                   answers_swapped])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_underneath_is_not_correct(cell, fault, monkeypatch):
    # every texture of the window judged, so the fault cannot miss the sample
    monkeypatch.setattr(manifest, "traffic", tiny(check_textures=64))
    _, encode = program(cell)
    line, values = run(cell, fault(encode), seconds=0.5)
    assert not line["correct"], (fault.__name__, line["checks"])


def test_sample_is_drawn_from_the_seed():
    calls = [type("C", (), {"outputs": [0] * 4, "pool_index": [0] * 4})()
             for _ in range(5)]
    win = type("W", (), {"calls": calls})()
    a = check.draw_sample(win, 6, 123)
    assert a == check.draw_sample(win, 6, 123)
    assert a != check.draw_sample(win, 6, 124)
    assert len(set(a)) == 6
    assert len(check.draw_sample(win, 100, 1)) == 20


@pytest.mark.parametrize("codec", ["etc1s", "uastc"])
def test_the_reference_reads_the_ports_files(codec):
    """RGB and RGBA textures of both codecs decode in the reference with
    every CRC right; a texture judged against another's file reads far
    worse."""
    from basis_universal_tpu_torch import compressor

    from benchmark import texgen

    cfg = manifest.config({"etc1s": "etc1s_q128", "uastc": "uastc_l2"}[codec])
    params = harness._params(cfg, "cpu")
    tex = [texgen.synthetic_texture(64, 96, texgen.texture_seed(5, i),
                                    i == 1, "cpu").numpy() for i in range(2)]
    outs = [compressor.compress(t, params) for t in tex]
    for t, o in zip(tex, outs):
        v = verify.judge(t, o.basis_data, o.ktx2_data, codec, 128)
        assert v["valid"], v["problem"]
        assert 0 < v["ratio"] < 2.0
    swapped = verify.judge(tex[0][..., :3].copy(), outs[1].basis_data,
                           outs[1].ktx2_data, codec, 128)
    assert not swapped["valid"] or swapped["ratio"] > 5.0
    ktx = bytearray(outs[0].ktx2_data)
    ktx[-1] ^= 1
    bad = verify.judge(tex[0], outs[0].basis_data, bytes(ktx), codec, 128)
    assert not bad["valid"]


def test_codebook_sizes_are_held_to_the_quality_level():
    from basis_universal_tpu_torch import compressor

    from benchmark import texgen

    t = texgen.synthetic_texture(64, 64, 11, False, "cpu").numpy()
    params = compressor.CompressorParams(quality_level=255, device="cpu")
    o = compressor.compress(t, params)
    assert verify.judge(t, o.basis_data, o.ktx2_data, "etc1s", 255)["valid"]
    v = verify.judge(t, o.basis_data, o.ktx2_data, "etc1s", 1)
    assert not v["valid"] and "past quality" in v["problem"]


def test_numbers_fail_when_unread():
    win = type("W", (), {"calls": [], "missing": 0})()
    ok, numbers, failed, _ = check.run(
        win, [], {"codec": "etc1s", "params": {}},
        {"bad_files": 0, "error_ratio": 2.0}, 1, 4)
    assert not ok and dict((n, v) for n, v, _ in numbers)["error_ratio"] \
        is None
    assert np.isfinite(failed)
