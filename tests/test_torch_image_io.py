"""The port's image I/O (`basis_universal_tpu_torch/utils/image_io.py`, a copy
of the reference's) against the reference's loaders, and the port's
telemetry (`utils/telemetry.py`), on the CPU.

Every input file is written by the test itself from a seeded synthetic
texture: QOI (a small encoder here, every opcode), RGBA8 and BC1 .dds
(`write_dds`), Radiance .hdr (flat and run-length rows) and OpenEXR with
NONE and ZIP compression (HALF and FLOAT channels). Loaders must give
arrays equal to the reference's, bit for bit; `write_dds` -> `load_dds`
and `write_ktx1` round-trip their payloads.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from basis_universal_tpu.utils import image_io as ref_io
from basis_universal_tpu_torch.ops import transcode as tc
from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu_torch.utils import image_io, telemetry


def _img(h=24, w=40, seed=5, alpha=True):
    return synthetic_texture(h, w, seed=seed, alpha=alpha)[0]


def _qoi_bytes(rgba):
    """QOI encoder (public spec): RUN, INDEX, DIFF, LUMA, RGB and RGBA."""
    h, w, _ = rgba.shape
    out = bytearray(b"qoif" + struct.pack(">II", w, h) + bytes([4, 0]))
    index = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    flat = [tuple(int(c) for c in p) for p in rgba.reshape(-1, 4)]
    for i, px in enumerate(flat):
        if px == prev:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h_ = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) & 63
        if index[h_] == px:
            out.append(h_)
        elif px[3] != prev[3]:
            out += bytes([0xFF, *px])
        else:
            dr, dg, db = ((px[c] - prev[c] + 128) % 256 - 128 for c in range(3))
            if all(-2 <= d <= 1 for d in (dr, dg, db)):
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif -32 <= dg <= 31 and all(-8 <= d - dg <= 7 for d in (dr, db)):
                out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
            else:
                out += bytes([0xFE, *px[:3]])
        index[h_] = px
        prev = px
    return bytes(out + b"\0" * 7 + b"\1")


def test_qoi_matches_the_reference_and_the_source(tmp_path):
    img = _img()
    img[3:6] = img[3, 0]                    # long runs
    img[10, ::2] = img[10, 1::2]            # index hits
    p = tmp_path / "t.qoi"
    p.write_bytes(_qoi_bytes(img))
    got = image_io.load_qoi(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, ref_io.load_qoi(p))
    np.testing.assert_array_equal(image_io.load_image(p), got)


@pytest.mark.parametrize("fmt", ["RGBA8", "BC1"])
def test_dds_write_load_matches_the_reference(tmp_path, fmt):
    img = _img(32, 48)
    if fmt == "RGBA8":
        payload = np.ascontiguousarray(img).tobytes()
    else:
        px = image_to_blocks(img).astype(np.float64).reshape(-1, 16, 4)
        payload = tc.rgba_blocks_to_bc1(px).tobytes()
    p = tmp_path / "t.dds"
    image_io.write_dds(p, payload, 48, 32, fmt)
    q = tmp_path / "ref.dds"
    ref_io.write_dds(q, payload, 48, 32, fmt)
    assert p.read_bytes() == q.read_bytes()
    got, info = image_io.load_dds(p)
    want, ref_info = ref_io.load_dds(p)
    np.testing.assert_array_equal(got, want)
    assert info == ref_info and info["format"] == fmt
    assert info["raw"] == payload
    if fmt == "RGBA8":
        np.testing.assert_array_equal(got, img)
    else:
        mse = np.mean((got[..., :3].astype(np.float64) - img[..., :3]) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 20.0
    np.testing.assert_array_equal(image_io.load_image(p), got)


def test_ktx1_write(tmp_path):
    data = bytes(np.random.default_rng(3).integers(0, 256, 512, np.uint8))
    for fmt in ("BC1", "ETC1", "ASTC_4x4"):
        p, q = tmp_path / f"{fmt}.ktx", tmp_path / f"{fmt}_ref.ktx"
        image_io.write_ktx1(p, data, 32, 32, fmt)
        ref_io.write_ktx1(q, data, 32, 32, fmt)
        raw = p.read_bytes()
        assert raw == q.read_bytes()
        assert raw[:7] == bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31])
        assert struct.unpack_from("<I", raw, 64)[0] == len(data)
        assert raw[68:] == data


def _rgbe(hdr):
    """float RGB -> Radiance RGBE bytes (h, w, 4)."""
    m = hdr.max(-1)
    mant, ex = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.maximum(m, 1e-38), 0.0)
    rgbe = np.zeros(hdr.shape[:2] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(hdr * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, ex + 128, 0)
    return rgbe


def _rle_row(row):
    """One new-style run-length row (4 channels of w bytes)."""
    w = row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 255])
    for c in range(4):
        ch = row[:, c]
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 127 and ch[x + run] == ch[x]:
                run += 1
            if run >= 3:
                out += bytes([128 + run, ch[x]])
                x += run
            else:
                n = min(128, w - x)
                out += bytes([n]) + ch[x:x + n].tobytes()
                x += n
    return bytes(out)


@pytest.mark.parametrize("rle", [False, True])
def test_radiance_hdr_matches_the_reference(tmp_path, rle):
    rng = np.random.default_rng(9)
    h, w = 12, 20
    hdr = rng.uniform(0, 8, (h, w, 3)).astype(np.float32)
    hdr[2:4] = 1.5                                  # runs for the RLE rows
    rgbe = _rgbe(hdr)
    body = b"".join(_rle_row(r) if rle else r.tobytes() for r in rgbe)
    p = tmp_path / "t.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                  + f"-Y {h} +X {w}\n".encode() + body)
    got = image_io.load_image_hdr(p)
    want = ref_io.load_image_hdr(p)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, hdr, rtol=0.02, atol=0.05)


def _exr_bytes(chans, comp):
    """Scanline OpenEXR: chans {name: (h, w) float array, pixel type 1 HALF
    or 2 FLOAT}; comp 0 (NONE) or 3 (ZIP, 16 lines per chunk)."""
    names = sorted(chans)
    h, w = chans[names[0]][0].shape

    def attr(name, typ, data):
        return name.encode() + b"\0" + typ.encode() + b"\0" + \
            struct.pack("<I", len(data)) + data

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i", chans[n][1])
                      + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
                      for n in names) + b"\0"
    head = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2)
            + attr("channels", "chlist", chlist)
            + attr("compression", "compression", bytes([comp]))
            + attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
            + attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
            + attr("lineOrder", "lineOrder", b"\0")
            + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
            + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + b"\0")
    lines = 16 if comp == 3 else 1
    chunks = []
    for y in range(0, h, lines):
        raw = b"".join(
            chans[n][0][r].astype(np.float16 if chans[n][1] == 1
                                  else np.float32).tobytes()
            for r in range(y, min(h, y + lines)) for n in names)
        if comp == 3:
            b = np.frombuffer(raw, np.uint8)
            t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
            d = np.empty_like(t)
            d[0] = t[0]
            d[1:] = (t[1:] - t[:-1] + 128) % 256
            raw = zlib.compress(d.astype(np.uint8).tobytes())
        chunks.append(struct.pack("<ii", y, len(raw)) + raw)
    ofs = len(head) + 8 * len(chunks)
    table = b""
    for c in chunks:
        table += struct.pack("<Q", ofs)
        ofs += len(c)
    return head + table + b"".join(chunks)


@pytest.mark.parametrize("comp", [0, 3], ids=["NONE", "ZIP"])
def test_exr_matches_the_reference(tmp_path, comp):
    rng = np.random.default_rng(12)
    h, w = 20, 9
    planes = {c: rng.uniform(0, 6, (h, w)).astype(np.float32) for c in "RGB"}
    chans = {"R": (planes["R"], 1), "G": (planes["G"], 2),
             "B": (planes["B"], 1), "A": (np.ones((h, w), np.float32), 1)}
    p = tmp_path / "t.exr"
    p.write_bytes(_exr_bytes(chans, comp))
    got = image_io.load_image_hdr(p)
    want = ref_io.load_image_hdr(p)
    np.testing.assert_array_equal(got, want)
    for i, c in enumerate("RGB"):
        tol = 0 if c == "G" else 4e-3
        np.testing.assert_allclose(got[..., i], planes[c], rtol=tol)


def test_stage_timers_and_convars():
    telemetry.record(True)
    try:
        with telemetry.span("x", new_call=True) as x:
            with telemetry.span("x.y", texture=3):
                pass
    finally:
        telemetry.record(False)
    spans, _ = telemetry.drain()
    assert [s.name for s in spans] == ["x.y", "x"]
    assert spans[0].parent is x and spans[0].call == x.call
    assert spans[0].texture == 3 and x.texture is None
    assert x.start <= spans[0].start <= spans[0].end <= x.end
    reg = telemetry.ConvarRegistry()
    reg.register("k", 1.5, 1.0, 4.0)
    assert reg.set("k", 2.0) and reg.get("k") == 2.0
    assert not reg.set("nope", 1)
    reg.set("k", 99.0)
    assert reg.get("k") == 4.0                          # clamped
    assert [c.name for c in telemetry.CONVARS.list()] == [
        "etc1s_endpoint_rdo_thresh", "etc1s_selector_rdo_thresh",
        "uastc_ls_iters"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    telemetry.start_device_trace(tmp_path / "trace", device="cpu")
    with pytest.raises(RuntimeError, match="already running"):
        telemetry.start_device_trace(tmp_path / "other", device="cpu")
    x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    (x @ x).sum()
    prof = telemetry.stop_device_trace()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with pytest.raises(RuntimeError, match="no device trace"):
        telemetry.stop_device_trace()


def test_device_trace_on_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        telemetry.start_device_trace(tmp_path, device="cuda")
    with pytest.raises(RuntimeError, match="no device trace"):
        telemetry.stop_device_trace()
