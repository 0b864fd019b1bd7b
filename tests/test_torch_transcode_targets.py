"""The port's own transcoder against the reference's, target by target, on
the CPU.

For every `TranscoderTextureFormat`, files of four kinds are transcoded by
both packages from .basis and from .KTX2:

- an ETC1S and a UASTC LDR 4x4 file, 64x64 RGBA, made by the port;
- an XUBC7 and an ASTC LDR 4x4 file, 32x32 RGB, made by the reference
  encoder (their engines decode to pixels and reach the UASTC engine's
  conversions, the port's since it has its own transcoder).

Where the reference raises, the port raises the same error. Otherwise the
port gives the reference's bytes, except where it re-encodes decoded pixels
on its own device: the ETC1 target (and the colour half of ETC2_RGBA) of
every file but ETC1S, and the ASTC 4x4 target of the pixel-decoded files.
Those are held as `test_torch_transcoder.py` holds them: an ETC1 block may
differ only where both encodings decode to the same squared error (a tie),
and at least 99% of the ASTC blocks are identical.
"""

import numpy as np
import pytest

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu import transcoder as ref
from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu.formats.constants import TranscoderTextureFormat as TF
from basis_universal_tpu.ops.etc1 import image_to_blocks, unpack_etc1_blocks
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch import transcoder as port
from basis_universal_tpu_torch.ops import etc1s_encode
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

# codec -> how its files are made (by the port, or by the reference encoder)
KINDS = ("etc1s", "uastc", "xubc7", "astc_ldr")
_REF_FORMATS = {"xubc7": BasisTexFormat.XUBC7,
                "astc_ldr": BasisTexFormat.ASTC_LDR_4x4}
# the targets each kind re-encodes from decoded pixels on the port's device
REENCODED = {"etc1s": (),
             "uastc": (TF.ETC1_RGB, TF.ETC2_RGBA),
             "xubc7": (TF.ETC1_RGB, TF.ETC2_RGBA, TF.ASTC_4x4_RGBA),
             "astc_ldr": (TF.ETC1_RGB, TF.ETC2_RGBA)}


@pytest.fixture(scope="module")
def files():
    rgba, _ = synthetic_texture(64, 64, seed=80, alpha=True)
    rgb, _ = synthetic_texture(32, 32, seed=81)
    out = {
        "etc1s": compressor.compress(rgba, compressor.CompressorParams(
            device="cpu")),
        "uastc": compressor.compress(rgba, compressor.CompressorParams(
            tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2, device="cpu")),
    }
    for kind, fmt in _REF_FORMATS.items():
        out[kind] = ref_compressor.compress(
            rgb, ref_compressor.CompressorParams(tex_format=fmt))
    return out


def _open(out, container):
    if container == "basis":
        return (port.BasisTranscoder(out.basis_data, device="cpu"),
                ref.BasisTranscoder(out.basis_data), (0, 0))
    return (port.Ktx2Transcoder(out.ktx2_data, device="cpu"),
            ref.Ktx2Transcoder(out.ktx2_data), (0, 0, 0))


def _etc1_sse(etc1, px):
    """(N,) squared error of (N, 8) ETC1 blocks against (N, 16, 3) pixels."""
    rgb = unpack_etc1_blocks(etc1.reshape(1, -1, 8))[0, ..., :3]
    return ((rgb.reshape(-1, 16, 3).astype(np.float64) - px) ** 2).sum((1, 2))


def _hold_etc1(got, want, px):
    got, want = got.reshape(-1, 8), want.reshape(-1, 8)
    differ = (got != want).any(1)
    np.testing.assert_array_equal(_etc1_sse(got[differ], px[differ]),
                                  _etc1_sse(want[differ], px[differ]))


@pytest.mark.parametrize("fmt", list(TF), ids=lambda f: f.name)
@pytest.mark.parametrize("container", ["basis", "ktx2"])
@pytest.mark.parametrize("kind", KINDS)
def test_transcode_target_matches_reference(kind, container, fmt, files,
                                            monkeypatch):
    tc, tc_ref, where = _open(files[kind], container)
    try:
        want = tc_ref.transcode_image_level(*where, fmt)
    except Exception as e:       # not supported for this file: same error
        with pytest.raises(Exception) as got_err:
            tc.transcode_image_level(*where, fmt)
        assert type(got_err.value).__name__ == type(e).__name__
        return
    calls = []
    encode_blocks = etc1s_encode.encode_blocks

    def counted(*args, **kwargs):
        calls.append(1)
        return encode_blocks(*args, **kwargs)

    monkeypatch.setattr(etc1s_encode, "encode_blocks", counted)
    got = tc.transcode_image_level(*where, fmt)
    assert got.dtype == want.dtype and got.shape == want.shape
    if fmt not in REENCODED[kind]:
        np.testing.assert_array_equal(got, want)
        assert not calls
        return
    if fmt == TF.ASTC_4x4_RGBA:
        same = (got == want).all(-1).mean()
        assert same >= 0.99, same
        return
    # the ETC1 colour blocks come from the port's ETC1S re-encode
    assert calls == [1]
    if fmt == TF.ETC2_RGBA:
        np.testing.assert_array_equal(got[..., :8], want[..., :8])
        got, want = got[..., 8:], want[..., 8:]
    img = tc_ref.transcode_image_level(*where, TF.RGBA32)
    px = image_to_blocks(img[..., :3]).reshape(-1, 16, 3).astype(np.float64)
    _hold_etc1(got, want, px)


@pytest.mark.parametrize("kind", ["xubc7", "astc_ldr"])
def test_pixel_decoded_engines_reencode_on_the_port(kind, files, monkeypatch):
    """The XUBC7 and ASTC LDR engines hand their decoded pixels to the port's
    UASTC engine, on the transcoder's device."""
    tc = port.BasisTranscoder(files[kind].basis_data, device="cpu")
    tc.start_transcoding()
    seen = []
    convert_rgba = port.UastcTranscodeEngine.convert_rgba

    def spy(self, *a, **k):
        seen.append(self.device.type)
        return convert_rgba(self, *a, **k)

    monkeypatch.setattr(port.UastcTranscodeEngine, "convert_rgba", spy)
    tc.transcode_image_level(0, 0, TF.ETC1_RGB)
    assert seen == ["cpu"]
    assert tc._engine.device.type == "cpu"


def test_dds_transcoder_reencodes_on_the_port():
    """A DDS file's ETC1 target is the port's re-encode on its device."""
    from basis_universal_tpu_torch.formats import dds

    img, _ = synthetic_texture(16, 16, seed=82)
    data = _rgba8_dds(np.concatenate(
        [img, np.full((16, 16, 1), 255, np.uint8)], -1))
    assert dds.DdsFile(data).format == "RGBA8"
    got = port.DdsTranscoder(data, device="cpu").transcode_image_level(
        0, 0, 0, TF.ETC1_RGB)
    want = ref.DdsTranscoder(data).transcode_image_level(0, 0, 0, TF.ETC1_RGB)
    px = image_to_blocks(img).reshape(-1, 16, 3).astype(np.float64)
    _hold_etc1(got, want, px)


def _rgba8_dds(rgba):
    """An uncompressed 32-bit RGBA .dds (legacy header) of an (H, W, 4)
    image."""
    import struct

    h, w = rgba.shape[:2]
    pf = struct.pack("<II4sIIIII", 32, 0x41, b"\0\0\0\0", 32,
                     0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000)
    hdr = struct.pack("<IIIIIII44s", 124, 0x100F, h, w, w * 4, 0, 1,
                      b"\0" * 44) + pf + struct.pack("<IIIII", 0x1000, 0, 0,
                                                     0, 0)
    return b"DDS " + hdr + rgba.tobytes()
