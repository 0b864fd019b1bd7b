"""The port's transcoder fronts (`basis_universal_tpu_torch/transcoder.py`)
against the reference transcoder, on the CPU.

A UASTC LDR 4x4 file (64x64 RGBA, made by the port) is transcoded by both
to ETC1_RGB, ETC2_RGBA and ASTC_4x4_RGBA, from .basis and from .KTX2, and
the ASTC 4x4 re-encode of decoded pixels runs through both engines.

The ETC1 targets re-encode the decoded pixels with an ETC1S fit at radius
1. A block may differ only where both encodings decode to the same squared
error (an exact tie between two endpoints or selectors, ordered by the float
rounding of the unclipped scan scores); measured here: 3 of 256 blocks, all
such ties. The alpha half of ETC2 and the ASTC conversion of the stored
blocks are host code and equal. The ASTC re-encode must agree on at least
99% of the blocks (measured: 100%).
"""

import numpy as np
import pytest
import torch

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu import transcoder as ref
from basis_universal_tpu.codecs.uastc.decode import decode_rgba
from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu.formats.constants import TranscoderTextureFormat as TF
from basis_universal_tpu.ops.etc1 import unpack_etc1_blocks
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch import transcoder as port
from basis_universal_tpu_torch.ops import cuda_etc1s as ck
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture


@pytest.fixture(scope="module")
def uastc_file():
    img, _ = synthetic_texture(64, 64, seed=70, alpha=True)
    return compressor.compress(img, compressor.CompressorParams(
        tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2, device="cpu"))


def _open(out, container):
    if container == "basis":
        return (port.BasisTranscoder(out.basis_data, device="cpu"),
                ref.BasisTranscoder(out.basis_data), (0, 0))
    return (port.Ktx2Transcoder(out.ktx2_data, device="cpu"),
            ref.Ktx2Transcoder(out.ktx2_data), (0, 0, 0))


def _decoded_px(out):
    """(N, 16, 3) RGB pixels of the file's stored blocks."""
    blocks = np.frombuffer(out.basis_data[-256 * 16:], np.uint8).reshape(-1,
                                                                       16)
    return decode_rgba(blocks).reshape(-1, 16, 4)[..., :3].astype(np.float64)


def _etc1_sse(etc1, px):
    """(N,) squared error of (N, 8) ETC1 blocks against (N, 16, 3) pixels."""
    rgb = unpack_etc1_blocks(etc1.reshape(1, -1, 8))[0, ..., :3]
    return ((rgb.reshape(-1, 16, 3).astype(np.float64) - px) ** 2).sum((1, 2))


@pytest.mark.parametrize("container", ["basis", "ktx2"])
@pytest.mark.parametrize("fmt", [TF.ETC1_RGB, TF.ETC2_RGBA, TF.ASTC_4x4_RGBA])
def test_transcode_matches_reference(fmt, container, uastc_file):
    tc, tc_ref, where = _open(uastc_file, container)
    ck.reset_launch_counts()
    got = tc.transcode_image_level(*where, fmt)
    want = tc_ref.transcode_image_level(*where, fmt)
    assert isinstance(tc._engine, port.UastcTranscodeEngine)
    assert got.shape == want.shape == (16, 16, 8 if fmt == TF.ETC1_RGB else 16)
    if fmt == TF.ASTC_4x4_RGBA:
        np.testing.assert_array_equal(got, want)
        return
    if fmt == TF.ETC2_RGBA:
        np.testing.assert_array_equal(got[..., :8], want[..., :8])
        got, want = got[..., 8:], want[..., 8:]
    got, want = got.reshape(-1, 8), want.reshape(-1, 8)
    differ = (got != want).any(1)
    px = _decoded_px(uastc_file)[differ]
    np.testing.assert_array_equal(_etc1_sse(got[differ], px),
                                  _etc1_sse(want[differ], px))
    print(f"{fmt.name} from {container}: {int(differ.sum())} of {len(got)} "
          "blocks differ, all ties")
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)   # CPU: plain versions


def test_astc_reencode_matches_reference(uastc_file):
    """The engine's ASTC 4x4 re-encode of decoded pixels (the path other
    engines reach through `convert_rgba`) runs the port's UASTC encoder."""
    blocks = np.frombuffer(uastc_file.basis_data[-256 * 16:],
                           np.uint8).reshape(-1, 16)
    rgba = decode_rgba(blocks)
    got = port.UastcTranscodeEngine("cpu").convert_rgba(
        TF.ASTC_4x4_RGBA, rgba, 16, 16, 64, 64)
    want = ref.UastcTranscodeEngine().convert_rgba(
        TF.ASTC_4x4_RGBA, rgba, 16, 16, 64, 64)
    same = (got == want).all(-1).mean()
    print(f"ASTC 4x4 re-encode: {same:.4f} of the blocks identical")
    assert got.shape == want.shape == (16, 16, 16)
    assert same >= 0.99


def test_other_formats_keep_the_reference_engines(uastc_file):
    img, _ = synthetic_texture(32, 32, seed=71)
    etc1s = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    tc = port.BasisTranscoder(etc1s.basis_data, device="cpu")
    got = tc.transcode_image_level(0, 0, TF.RGBA32)
    np.testing.assert_array_equal(
        got, ref.BasisTranscoder(etc1s.basis_data).transcode_image_level(
            0, 0, TF.RGBA32))
    assert isinstance(tc._engine, ref.Etc1sTranscodeEngine)


def test_cuda_request_without_cuda_raises(uastc_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.BasisTranscoder(uastc_file.basis_data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.Ktx2Transcoder(uastc_file.ktx2_data)
