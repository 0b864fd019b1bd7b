"""The port's UASTC LDR 4x4 compressor (`compressor.compress` /
`compress_batch` with `tex_format=UASTC_LDR_4x4`) against the reference's,
on the CPU, on synthetic 64x64 RGB and RGBA textures at effort 2, with and
without the selector RDO.

Bounds: PSNR within 0.05 dB, the same .basis length (a UASTC slice is its
raw 16-byte blocks), at least 99% of the blocks byte-identical, and every
block that differs decodes to the same squared error. Measured here: 99.22%
to 100% of the blocks identical; the few that differ differ only in their
ETC1 hint bits (an exact tie between two intensity tables of the radius-0
ETC1S fit) and decode to the same pixels. Every file is decoded with all
CRCs checked.
"""

import numpy as np
import pytest

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu import transcoder as ref_transcoder
from basis_universal_tpu.codecs.uastc.decode import decode_rgba
from basis_universal_tpu.formats.basis_file import BasisFile
from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.testing.checks import (decode_uastc_basis,
                                                      uastc_psnr)
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

UASTC = BasisTexFormat.UASTC_LDR_4x4
PSNR_TOL_DB = 0.05
MIN_BLOCK_AGREEMENT = 0.99


def _blocks_of(data):
    f = BasisFile(data)
    return np.concatenate([np.frombuffer(f.slice_data(i), np.uint8)
                           for i in range(len(f.slices))]).reshape(-1, 16)


def _sse(blocks, px):
    dec = decode_rgba(blocks).reshape(-1, 64).astype(np.float64)
    return ((dec - px) ** 2).sum(1)


def _agree(port, ref, img):
    p_port, p_ref = uastc_psnr(port.basis_data, img), uastc_psnr(
        ref.basis_data, img)
    b_port, b_ref = _blocks_of(port.basis_data), _blocks_of(ref.basis_data)
    same = (b_port == b_ref).all(1)
    rgba = img if img.shape[-1] == 4 else np.concatenate(
        [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    px = image_to_blocks(rgba).reshape(-1, 64)[~same]
    np.testing.assert_array_equal(_sse(b_port[~same], px),
                                  _sse(b_ref[~same], px))
    print(f"PSNR port {p_port:.4f} ref {p_ref:.4f} dB; {len(port.basis_data)}"
          f" vs {len(ref.basis_data)} B; blocks identical {same.mean():.4f}")
    assert p_port > 20.0
    assert abs(p_port - p_ref) <= PSNR_TOL_DB
    assert len(port.basis_data) == len(ref.basis_data)
    assert same.mean() >= MIN_BLOCK_AGREEMENT


@pytest.mark.parametrize("rdo", [0.0, 1.0])
@pytest.mark.parametrize("alpha", [False, True])
def test_compress_matches_reference(alpha, rdo):
    img, _ = synthetic_texture(64, 64, seed=40 + alpha, alpha=alpha)
    kw = dict(tex_format=UASTC, effort=2, rdo_uastc_quality=rdo)
    port = compressor.compress(img, compressor.CompressorParams(
        device="cpu", **kw))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams(**kw))
    _agree(port, ref, img)
    assert len(port.ktx2_data) > 0


def test_compress_batch_matches_reference():
    """Mixed RGB / RGBA inputs: same-shaped slices are grouped by alpha."""
    imgs = [synthetic_texture(64, 64, seed=50 + i, alpha=i == 1)[0]
            for i in range(3)]
    outs = compressor.compress_batch(imgs, compressor.CompressorParams(
        tex_format=UASTC, effort=2, device="cpu"))
    assert len(outs) == 3
    for img, out in zip(imgs, outs):
        ref = ref_compressor.compress(img, ref_compressor.CompressorParams(
            tex_format=UASTC, effort=2))
        _agree(out, ref, img)


def test_mipmapped_file_decodes_with_the_reference_transcoder():
    img, _ = synthetic_texture(32, 48, seed=60, alpha=True)
    out = compressor.compress(img, compressor.CompressorParams(
        tex_format=UASTC, effort=1, mip_gen=True, device="cpu"))
    levels = decode_uastc_basis(out.basis_data)     # checks every CRC
    assert [lv.shape[:2] for lv in levels] == [(32, 48), (16, 24), (8, 12),
                                               (4, 6), (2, 3), (1, 1)]
    level0 = compressor.compress(img, compressor.CompressorParams(
        tex_format=UASTC, effort=1, device="cpu"))
    np.testing.assert_array_equal(levels[0], decode_uastc_basis(
        level0.basis_data)[0])
    tc = ref_transcoder.BasisTranscoder(out.basis_data)
    assert tc.get_total_image_levels(0) == 6
    rgba = tc.transcode_image_level(0, 0, ref_transcoder.TF.RGBA32)
    np.testing.assert_array_equal(rgba, levels[0])
    kt = ref_transcoder.Ktx2Transcoder(out.ktx2_data)
    assert kt.get_levels() == 6
    np.testing.assert_array_equal(
        kt.transcode_image_level(2, 0, 0, ref_transcoder.TF.RGBA32), levels[2])
