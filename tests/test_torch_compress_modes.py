"""The port's `compressor.compress(..., device="cpu")` against the
reference's for the modes beyond ETC1S and UASTC LDR 4x4: XUBC7 (lossless,
lossy, with its RDO), ASTC LDR 4x4 / 6x6 / 12x12, XUASTC LDR 4x4 / 6x6 in
its three entropy syntaxes, ASTC HDR 6x6, UASTC HDR 4x4 and the UASTC HDR
6x6 intermediate format, on a 64x64 RGB texture and a 50x38 RGBA one, with
and without mipmaps.

Bounds: the `.basis` and `.KTX2` bytes are the reference's in every mode,
those whose blocks come from the UASTC search (ASTC LDR 4x4, XUASTC LDR
4x4) included. The reference transcoder decodes every file of the port to
the pixels the port's transcoder gives.
"""

import numpy as np
import pytest
import torch

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu import transcoder as ref_transcoder
from basis_universal_tpu.formats.constants import BasisTexFormat as F
from basis_universal_tpu.formats.constants import TranscoderTextureFormat as TF
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch import transcoder
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

HDR = {F.ASTC_HDR_6x6, F.UASTC_HDR_4x4, F.UASTC_HDR_6x6_INTERMEDIATE}


@pytest.fixture(autouse=True)
def _one_thread():
    """The BC7 and UASTC searches are thousands of small operators: with one
    intra-op thread they run as fast as with many, and do not fight the
    other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(kind: str):
    if kind == "rgb64":
        return synthetic_texture(64, 64, seed=11)[0]
    if kind == "rgba50x38":
        return synthetic_texture(50, 38, seed=12, alpha=True)[0]
    rng = np.random.default_rng(13)                     # "hdr50x38"
    base = synthetic_texture(50, 38, seed=13)[0].astype(np.float32) / 255.0
    return (base ** 2.2 * 6.0 + rng.uniform(0, 0.05, base.shape)
            ).astype(np.float32)


def _levels(mod, data: bytes, fmt, **kw):
    """Every level of image 0 of a .basis file, decoded by `mod`."""
    tc = mod.BasisTranscoder(data, **kw)
    return [np.asarray(tc.transcode_image_level(0, lv, fmt))
            for lv in range(tc.get_total_image_levels(0))]


def _run(fmt, kind, **kw):
    img = _image(kind)
    mine = compressor.compress(img, compressor.CompressorParams(
        tex_format=fmt, device="cpu", **kw))
    theirs = ref_compressor.compress(img, ref_compressor.CompressorParams(
        tex_format=fmt, **kw))
    target = TF.RGBA_HALF if fmt in HDR else TF.RGBA32
    mine_px = _levels(transcoder, mine.basis_data, target, device="cpu")
    # the reference transcoder reads the port's file to the same pixels
    for a, b in zip(mine_px, _levels(ref_transcoder, mine.basis_data, target)):
        np.testing.assert_array_equal(a, b)
    kt, rkt = (transcoder.Ktx2Transcoder(mine.ktx2_data, device="cpu"),
               ref_transcoder.Ktx2Transcoder(mine.ktx2_data))
    assert kt.get_levels() == rkt.get_levels() == len(mine_px)
    # (a .basis of a 10x8 or larger footprint is deblocked on decode by
    # default, a KTX2 only where its key asks for it: each container is
    # held against the same container read by the reference)
    kt_px = np.asarray(kt.transcode_image_level(0, 0, 0, target))
    np.testing.assert_array_equal(
        np.asarray(rkt.transcode_image_level(0, 0, 0, target)), kt_px)
    assert mine_px[0].shape[:2] == kt_px.shape[:2] == img.shape[:2]

    assert mine.basis_data == theirs.basis_data
    assert mine.ktx2_data == theirs.ktx2_data


@pytest.mark.parametrize("kind,kw", [
    ("rgb64", dict(quality_level=100, effort=1)),
    ("rgba50x38", dict(quality_level=100, effort=1, mip_gen=True)),
    ("rgba50x38", dict(quality_level=100, effort=2)),
    ("rgb64", dict(quality_level=50, effort=1)),
    ("rgba50x38", dict(quality_level=50, effort=1)),
    ("rgba50x38", dict(quality_level=100, effort=1, xubc7_rdo_level=50)),
    ("rgb64", dict(quality_level=100, effort=0)),
], ids=["lossless-rgb", "lossless-rgba-mips", "lossless-rgba-effort2",
        "q50-rgb", "q50-rgba", "rdo-rgba", "effort0-rgb"])
def test_xubc7(kind, kw):
    pytest.importorskip("zstandard")
    _run(F.XUBC7, kind, **kw)


@pytest.mark.parametrize("fmt,kind,kw", [
    (F.ASTC_LDR_4x4, "rgb64", dict(effort=1)),
    (F.ASTC_LDR_4x4, "rgba50x38", dict(effort=1, mip_gen=True)),
    (F.ASTC_LDR_6x6, "rgb64", dict(effort=1)),
    (F.ASTC_LDR_6x6, "rgba50x38", dict(effort=1, mip_gen=True)),
    (F.ASTC_LDR_12x12, "rgba50x38", dict(effort=1)),
    (F.ASTC_LDR_12x12, "rgb64", dict(effort=2, perceptual=False)),
], ids=["4x4-rgb", "4x4-rgba-mips", "6x6-rgb", "6x6-rgba-mips", "12x12-rgba",
        "12x12-rgb-linear"])
def test_astc_ldr(fmt, kind, kw):
    _run(fmt, kind, **kw)


@pytest.mark.parametrize("syntax", ["full_zstd", "hybrid", "arith"])
@pytest.mark.parametrize("fmt,kind,kw", [
    (F.XUASTC_LDR_4x4, "rgb64", dict(quality_level=75, effort=1)),
    (F.XUASTC_LDR_6x6, "rgba50x38", dict(quality_level=75, effort=1)),
    (F.XUASTC_LDR_6x6, "rgb64", dict(quality_level=100, effort=1,
                                     mip_gen=True)),
], ids=["4x4-q75-rgb", "6x6-q75-rgba", "6x6-lossless-rgb-mips"])
def test_xuastc_ldr(fmt, kind, kw, syntax):
    pytest.importorskip("zstandard")
    _run(fmt, kind, xuastc_syntax=syntax, **kw)


@pytest.mark.parametrize("fmt,kw", [
    (F.ASTC_HDR_6x6, dict(effort=1)),
    (F.ASTC_HDR_6x6, dict(effort=1, mip_gen=True)),
    (F.UASTC_HDR_4x4, dict(effort=1)),
    (F.UASTC_HDR_4x4, dict(effort=1, mip_gen=True)),
    (F.UASTC_HDR_6x6_INTERMEDIATE, dict(effort=1)),
], ids=["astc-hdr-6x6", "astc-hdr-6x6-mips", "uastc-hdr-4x4",
        "uastc-hdr-4x4-mips", "uastc-hdr-6x6i"])
def test_hdr(fmt, kw):
    _run(fmt, "hdr50x38", **kw)


def test_arith_syntax_needs_no_zstandard(monkeypatch):
    """The FullArith XUASTC syntax and the `.basis` container use no
    Zstandard: with the package unavailable they still encode, to the bytes
    they give with it; the syntaxes that need it raise ImportError."""
    import sys

    img = _image("rgb64")
    params = compressor.CompressorParams(
        tex_format=F.XUASTC_LDR_6x6, quality_level=75, effort=1,
        xuastc_syntax="arith", device="cpu")
    with_zstd = compressor.compress(img, params)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    assert compressor.compress(img, params).basis_data == with_zstd.basis_data
    params.xuastc_syntax = "full_zstd"
    with pytest.raises(ImportError):
        compressor.compress(img, params)
