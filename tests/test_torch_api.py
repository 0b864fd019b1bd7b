"""The port's user-facing API (`basis_universal_tpu_torch/api.py`) against
the reference's `api`, on the CPU: `Encoder(device="cpu").compress` gives
the reference's bytes, format by format, and `Transcoder(device="cpu")`
answers every introspection call as the reference's does and decodes and
transcodes to the same arrays.

Inputs are synthetic textures made from a seed (`testing/synthetic.py`) and
a seeded float32 HDR image. Tolerance: none, bytes and arrays are equal.
"""

import numpy as np
import pytest
import torch

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu import api as ref_api
from basis_universal_tpu_torch import api
from basis_universal_tpu_torch.formats.constants import (
    BasisTexFormat as F, TranscoderTextureFormat as TF)
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

KTX2 = api.BasisFlags.KTX2_OUTPUT | api.BasisFlags.SRGB


@pytest.fixture(autouse=True)
def _one_thread():
    """The searches are thousands of small operators: with one intra-op
    thread they run as fast as with many, and do not fight the other test
    workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ldr():
    return synthetic_texture(48, 64, seed=71, alpha=True)[0]


def _hdr():
    return np.random.default_rng(72).uniform(0, 4, (24, 20, 3)).astype(
        np.float32)


# (id, format, quality, effort, flags, image)
CASES = [
    ("etc1s-q50-basis", F.ETC1S, 50, 1, api.BasisFlags.SRGB, _ldr),
    ("uastc", F.UASTC_LDR_4x4, 100, 2, KTX2, _ldr),
    ("uastc-rdo", F.UASTC_LDR_4x4, 90, 1, api.BasisFlags.SRGB, _ldr),
    ("xubc7", F.XUBC7, 100, 1, KTX2, _ldr),
    ("astc-4x4", F.ASTC_LDR_4x4, 100, 2, KTX2, _ldr),
    ("astc-6x6", F.ASTC_LDR_6x6, 100, 1, KTX2, _ldr),
    ("xuastc-6x6", F.XUASTC_LDR_6x6, 75, 1, KTX2, _ldr),
    ("uastc-hdr-4x4", F.UASTC_HDR_4x4, 100, 1, KTX2, _hdr),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_encoder_gives_the_reference_bytes(case):
    _, fmt, quality, effort, flags, make = case
    img = make()
    got = api.Encoder(device="cpu").compress(img, fmt, quality, effort, flags)
    want = ref_api.Encoder().compress(img, fmt, quality, effort, flags)
    assert len(got) == len(want)
    assert got == want


def test_etc1s_effort_2_within_the_frontends_tolerance():
    """ETC1S at effort 2 (two refine passes) on this texture: the
    reference's bytes. The reference shortlists each block's codebook
    entries with `approx_min_k`, which on the CPU is an unstable sort, and
    orders equal distances in its `std::sort`'s own way; the port orders
    them the same way (`etc1s_encode._refine_shortlist`), where a stable
    sort had rescored other entries and this file differed."""
    from basis_universal_tpu_torch.testing.checks import etc1s_psnr

    img = _ldr()
    got = api.Encoder(device="cpu").compress(img, F.ETC1S, 80, 2,
                                             api.BasisFlags.SRGB)
    want = ref_api.Encoder().compress(img, F.ETC1S, 80, 2,
                                      api.BasisFlags.SRGB)
    dp = etc1s_psnr(got, img) - etc1s_psnr(want, img)
    print(f"ETC1S q80 e2: bytes equal {got == want}, PSNR {dp:+.4f} dB, "
          f"{len(got)} vs {len(want)} B")
    assert got == want


def test_encoder_auto_format_and_names():
    enc = api.Encoder(device="cpu")
    assert enc.backend_name == "PyTorch" and enc.device == "cpu"
    ktx2 = enc.compress(_ldr()[:16, :24], quality=100, effort=0)
    tr = api.Transcoder(device="cpu")
    assert tr.backend_name == "PyTorch"
    assert tr.get_basis_tex_format(tr.open(ktx2)) == F.XUASTC_LDR_6x6
    with pytest.raises(ValueError, match="float32"):
        enc.compress(_ldr(), F.UASTC_HDR_4x4)
    with pytest.raises(TypeError):
        enc.compress([[0]])


INTROSPECTION = ("get_width", "get_height", "get_levels", "get_layers",
                 "get_faces", "get_basis_tex_format", "is_etc1s", "is_srgb",
                 "get_key_values")


@pytest.mark.parametrize("fmt,flags", [
    (F.ETC1S, api.BasisFlags.SRGB), (F.ETC1S, KTX2),
    (F.UASTC_LDR_4x4, KTX2 | api.BasisFlags.GEN_MIPS_CLAMP),
    (F.UASTC_LDR_4x4, api.BasisFlags.NONE)],
    ids=["etc1s-basis", "etc1s-ktx2", "uastc-ktx2-mips", "uastc-basis"])
def test_transcoder_agrees_with_the_reference(fmt, flags):
    img = _ldr()
    data = ref_api.Encoder().compress(img, fmt, 60, 1, flags)
    tr, ref = api.Transcoder(device="cpu"), ref_api.Transcoder()
    h, rh = tr.open(data), ref.open(data)
    for name in INTROSPECTION:
        assert getattr(tr, name)(h) == getattr(ref, name)(rh), name
    for level in range(tr.get_levels(h)):
        np.testing.assert_array_equal(tr.decode_rgba(h, level=level),
                                      ref.decode_rgba(rh, level=level))
    for tfmt in (TF.ETC1_RGB, TF.BC7_RGBA, TF.ASTC_4x4_RGBA, TF.BC1_RGB):
        np.testing.assert_array_equal(
            np.asarray(tr.transcode_tfmt(data, tfmt)),
            np.asarray(ref.transcode_tfmt(data, tfmt)))
    tr.close(h)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Encoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Transcoder()
