"""The port stands on its own: it imports, encodes and transcodes with the
reference package, jax, Pillow and zstandard unavailable (the GPU machine
has none of the last three): ETC1S, UASTC, and every other mode as far as
it needs no Zstandard stream; with only jax, Pillow and the reference
blocked, every mode. A CUDA request on a machine without CUDA raises
instead of running on the CPU, and the port's `compress` accepts every
texture format the reference's accepts."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.codecs.astc import xuastc_encode
from basis_universal_tpu_torch.codecs.bc7 import encode as bc7_encode
from basis_universal_tpu_torch.codecs.etc1s import frontend
from basis_universal_tpu_torch.ops import _build
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import sys
BLOCKED = ("basis_universal_tpu", "jax", "jaxlib", "PIL", "zstandard")
for name in BLOCKED:
    sys.modules[name] = None          # any import of these raises ImportError
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch import transcoder
from basis_universal_tpu_torch.testing.checks import etc1s_psnr, uastc_psnr
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu_torch.formats.constants import BasisTexFormat
from basis_universal_tpu_torch.formats.constants import \
    TranscoderTextureFormat as TF
img, _ = synthetic_texture(64, 64, seed=2, alpha=True)
out = compressor.compress(img, compressor.CompressorParams(device="cpu"))
p = etc1s_psnr(out.basis_data, img)
assert p > 20.0, p
assert len(out.ktx2_data) > 0
uastc = compressor.compress(img, compressor.CompressorParams(
    tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2, device="cpu"))
assert uastc_psnr(uastc.basis_data, img) > 25.0
etc1 = transcoder.BasisTranscoder(uastc.basis_data, device="cpu")
assert etc1.transcode_image_level(0, 0, TF.ETC1_RGB).shape == (16, 16, 8)
rgba = transcoder.BasisTranscoder(out.basis_data, device="cpu")
assert rgba.transcode_image_level(0, 0, TF.RGBA32).shape == (64, 64, 4)
# the modes that write no Zstandard stream: ASTC LDR (through the UASTC
# search at 4x4, host code at 6x6), FullArith XUASTC, the HDR modes
import numpy as np
F = BasisTexFormat
hdr = np.random.default_rng(0).uniform(0, 4, (24, 20, 3)).astype(np.float32)
for fmt, src, kw in ((F.ASTC_LDR_4x4, img, {}), (F.ASTC_LDR_6x6, img, {}),
                     (F.XUASTC_LDR_4x4, img, dict(xuastc_syntax="arith")),
                     (F.XUASTC_LDR_6x6, img, dict(xuastc_syntax="arith")),
                     (F.ASTC_HDR_6x6, hdr, {}), (F.UASTC_HDR_4x4, hdr, {}),
                     (F.UASTC_HDR_6x6_INTERMEDIATE, hdr, {})):
    o = compressor.compress(src, compressor.CompressorParams(
        tex_format=fmt, effort=1, device="cpu", **kw))
    t = transcoder.BasisTranscoder(o.basis_data, device="cpu")
    px = t.transcode_image_level(0, 0, TF.RGBA_HALF if src is hdr
                                 else TF.RGBA32)
    assert px.shape[:2] == src.shape[:2], fmt
    assert len(o.ktx2_data) > 0             # uncompressed levels without zstd
# the BC7 search needs nothing blocked; its XUBC7 stream needs zstandard
from basis_universal_tpu_torch.codecs.bc7 import encode as bc7_encode
from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch.ops.gpu_unpack import unpack_bc7
px = image_to_blocks(img).reshape(-1, 16, 4)
bc7 = bc7_encode.encode_blocks(px, effort=2, device="cpu")
err = unpack_bc7(bc7).astype(np.float64) - px
assert 10 * np.log10(255 ** 2 / np.mean(err ** 2)) > 30.0
for fmt, kw in ((F.XUBC7, {}), (F.XUASTC_LDR_6x6, {})):
    try:
        compressor.compress(img, compressor.CompressorParams(
            tex_format=fmt, effort=1, device="cpu", **kw))
    except ImportError:
        pass
    else:
        raise AssertionError(f"{fmt} encoded without zstandard")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
assert not loaded, loaded
print("ok", round(p, 3))
"""


_ZSTD_RUN = r"""
import sys
BLOCKED = ("basis_universal_tpu", "jax", "jaxlib", "PIL")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
from basis_universal_tpu_torch import compressor, transcoder
from basis_universal_tpu_torch.formats.constants import BasisTexFormat as F
from basis_universal_tpu_torch.formats.constants import \
    TranscoderTextureFormat as TF
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
img, _ = synthetic_texture(40, 32, seed=2, alpha=True)
for fmt, kw in ((F.XUBC7, dict(quality_level=100)),
                (F.XUBC7, dict(quality_level=50)),
                (F.XUASTC_LDR_4x4, dict(quality_level=75)),
                (F.XUASTC_LDR_6x6, dict(xuastc_syntax="hybrid")),
                (F.ASTC_LDR_12x12, {})):
    o = compressor.compress(img, compressor.CompressorParams(
        tex_format=fmt, effort=1, device="cpu", **kw))
    for t, at in ((transcoder.BasisTranscoder(o.basis_data, device="cpu"),
                   (0, 0)),
                  (transcoder.Ktx2Transcoder(o.ktx2_data, device="cpu"),
                   (0, 0, 0))):
        assert t.transcode_image_level(*at, TF.RGBA32).shape == (40, 32, 4)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


_INSTALLED_RUN = r"""
import importlib.util, os, sys
assert importlib.util.find_spec("jax") is not None   # installed, not loaded
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.testing.checks import etc1s_psnr
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
img, _ = synthetic_texture(64, 64, seed=3)
out = compressor.compress(img, compressor.CompressorParams(device="cpu"))
assert etc1s_psnr(out.basis_data, img) > 20.0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "basis_universal_tpu"))
assert not loaded, loaded
assert "BASISU_TPU_DISABLE_COMPILE_CACHE" not in os.environ
print("ok")
"""


_FRONT_DOORS_RUN = r"""
import pathlib, sys, tempfile
BLOCKED = ("basis_universal_tpu", "jax", "jaxlib", "PIL", "zstandard")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
from basis_universal_tpu_torch import api, cli
from basis_universal_tpu_torch.formats.constants import BasisTexFormat as F
from basis_universal_tpu_torch.parallel import mesh
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu_torch.utils import image_io, telemetry
img, _ = synthetic_texture(32, 48, seed=5, alpha=True)
enc, tr = api.Encoder(device="cpu"), api.Transcoder(device="cpu")
for fmt in (F.ETC1S, F.UASTC_LDR_4x4):
    data = enc.compress(img, fmt, 100, 1, api.BasisFlags.SRGB)
    assert tr.decode_rgba(data).shape == (32, 48, 4), fmt
d = pathlib.Path(tempfile.mkdtemp())
image_io.write_dds(d / "t.dds", np.ascontiguousarray(img).tobytes(), 48, 32,
                   "RGBA8")
assert cli.main([str(d / "t.dds"), "-basis", "-device", "cpu",
                 "-output_path", str(d)]) == 0
assert cli.main([str(d / "t.basis"), "-info", "-device", "cpu"]) == 0
telemetry.start_device_trace(str(d / "trace"), device="cpu")
enc.compress(img, F.ETC1S, 50, 1, api.BasisFlags.SRGB)
telemetry.stop_device_trace()
assert (d / "trace" / "trace.json").exists()
assert mesh.texture_batch_mesh(["cpu", "cpu"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


# the searches are thousands of small operators: one intra-op thread keeps
# a child process from fighting the test workers for cores
_ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


def test_port_imports_and_encodes_without_jax_pil_zstandard():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                         env=_ONE_THREAD, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_front_doors_run_without_jax_pil_zstandard():
    """The API, the CLI on a .dds file (no Pillow), the telemetry's trace
    and the mesh helpers, with jax, Pillow, zstandard and the reference
    package unavailable."""
    res = subprocess.run([sys.executable, "-c", _FRONT_DOORS_RUN], cwd=REPO,
                         env=_ONE_THREAD, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines()[-1] == "ok"


def test_front_doors_without_cuda_raise(monkeypatch, tmp_path):
    """The API, the CLI without -device cpu, the codec sweep and the mesh
    default to the card, and raise where there is none."""
    from basis_universal_tpu_torch import api, cli
    from basis_universal_tpu_torch.parallel import mesh
    from basis_universal_tpu_torch.utils import image_io

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, _ = synthetic_texture(16, 16, seed=1, alpha=True)
    dds = tmp_path / "t.dds"
    image_io.write_dds(dds, np.ascontiguousarray(img).tobytes(), 16, 16,
                       "RGBA8")
    for run in (api.Encoder, api.Transcoder, mesh.texture_batch_mesh,
                lambda: cli.main([str(dds), "-output_path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_every_mode_encodes_without_jax_pil_and_the_reference():
    pytest.importorskip("zstandard")
    res = subprocess.run([sys.executable, "-c", _ZSTD_RUN], cwd=REPO,
                         env=_ONE_THREAD, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_port_does_not_load_an_installed_jax():
    """Where jax and the reference package are installed, importing and
    running the port loads neither, and leaves the environment as it found
    it."""
    env = {k: v for k, v in os.environ.items()
           if k != "BASISU_TPU_DISABLE_COMPILE_CACHE"}
    res = subprocess.run([sys.executable, "-c", _INSTALLED_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, _ = synthetic_texture(16, 16, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compressor.compress(img, compressor.CompressorParams(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compressor.compress_batch([img, img],
                                  compressor.CompressorParams(device="cuda"))
    blocks = np.zeros((4, 16, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frontend.compress_with_global_codebooks(
            blocks, np.zeros((1, 3)), np.zeros(1), np.zeros((1, 16)),
            device="cuda")
    # every mode with a device search: a `params.device` left at its default
    for fmt in (BasisTexFormat.XUBC7, BasisTexFormat.ASTC_LDR_4x4,
                BasisTexFormat.XUASTC_LDR_4x4):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            compressor.compress(img, compressor.CompressorParams(
                tex_format=fmt, xuastc_syntax="arith"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bc7_encode.encode_blocks(np.zeros((4, 16, 4), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xuastc_encode.encode_image(np.zeros((8, 8, 4), np.uint8), 4, 4,
                                   has_alpha=False, srgb=True, syntax="arith")


def test_cuda_is_the_default_device():
    assert compressor.CompressorParams().device == "cuda"
    assert frontend.FrontendParams().device == "cuda"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library_path()


def _outcome(compress, params, img):
    try:
        out = compress(img, params)
    except Exception as exc:                # noqa: BLE001 (compared below)
        return type(exc).__name__, str(exc)
    return "ok", (len(out.basis_data) > 0, len(out.ktx2_data) > 0)


@pytest.mark.parametrize("fmt", list(BasisTexFormat), ids=lambda f: f.name)
def test_every_format_the_reference_accepts_is_accepted(fmt):
    """Each texture format goes through both `compress`: the port returns a
    CompressorOutput wherever the reference does (and fails as the reference
    fails on the one footprint, 8x6, whose shared host encoder finds no
    endpoint range)."""
    from basis_universal_tpu import compressor as ref_compressor

    if "HDR" in fmt.name:
        img = np.random.default_rng(1).uniform(0, 4, (12, 12, 3)).astype(
            np.float32)
    else:
        img, _ = synthetic_texture(24, 24, seed=0)
    kw = dict(tex_format=fmt, effort=0)
    theirs = _outcome(ref_compressor.compress,
                      ref_compressor.CompressorParams(**kw), img)
    mine = _outcome(compressor.compress,
                    compressor.CompressorParams(device="cpu", **kw), img)
    assert mine == theirs
    if fmt.name not in ("ASTC_LDR_8x6", "XUASTC_LDR_8x6"):
        assert mine[0] == "ok"


def test_compress_batch_takes_the_two_formats_of_the_reference():
    img, _ = synthetic_texture(8, 8, seed=0)
    with pytest.raises(ValueError, match="compress_batch"):
        compressor.compress_batch([img], compressor.CompressorParams(
            tex_format=BasisTexFormat.XUBC7, device="cpu"))
