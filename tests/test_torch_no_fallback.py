"""The port stands on its own: it imports, encodes (ETC1S and UASTC) and
transcodes with jax, Pillow and zstandard unavailable (as on the GPU
machine), a CUDA request on a machine without CUDA raises instead of running
on the CPU, and texture formats not ported yet raise NotImplementedError."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.codecs.etc1s import frontend
from basis_universal_tpu_torch.ops import _build
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "PIL", "zstandard"):
    sys.modules[name] = None          # any import of these raises ImportError
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch import transcoder
from basis_universal_tpu_torch.testing.checks import etc1s_psnr, uastc_psnr
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu.formats.constants import TranscoderTextureFormat as TF
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
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "PIL", "zstandard")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok", round(p, 3))
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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
assert "BASISU_TPU_DISABLE_COMPILE_CACHE" not in os.environ
print("ok")
"""


def test_port_imports_and_encodes_without_jax_pil_zstandard():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_port_does_not_load_an_installed_jax():
    """Where jax is installed, importing and running the port (which imports
    the reference package's jax-free modules) still loads none of it, and
    leaves the environment as it found it."""
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


@pytest.mark.parametrize("fmt", [BasisTexFormat.ASTC_HDR_6x6,
                                 BasisTexFormat.XUBC7,
                                 BasisTexFormat.UASTC_HDR_4x4])
def test_formats_not_ported_raise(fmt):
    img, _ = synthetic_texture(8, 8, seed=0)
    params = compressor.CompressorParams(tex_format=fmt, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        compressor.compress(img, params)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        compressor.compress_batch([img], params)
