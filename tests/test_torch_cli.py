"""The port's command-line tool (`basis_universal_tpu_torch/cli.py`,
`python -m basis_universal_tpu_torch`) and its reference-parity harness
(`testing/reference_parity.py`), on the CPU (`-device cpu`).

Inputs are synthetic textures made from a seed (`testing/synthetic.py`),
written by the test as PNG (through Pillow, as the CLI reads them) and as
RGBA8 .dds (which the CLI reads without Pillow). The compressed files must
be the reference CLI's bytes where both encode the same way (UASTC), and the
chain compress -> -unpack -> -compare of the reference's own test must run.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu_torch import cli
from basis_universal_tpu_torch.formats.constants import BasisTexFormat
from basis_universal_tpu_torch.testing import reference_parity as rp
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu_torch.utils import image_io

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """The searches are thousands of small operators: one intra-op thread
    runs them as fast and does not fight the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img():
    return synthetic_texture(48, 64, seed=81, alpha=True)[0]


@pytest.fixture
def png(img, tmp_path):
    p = tmp_path / "in.png"
    Image.fromarray(img).save(p)
    return p


def test_cli_compress_unpack_compare(png, img, tmp_path, capsys):
    assert cli.main([str(png), "-q", "128", "-device", "cpu",
                     "-output_path", str(tmp_path)]) == 0
    out = tmp_path / "in.ktx2"
    assert out.exists()
    assert cli.main(["-unpack", str(out), "-device", "cpu",
                     "-output_path", str(tmp_path)]) == 0
    unpacked = tmp_path / "in_unpacked_rgba_0000.png"
    assert np.asarray(Image.open(unpacked)).shape == img.shape
    assert cli.main(["-compare", str(png), str(unpacked),
                     "-device", "cpu"]) == 0
    captured = capsys.readouterr().out
    assert "rgb_psnr" in captured and "ssim" in captured
    psnr = float(captured.split("rgb_psnr: ")[1].split()[0])
    assert psnr > 20.0


def test_cli_uastc_gives_the_reference_bytes(png, img, tmp_path):
    assert cli.main([str(png), "-uastc", "-effort", "2", "-basis",
                     "-device", "cpu", "-output_path", str(tmp_path)]) == 0
    want = ref_compressor.compress(img, ref_compressor.CompressorParams(
        tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2))
    assert (tmp_path / "in.basis").read_bytes() == want.basis_data


def test_cli_reads_dds_and_prints_info(img, tmp_path, capsys):
    dds = tmp_path / "t.dds"
    image_io.write_dds(dds, np.ascontiguousarray(img).tobytes(), 64, 48,
                       "RGBA8")
    assert cli.main([str(dds), "-basis", "-q", "64", "-device", "cpu",
                     "-output_path", str(tmp_path)]) == 0
    assert cli.main([str(tmp_path / "t.basis"), str(dds), "-info",
                     "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ".basis ETC1S images=1 slices=2" in out
    assert "slice 1: image=0 level=0 64x48 blocks=16x12 flags=0x1" in out
    assert "DDS RGBA8 64x48" in out
    assert cli.main([str(png_of(img, tmp_path)), "-device", "cpu",
                     "-output_path", str(tmp_path)]) == 0
    assert cli.main([str(tmp_path / "p.ktx2"), "-info", "-device",
                     "cpu"]) == 0
    assert "KTX2 vk_format=0 64x48 levels=1" in capsys.readouterr().out


def png_of(img, d):
    p = d / "p.png"
    Image.fromarray(img).save(p)
    return p


def test_cli_version_and_help(capsys):
    assert cli.main(["-version"]) == 0
    assert capsys.readouterr().out.strip() == "basis_universal_tpu_torch 0.1.0"
    assert cli.main([]) == 1
    assert "-device" in capsys.readouterr().out


def test_cli_bench_names_its_device(png, capsys):
    assert cli.main([str(png), "-bench", "-bench_reps", "1", "-q", "64",
                     "-device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "Mpix/s" in line and line.endswith("| on cpu")


def test_cli_test_codecs_against_a_golden_table(img, tmp_path, capsys):
    """-test_codecs_gen writes the golden table of a directory, and
    -test_codecs then holds a new sweep to it."""
    d = tmp_path / "files"
    d.mkdir()
    Image.fromarray(img[:16, :24]).save(d / "kodim01.png")
    golden = tmp_path / "golden.json"
    common = [str(d), "-golden", str(golden), "-codecs",
              "uastc,astc_ldr_4x4", "-device", "cpu"]
    assert cli.main(["-test_codecs_gen"] + common) == 0
    rows = json.loads(golden.read_text())
    assert sorted(rows) == ["astc_ldr_4x4:kodim01.png:q0:e1",
                            "uastc:kodim01.png:q0:e1"]
    assert cli.main(["-test_codecs"] + common) == 0
    assert "2/2 rows within tolerance" in capsys.readouterr().out
    rows["uastc:kodim01.png:q0:e1"]["rgb_psnr"] += 1.0
    golden.write_text(json.dumps(rows))
    assert cli.main(["-test_codecs"] + common) == 1
    assert "FAIL: uastc:kodim01.png:q0:e1: rgb_psnr" in \
        capsys.readouterr().out


def test_cli_runs_as_a_module(tmp_path):
    r = subprocess.run([sys.executable, "-m", "basis_universal_tpu_torch",
                        "-version"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "basis_universal_tpu_torch 0.1.0"


def test_cli_without_a_card_raises(png):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(png)])


def test_reference_parity_skips_without_its_files(monkeypatch, tmp_path,
                                                  capsys):
    monkeypatch.setattr(rp, "TEST_FILES", tmp_path / "absent")
    assert rp.main(["--device", "cpu"]) == 0
    assert "skipped: no test images" in capsys.readouterr().out
    said = []
    rows = rp.run_parity(grid=[("etc1s", "kodim03.png", 128, 1)],
                         reference={"etc1s:kodim03.png:q128:e1": {}},
                         progress=said.append, device="cpu")
    assert rows == [] and said == [
        f"skipped kodim03.png: not in {tmp_path / 'absent'}"]
    assert rp._oracle_args("uastc", 0, 2) == ["-basis", "-uastc",
                                              "-uastc_level", "2"]
    assert rp._our_format("xuastc_ldr_6x6") == BasisTexFormat.XUASTC_LDR_6x6
