"""The port's codec regression sweep (`basis_universal_tpu_torch/testing/
codec_sweep.py`) against the reference's, on the CPU (`device="cpu"`).

Inputs: a synthetic RGBA texture made from a seed (`testing/synthetic.py`),
written by the test as PNG into a directory of its own. The port's rows
must equal the reference's field for field (the same bytes give the same
sizes and the same metrics); its golden table is the reference's format, and
a sweep on the card where there is none raises.
"""

import pytest
import torch
from PIL import Image

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu.testing import codec_sweep as ref_sweep
from basis_universal_tpu_torch.testing import codec_sweep
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture


@pytest.fixture(autouse=True)
def _one_thread():
    """The searches are thousands of small operators: one intra-op thread
    runs them as fast and does not fight the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    img = synthetic_texture(16, 24, seed=91, alpha=True)[0]
    Image.fromarray(img).save(d / "kodim03.png")
    return d


def _quiet(**kw):
    return dict(images=["kodim03.png"], efforts=[1], hdr=False,
                progress=lambda *_: None, **kw)


@pytest.mark.parametrize("codecs,qualities", [
    (["etc1s"], [64]), (["uastc", "astc_ldr_4x4", "xuastc_ldr_6x6"], None)],
    ids=["etc1s", "uastc-astc-xuastc"])
def test_sweep_rows_match_the_reference_sweep(files, codecs, qualities):
    kw = _quiet(codecs=codecs, qualities=qualities)
    got = codec_sweep.run_sweep(files, device="cpu", **kw)
    want = ref_sweep.run_sweep(files, **kw)
    assert len(got) == len(want) == len(codecs)
    assert [r.__dict__ for r in got] == [r.__dict__ for r in want]


def test_golden_table_is_the_references(files, tmp_path):
    rows = codec_sweep.run_sweep(files, device="cpu",
                                 **_quiet(codecs=["uastc"]))
    mine, theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    codec_sweep.save_golden(rows, mine)
    ref_sweep.save_golden(rows, theirs)
    assert mine.read_text() == theirs.read_text()
    assert codec_sweep.check_against_golden(rows, theirs) == []
    rows[0].ktx2_size += 10_000
    assert codec_sweep.check_against_golden(rows, theirs) == \
        ref_sweep.check_against_golden(rows, theirs) != []


def test_sweep_on_the_card_without_one_raises(files):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        codec_sweep.run_sweep(files, **_quiet(codecs=["uastc"]))
