"""The values `chip_smoke.py` holds the port's encode modes beyond ETC1S
and UASTC to: recorded here from the JAX reference package on the CPU, on
the synthetic textures the script encodes, and tested here to be still what
the reference gives.

    JAX_PLATFORMS=cpu python tests/test_torch_recorded_reference.py [--only NAME ...]

run as a script prints one JSON line per stage (PSNR, sizes, mode histogram,
seconds on this CPU) to paste into `chip_smoke.py`, and writes the per-block
digests of the BC7 stages (two bytes of BLAKE2b per block, enough to count
identical blocks) to
`basis_universal_tpu_torch/testing/bc7_reference_digests.npz`. Under pytest
the file re-encodes the first blocks of each BC7 stage with the reference
and with the port and holds both to the recorded digests, and checks that
the script's constants and the digests describe the same stages.

The stage `etc1s_image0_shortlist` records the refine shortlist that the
reference's own `approx_min_k` (an unstable sort on the CPU) takes from
image 0's refine distances, to
`basis_universal_tpu_torch/testing/etc1s_image0_refine_shortlist.npz`;
`chip_smoke.py` feeds it to the port on the card, which then gives the
reference's recorded bytes.
"""

import hashlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from basis_universal_tpu import compressor, transcoder          # noqa: E402
from basis_universal_tpu.codecs.bc7 import encode as bc7_encode  # noqa: E402
from basis_universal_tpu.formats.constants import BasisTexFormat as F  # noqa: E402
from basis_universal_tpu.formats.constants import \
    TranscoderTextureFormat as TF                               # noqa: E402
from basis_universal_tpu_torch.ops.etc1 import image_to_blocks  # noqa: E402
from basis_universal_tpu_torch.ops.gpu_unpack import unpack_bc7  # noqa: E402
from basis_universal_tpu_torch.testing.checks import (  # noqa: E402
    bc7_mode_histogram, block_digests, psnr)
from basis_universal_tpu_torch.testing.synthetic import \
    synthetic_texture                                           # noqa: E402

DIGESTS = (REPO / "basis_universal_tpu_torch" / "testing"
           / "bc7_reference_digests.npz")
SHORTLIST = (REPO / "basis_universal_tpu_torch" / "testing"
             / "etc1s_image0_refine_shortlist.npz")


def _rgba(img):
    if img.shape[-1] == 4:
        return img
    return np.concatenate(
        [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)


def _emit(name, t0, **fields):
    print(json.dumps(dict(stage=name, seconds=round(time.time() - t0, 1),
                          **fields)), flush=True)


def bc7_stage(name, img, effort, digests):
    t0 = time.time()
    px = image_to_blocks(_rgba(img)).reshape(-1, 16, 4)
    blocks = bc7_encode.encode_blocks(px, effort=effort)
    modes = bc7_mode_histogram(blocks)
    digests[name] = block_digests(blocks)
    _emit(name, t0, psnr=psnr(unpack_bc7(blocks), px),
          sha256=hashlib.sha256(blocks.tobytes()).hexdigest(),
          modes=modes.tolist())


def compress_stage(name, img, **kw):
    t0 = time.time()
    out = compressor.compress(img, compressor.CompressorParams(**kw))
    dec = transcoder.BasisTranscoder(out.basis_data).transcode_image_level(
        0, 0, TF.RGBA32)
    _emit(name, t0, psnr=psnr(np.asarray(dec), _rgba(img)),
          basis_bytes=len(out.basis_data), ktx2_bytes=len(out.ktx2_data),
          sha256=hashlib.sha256(out.basis_data).hexdigest())


# blocks of each BC7 stage the tests re-encode (the search is per block, so a
# prefix of the image gives the image's first digests)
N_CHECKED = 256


@pytest.fixture(autouse=True)
def _one_thread():
    """The search is thousands of small operators: with one intra-op thread
    it runs as fast as with many, and does not fight the other test
    workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage_pixels(name):
    img = synthetic_texture(512, 768, seed=4, alpha=True)[0] \
        if "rgba" in name else synthetic_texture(512, 768, seed=0)[0]
    return image_to_blocks(_rgba(img)).reshape(-1, 16, 4)[:N_CHECKED]


def fed_the_references_sort(img, **kw):
    """The port's ETC1S encode of img on the CPU with every refine
    shortlist taken by the reference's `jax.lax.approx_min_k` (jitted on
    the CPU, as in `refine_endpoint_assignment`) from the port's own refine
    distances in place of the port's own shortlist. Returns (the .basis
    bytes, the shortlists in call order)."""
    import jax
    import jax.numpy as jnp

    amk = jax.jit(lambda d, k: jax.lax.approx_min_k(d, k)[1],
                  static_argnums=1)
    taken = []

    def references_sort(d6, k):
        taken.append(np.array(amk(jnp.asarray(d6.numpy()), k)))
        return torch.from_numpy(taken[-1]).long()

    return _port_with_refine_shortlist(img, references_sort, **kw), taken


def _port_with_refine_shortlist(img, shortlist, **kw):
    """The port's ETC1S .basis bytes of img on the CPU with `shortlist(d6,
    k)` in place of the refine's own (`etc1s_encode._refine_shortlist`)."""
    from basis_universal_tpu_torch import compressor as port_compressor
    from basis_universal_tpu_torch.ops import etc1s_encode as tops

    own = tops._refine_shortlist
    tops._refine_shortlist = shortlist
    try:
        out = port_compressor.compress(img, port_compressor.CompressorParams(
            device="cpu", **kw))
    finally:
        tops._refine_shortlist = own
    return out.basis_data


def test_port_fed_the_references_sort_gives_the_references_bytes():
    """The witness of the refine shortlist's tie order (ROADMAP section 3):
    with the refine shortlist taken by the reference's own unstable sort
    from the port's distances, the port's file is the reference's byte for
    byte, on a texture whose file differs under a stable sort (128x128,
    seed 5, q 128); the port's own shortlist, which orders ties as that
    sort does, gives the same bytes."""
    from basis_universal_tpu_torch import compressor as port_compressor
    from basis_universal_tpu_torch.ops import etc1s_encode as tops

    img = synthetic_texture(128, 128, seed=5)[0]
    want = compressor.compress(img, compressor.CompressorParams()).basis_data
    stable = _port_with_refine_shortlist(img, tops._shortlist)
    own = port_compressor.compress(img, port_compressor.CompressorParams(
        device="cpu")).basis_data
    got, taken = fed_the_references_sort(img)
    assert stable != want
    assert got == want
    assert own == want
    assert [t.shape for t in taken] == [(1024, 16)]


def test_recorded_refine_shortlist_gives_image_0_the_references_bytes():
    """Image 0 (768x512, q 128, effort 1): the reference's sort, taken
    from the port's refine distances, is the recorded shortlist, and with
    it the port's file has the reference's recorded sha256."""
    smoke = _chip_smoke()
    img = synthetic_texture(512, 768, seed=0)[0]
    got, taken = fed_the_references_sort(img, quality_level=128, effort=1)
    assert len(taken) == 1
    np.testing.assert_array_equal(taken[0], np.load(SHORTLIST)["cand"])
    assert hashlib.sha256(got).hexdigest() == \
        smoke.REFERENCE_BASIS_SHA256["etc1s_image0"]


def shortlist_stage(name, img):
    t0 = time.time()
    data, taken = fed_the_references_sort(img, quality_level=128, effort=1)
    np.savez_compressed(SHORTLIST, cand=taken[0].astype(np.int16))
    _emit(name, t0, basis_bytes=len(data),
          sha256=hashlib.sha256(data).hexdigest(),
          shortlist=list(taken[0].shape))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_gives_image_0_the_references_bytes():
    """Image 0 (768x512, q 128, effort 1) through the port's own refine
    shortlist, which orders ties as the reference's `approx_min_k` does:
    the reference's recorded sha256 (46,997 B), as `chip_smoke.py` asserts
    on the card."""
    from basis_universal_tpu_torch import compressor as port_compressor

    img = synthetic_texture(512, 768, seed=0)[0]
    got = port_compressor.compress(img, port_compressor.CompressorParams(
        device="cpu", quality_level=128, effort=1)).basis_data
    assert len(got) == 46997
    assert hashlib.sha256(got).hexdigest() == \
        _chip_smoke().REFERENCE_BASIS_SHA256["etc1s_image0"]


def test_recorded_bc7_digests_are_the_reference_and_the_port():
    """One effort-1 and one effort-2 stage: the recorded digests of the first
    blocks are those of the reference's blocks today and of the port's."""
    from basis_universal_tpu_torch.codecs.bc7 import encode as port_bc7

    recorded = np.load(DIGESTS)
    for name, effort in (("bc7_rgb_e1", 1), ("bc7_rgba_e2", 2)):
        px = _stage_pixels(name)
        want = recorded[name][:N_CHECKED]
        ref = block_digests(bc7_encode.encode_blocks(px, effort=effort))
        port = block_digests(port_bc7.encode_blocks(px, effort=effort,
                                                    device="cpu"))
        np.testing.assert_array_equal(ref, want)
        np.testing.assert_array_equal(port, want)


def test_chip_smoke_constants_and_digests_name_the_same_stages():
    smoke = _chip_smoke()
    recorded = np.load(DIGESTS)
    assert sorted(recorded.files) == sorted(smoke.REFERENCE_BC7)
    n_blocks = (smoke.HEIGHT // 4) * (smoke.WIDTH // 4)
    for name, ref in smoke.REFERENCE_BC7.items():
        assert recorded[name].shape == (n_blocks,)
        assert recorded[name].dtype == np.uint16
        assert sum(ref["modes"]) == n_blocks
    for ref in smoke.REFERENCE_MODES.values():
        assert set(ref) == {"psnr", "basis_bytes", "sha256"}


def main():
    only = set(sys.argv[sys.argv.index("--only") + 1:]) \
        if "--only" in sys.argv else None
    rgb = synthetic_texture(512, 768, seed=0)[0]
    rgba = synthetic_texture(512, 768, seed=4, alpha=True)[0]
    small = synthetic_texture(256, 384, seed=0)[0]
    digests = dict(np.load(DIGESTS)) if DIGESTS.exists() else {}
    stages = {
        "etc1s_image0": lambda: compress_stage(
            "etc1s_image0", rgb, quality_level=128, effort=1),
        "etc1s_image0_shortlist": lambda: shortlist_stage(
            "etc1s_image0_shortlist", rgb),
        "uastc_image0": lambda: compress_stage(
            "uastc_image0", rgb, tex_format=F.UASTC_LDR_4x4, effort=2),
        "uastc_rgba": lambda: compress_stage(
            "uastc_rgba", rgba, tex_format=F.UASTC_LDR_4x4, effort=2),
        "bc7_rgb_e2": lambda: bc7_stage("bc7_rgb_e2", rgb, 2, digests),
        "bc7_rgba_e2": lambda: bc7_stage("bc7_rgba_e2", rgba, 2, digests),
        "bc7_rgb_e1": lambda: bc7_stage("bc7_rgb_e1", rgb, 1, digests),
        "xubc7_q100": lambda: compress_stage(
            "xubc7_q100", rgb, tex_format=F.XUBC7, quality_level=100,
            effort=2),
        "xubc7_q50": lambda: compress_stage(
            "xubc7_q50", rgb, tex_format=F.XUBC7, quality_level=50, effort=2),
        "xubc7_q50_small": lambda: compress_stage(
            "xubc7_q50_small", small, tex_format=F.XUBC7, quality_level=50,
            effort=2),
        "astc_4x4": lambda: compress_stage(
            "astc_4x4", rgb, tex_format=F.ASTC_LDR_4x4, effort=2),
        "astc_6x6": lambda: compress_stage(
            "astc_6x6", rgb, tex_format=F.ASTC_LDR_6x6, effort=1),
        "astc_6x6_small": lambda: compress_stage(
            "astc_6x6_small", small, tex_format=F.ASTC_LDR_6x6, effort=1),
        "xuastc_4x4": lambda: compress_stage(
            "xuastc_4x4", rgb, tex_format=F.XUASTC_LDR_4x4, quality_level=75,
            effort=2),
        "xuastc_4x4_arith": lambda: compress_stage(
            "xuastc_4x4_arith", rgb, tex_format=F.XUASTC_LDR_4x4,
            quality_level=75, effort=2, xuastc_syntax="arith"),
        "xuastc_6x6": lambda: compress_stage(
            "xuastc_6x6", rgb, tex_format=F.XUASTC_LDR_6x6, quality_level=75,
            effort=1),
        "xuastc_6x6_small": lambda: compress_stage(
            "xuastc_6x6_small", small, tex_format=F.XUASTC_LDR_6x6,
            quality_level=75, effort=1),
        "xuastc_6x6_small_arith": lambda: compress_stage(
            "xuastc_6x6_small_arith", small, tex_format=F.XUASTC_LDR_6x6,
            quality_level=75, effort=1, xuastc_syntax="arith"),
    }
    for name, run in stages.items():
        if only is None or name in only:
            run()
    np.savez_compressed(DIGESTS, **digests)


if __name__ == "__main__":
    main()
