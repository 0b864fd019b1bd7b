"""The port's ETC1S frontend and compressor against the reference's, on the
CPU, on synthetic textures from `basis_universal_tpu_torch.testing.synthetic`.

64x64 runs k-means with a float32 cross term (fewer than 1024 endpoint
clusters), 256x256 with the bf16 one (2,064 clusters at q128). Every file
is decoded by the reference's host decoder with all CRCs checked.

The port spells out XLA-CPU's float32 order in every operator that ranks
(`ops/xla_order.py`), the perceptual metric's included, draws the random
fill of empty k-means seeds as jax.random does (`ops/threefry.py`) and
orders the refine shortlist's ties as the reference's `approx_min_k` does
(`etc1s_encode._refine_shortlist`), so the files are the reference's
bytes.

Both compressors must run the same host back end (`same_host_backend`).
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu import native as ref_native
from basis_universal_tpu.codecs.etc1s import frontend as ref_frontend
from basis_universal_tpu.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch import compressor, native
from basis_universal_tpu_torch.codecs.etc1s import frontend
from basis_universal_tpu_torch.testing.checks import etc1s_psnr
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

PSNR_TOL_DB = 0.05
SIZE_TOL = 0.015


def _load_reference_native():
    """Whether the reference's native library is loaded, after loading it
    again where an earlier attempt failed.

    The reference builds that library under one fixed temporary name in a
    cache shared by every process; when several test workers start with an
    empty cache and build it at once, a worker whose rename loses the race
    keeps the failure for the rest of its life. Once the winner's library is
    in place, a second attempt loads it."""
    for _ in range(30):
        if ref_native.available():
            return True
        ref_native._tried = False        # forget the lost race, load again
        time.sleep(1.0)
    return False


@pytest.fixture(autouse=True, scope="module")
def same_host_backend():
    """Hold the port to the reference's native host path, not to its
    fallback: without its native library the reference runs the device
    neighbour-copy RDO instead of the native one, and its files differ (the
    256x256 image: -0.08 dB against the port). Both packages must run the
    same back end."""
    assert _load_reference_native() == native.available()


def test_reference_native_loads_again_after_a_lost_build_race(monkeypatch):
    monkeypatch.setattr(ref_native, "_tried", True)     # the failure, kept
    monkeypatch.setattr(ref_native, "_lib", None)
    assert not ref_native.available()
    assert _load_reference_native() == native.available()


def _drift(port_out, ref_out, img):
    """(PSNR port - ref in dB, size port / ref - 1) of one texture."""
    p_port = etc1s_psnr(port_out.basis_data, img)
    p_ref = etc1s_psnr(ref_out.basis_data, img)
    assert p_port > 20.0
    print(f"PSNR port {p_port:.4f} ref {p_ref:.4f} dB; size "
          f"{len(port_out.basis_data)} vs {len(ref_out.basis_data)} B")
    return p_port - p_ref, len(port_out.basis_data) / len(ref_out.basis_data) - 1


def _same_bytes(port_out, ref_out, img):
    _drift(port_out, ref_out, img)
    assert port_out.basis_data == ref_out.basis_data
    assert port_out.ktx2_data == ref_out.ktx2_data


def test_seed_fill_is_the_references_draw():
    """Empty k-means seeds take the training vectors jax.random.choice
    draws from PRNGKey(seed) (`ops/threefry.py`)."""
    from basis_universal_tpu_torch.ops import threefry

    for seed in (0, 1, 63, 2**31 - 1, -5):
        for n, k in ((256, 144), (24576, 2416), (7, 300), (100003, 17)):
            want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed),
                                                jnp.arange(n), (k,)))
            np.testing.assert_array_equal(
                threefry.choice_indices(seed, n, k), want)


@pytest.mark.parametrize("alpha", [False, True])
def test_compress_matches_reference_64(alpha):
    """64x64 (256 blocks, 144 endpoint clusters): the reference's bytes, six
    seeds each. (One exact endpoint tie broken the other way moves a
    bisecting split and so the whole small codebook: the port spells out
    XLA-CPU's float32 order in every operator that ranks.)"""
    for seed in range(60, 66):
        img, _ = synthetic_texture(64, 64, seed=seed, alpha=alpha)
        ref = ref_compressor.compress(img, ref_compressor.CompressorParams())
        port = compressor.compress(img, compressor.CompressorParams(
            device="cpu"))
        assert len(port.slice_endpoints) == (2 if alpha else 1)
        _same_bytes(port, ref, img)


def test_compress_matches_reference_256():
    """256x256: 2,064 endpoint clusters, the bf16 k-means cross term."""
    img, _ = synthetic_texture(256, 256, seed=256)
    port = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams())
    _same_bytes(port, ref, img)


@pytest.mark.parametrize("quality,effort,perceptual", [
    (16, 0, False), (255, 0, False), (255, 3, False), (128, 6, True)])
def test_compress_matches_reference_across_settings(quality, effort,
                                                    perceptual):
    """Other codebook sizes, efforts (radius 2 and a 32-wide shortlist at
    effort 6, three refine passes at 3) and the perceptual metric, on one
    128x128 RGBA texture: the reference's bytes. The perceptual metric's
    transforms, moments and sums round as XLA-CPU rounds the reference's
    (`etc1s_encode.perceptual_transform`, `_block_moments`)."""
    img, _ = synthetic_texture(128, 128, seed=77, alpha=True)
    port = compressor.compress(img, compressor.CompressorParams(
        device="cpu", quality_level=quality, effort=effort,
        perceptual_metric=perceptual))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams(
        quality_level=quality, effort=effort, perceptual_metric=perceptual))
    _same_bytes(port, ref, img)


@pytest.mark.parametrize("size,seed,quality,effort", [
    ((64, 64), 3, 128, 1), ((128, 128), 5, 128, 1), ((128, 128), 6, 80, 2),
    ((84, 100), 8, 255, 3), ((84, 100), 8, 128, 1), ((256, 256), 256, 128, 1)])
def test_compress_perceptual_matches_reference(size, seed, quality, effort):
    """The perceptual metric at other sizes, qualities and efforts: the
    reference's bytes. The 84x100 texture's 525 blocks give candidate-base
    arrays whose row count is no multiple of 8, and q 80 at 128x128 and
    both 84x100 settings an odd codebook (397, 525, 279 entries), so the
    transform's trailing rows (`etc1s_encode._perc_rows`) run in the scan,
    the cluster scan and the refine's rescore."""
    img, _ = synthetic_texture(*size, seed=seed)
    port = compressor.compress(img, compressor.CompressorParams(
        device="cpu", quality_level=quality, effort=effort,
        perceptual_metric=True))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams(
        quality_level=quality, effort=effort, perceptual_metric=True))
    _same_bytes(port, ref, img)


def test_compress_batch_matches_reference_and_is_deterministic():
    """Two 128x128 textures (528 endpoint clusters): the reference's bytes,
    each. In image 5 one block's refine shortlist has several entries at
    equal 6-D distance about its 16th place; the reference's `approx_min_k`
    (an unstable sort on the CPU) keeps the ones its `std::sort` leaves
    there, and so does the port (`_refine_shortlist`): a stable sort kept
    others, and that image differed. Two runs give the same bytes."""
    imgs = [synthetic_texture(128, 128, seed=s)[0] for s in (5, 6)]
    params = compressor.CompressorParams(device="cpu")
    port = compressor.compress_batch(imgs, params)
    ref = ref_compressor.compress_batch(imgs, ref_compressor.CompressorParams())
    for p, r, img in zip(port, ref, imgs):
        _same_bytes(p, r, img)
    again = compressor.compress_batch(imgs, params)
    assert [o.basis_data for o in again] == [o.basis_data for o in port]


def test_compress_batch_mixed_sizes_runs_per_image():
    imgs = [synthetic_texture(64, 64, seed=1)[0],
            synthetic_texture(40, 48, seed=2)[0]]
    params = compressor.CompressorParams(device="cpu")
    batch = compressor.compress_batch(imgs, params)
    single = [compressor.compress(i, params) for i in imgs]
    assert [o.basis_data for o in batch] == [o.basis_data for o in single]
    assert etc1s_psnr(batch[1].basis_data, imgs[1]) > 20.0


def test_compress_with_global_codebooks_fed_the_reference_codebook():
    img, _ = synthetic_texture(64, 64, seed=9)
    blocks = image_to_blocks(img).reshape(-1, 16, 3)
    fe = ref_frontend.compress(blocks.astype(np.float32),
                               ref_frontend.FrontendParams(
                                   max_endpoint_clusters=100,
                                   max_selector_clusters=100, effort=1,
                                   perceptual=False))
    cb = (fe.endpoint_color5, fe.endpoint_inten5, fe.selectors)
    got = frontend.compress_with_global_codebooks(blocks, *cb, effort=1,
                                                  perceptual=False,
                                                  device="cpu")
    want = ref_frontend.compress_with_global_codebooks(blocks, *cb, effort=1,
                                                       perceptual=False)
    np.testing.assert_array_equal(got.endpoint_color5, want.endpoint_color5)
    np.testing.assert_array_equal(got.selectors, want.selectors)
    # assignments may differ only between entries the block scores equally
    pal = np.clip(((cb[0].astype(np.int32) << 3) | (cb[0] >> 2))[:, None, :]
                  + ref_frontend.ETC1_INTEN_TABLES[cb[1]][:, :, None], 0, 255)

    def err(e, s):
        p = pal[e]                                           # (B,4,3)
        sel = cb[2][s]                                       # (B,16)
        rec = np.take_along_axis(p, sel[..., None].astype(np.int64), 1)
        return ((blocks.astype(np.float64) - rec) ** 2).sum((1, 2))

    e_g = err(got.block_endpoints, got.block_selectors)
    e_w = err(want.block_endpoints, want.block_selectors)
    np.testing.assert_allclose(e_g, e_w, rtol=1e-5)
    ties = (got.block_endpoints != want.block_endpoints).sum()
    print(f"global codebooks: endpoint ties {ties}/{len(blocks)}")
    # through the compressor: a valid file with the shared-codebook flag
    params = compressor.CompressorParams(device="cpu", global_codebooks=cb)
    ref_params = ref_compressor.CompressorParams(global_codebooks=cb)
    out = compressor.compress(img, params)
    if ties == 0:
        assert out.basis_data == ref_compressor.compress(img, ref_params).basis_data


def test_frontend_ranks_without_tf32_and_restores_the_setting(monkeypatch):
    seen = []
    port_kmeans = frontend.ops.kmeans

    def kmeans(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return port_kmeans(*args, **kwargs)

    monkeypatch.setattr(frontend.ops, "kmeans", kmeans)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    img, _ = synthetic_texture(16, 16, seed=1)
    compressor.compress(img, compressor.CompressorParams(device="cpu"))
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_init_selector_patterns_matches_reference():
    rng = np.random.default_rng(3)
    distinct = rng.integers(0, 4, (20, 16))
    distinct[0, 15] = 3                     # a key with the int32 sign bit set
    opt_sel = distinct[rng.integers(0, 20, 300)]
    for num_s in (12, 30):                  # 30 > 20 distinct: empty groups
        got = frontend._init_selector_patterns(torch.from_numpy(opt_sel), num_s)
        want = ref_frontend._init_selector_patterns(jnp.asarray(opt_sel), num_s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


def test_host_helpers_match_reference():
    for q in (1, 16, 50, 100, 128, 129, 160, 192, 223, 255):
        for blocks in (16, 256, 4096, 24576, 98304):
            assert (compressor.etc1s_quality_to_clusters(q, blocks)
                    == ref_compressor.etc1s_quality_to_clusters(q, blocks))
        for effort in (0, 1, 2, 3, 6):
            kw = dict(quality_level=q, effort=effort)
            assert (compressor._rdo_thresholds(compressor.CompressorParams(**kw))
                    == ref_compressor._rdo_thresholds(
                        ref_compressor.CompressorParams(**kw)))
    for effort in range(11):
        assert frontend._effort_knobs(effort) == ref_frontend._effort_knobs(effort)
        fp = frontend.FrontendParams(max_endpoint_clusters=5000,
                                     max_selector_clusters=900, effort=effort)
        rp = ref_frontend.FrontendParams(max_endpoint_clusters=5000,
                                         max_selector_clusters=900,
                                         effort=effort)
        for b in (300, 24576):
            knobs, _, _ = frontend._knobs_and_neighbors(b, fp, None)
            rknobs, _, _ = ref_frontend._knobs_and_neighbors(b, rp, None)
            rknobs.pop("init_sub")
            assert knobs == rknobs

    img = synthetic_texture(20, 36, seed=4, alpha=True)[0]
    p = compressor.CompressorParams(device="cpu", mip_gen=True)
    rp = ref_compressor.CompressorParams(mip_gen=True)
    sl, rsl = compressor._prepare_slices([img], p), ref_compressor._prepare_slices([img], rp)
    assert len(sl) == len(rsl)
    for a, b in zip(sl, rsl):
        np.testing.assert_array_equal(a["blocks"], b["blocks"])
        assert {k: a[k] for k in a if k != "blocks"} == \
            {k: b[k] for k in a if k != "blocks"}
    for x, y in zip(compressor._slice_neighbors(sl),
                    ref_compressor._slice_neighbors(rsl)):
        np.testing.assert_array_equal(x, y)
    assert compressor._ktx2_layout(p, sl) == ref_compressor._ktx2_layout(rp, rsl)

    rng = np.random.default_rng(5)
    args = (rng.integers(0, 30, 200), rng.integers(0, 32, (30, 3)),
            rng.integers(0, 8, 30), rng.integers(0, 4, (25, 16)),
            rng.integers(0, 25, 200), 30, 25)
    got, want = frontend._host_finalize(*args), ref_frontend._host_finalize(*args)
    for f in ("endpoint_color5", "endpoint_inten5", "selectors",
              "block_endpoints", "block_selectors"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
