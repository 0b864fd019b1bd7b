"""The port's ETC1S frontend and compressor against the reference's, on the
CPU, on synthetic textures from `basis_universal_tpu_torch.testing.synthetic`.

64x64 runs k-means with a float32 cross term (fewer than 1024 endpoint
clusters), 256x256 with the bf16 one (1,240 clusters at q128). Every file
is decoded by the reference's host decoder with all CRCs checked.

The port draws the random fill of empty k-means seeds from a
torch.Generator, the reference from jax.random; the `reference_fill` fixture
hands the port the reference's draw (through `utils/state.py`), so what is
left is summation order and ties. PSNR must agree within 0.05 dB and file
size within 1.5% per image (at 64x64 once exact ties are resolved as the
reference resolves them, see there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu.codecs.etc1s import frontend as ref_frontend
from basis_universal_tpu.ops import etc1s_encode as ref_ops
from basis_universal_tpu.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.codecs.etc1s import frontend
from basis_universal_tpu_torch.testing.checks import etc1s_psnr
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
from basis_universal_tpu_torch.utils import state

PSNR_TOL_DB = 0.05
SIZE_TOL = 0.015


@pytest.fixture
def reference_fill(monkeypatch):
    """Seed fills drawn as the reference draws them: jax.random.choice with
    PRNGKey(seed) over the training vectors, seed = the generator's seed."""
    ops = frontend.ops
    port_init = ops.bisecting_init

    def init(vecs, weights, num_clusters, generator=None, fill=None):
        key = jax.random.PRNGKey(generator.initial_seed())
        draw = jax.random.choice(key, jnp.asarray(vecs.cpu().numpy()),
                                 (num_clusters,))
        return port_init(vecs, weights, num_clusters,
                         fill=state.vectors(np.asarray(draw), vecs.device))

    monkeypatch.setattr(ops, "bisecting_init", init)


def _drift(port_out, ref_out, img):
    """(PSNR port - ref in dB, size port / ref - 1) of one texture."""
    p_port = etc1s_psnr(port_out.basis_data, img)
    p_ref = etc1s_psnr(ref_out.basis_data, img)
    assert p_port > 20.0
    print(f"PSNR port {p_port:.4f} ref {p_ref:.4f} dB; size "
          f"{len(port_out.basis_data)} vs {len(ref_out.basis_data)} B")
    return p_port - p_ref, len(port_out.basis_data) / len(ref_out.basis_data) - 1


def _agree(port_out, ref_out, img):
    dp, ds = _drift(port_out, ref_out, img)
    assert abs(dp) <= PSNR_TOL_DB and abs(ds) <= SIZE_TOL


def _take_reference_ties(monkeypatch):
    """Make the port's encode_blocks take the reference's endpoint wherever
    the two pick different ones, after checking that both choices score the
    same there (an exact tie, broken by the float rounding of the shortlist
    scores)."""
    ops = frontend.ops
    port_encode = ops.encode_blocks

    def encode(px, radius=1, perceptual=False):
        got = port_encode(px, radius=radius, perceptual=perceptual)
        want = ref_ops.encode_blocks(jnp.asarray(px.numpy()), radius=radius,
                                     perceptual=perceptual)
        want = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
        differ = ~((got["color5"] == want["color5"]).all(-1)
                   & (got["inten"] == want["inten"]))
        np.testing.assert_allclose(got["err"][differ], want["err"][differ],
                                   rtol=1e-5)
        print(f"encode_blocks: took the reference's choice at "
              f"{int(differ.sum())} tied blocks")
        return {k: torch.where(differ.view(-1, *[1] * (v.dim() - 1)),
                               want[k], v) for k, v in got.items()}

    monkeypatch.setattr(ops, "encode_blocks", encode)


@pytest.mark.parametrize("alpha", [False, True])
def test_compress_matches_reference_64(alpha, reference_fill, monkeypatch):
    """64x64 (256 blocks, 144 endpoint clusters), each image held to the
    bound. One exact endpoint tie in encode_blocks broken the other way
    moves a bisecting split and so the whole small codebook: seed 64 (RGB)
    drifts by -0.149 dB. An image past the bound is encoded again with the
    reference's choice at the tied blocks (checked to tie), and must then
    agree: the drift was the tie's, not the port's."""
    retried = 0
    for seed in range(60, 66):
        img, _ = synthetic_texture(64, 64, seed=seed, alpha=alpha)
        params = compressor.CompressorParams(device="cpu")
        ref = ref_compressor.compress(img, ref_compressor.CompressorParams())
        port = compressor.compress(img, params)
        assert len(port.slice_endpoints) == (2 if alpha else 1)
        dp, ds = _drift(port, ref, img)
        if abs(dp) > PSNR_TOL_DB or abs(ds) > SIZE_TOL:
            retried += 1
            with monkeypatch.context() as m:
                _take_reference_ties(m)
                port = compressor.compress(img, params)
            dp, ds = _drift(port, ref, img)
        assert abs(dp) <= PSNR_TOL_DB and abs(ds) <= SIZE_TOL, seed
    print(f"64x64 alpha={alpha}: {retried} of 6 images needed the "
          "reference's tie choice")


def test_compress_matches_reference_256(reference_fill):
    img, _ = synthetic_texture(256, 256, seed=256)
    port = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams())
    _agree(port, ref, img)


@pytest.mark.parametrize("quality,effort,perceptual", [
    (16, 0, False), (255, 0, False), (255, 3, False), (128, 6, True)])
def test_compress_matches_reference_across_settings(quality, effort,
                                                    perceptual,
                                                    reference_fill):
    """Other codebook sizes, efforts (radius 2 and a 32-wide shortlist at
    effort 6, three refine passes at 3) and the perceptual metric, on one
    128x128 RGBA texture. Measured drift over q {16, 128, 255} x effort
    {0, 1, 3, 6} x perceptual: at most 0.09 dB and 0.75%; the bound here is
    0.1 dB and 3% per setting."""
    img, _ = synthetic_texture(128, 128, seed=77, alpha=True)
    port = compressor.compress(img, compressor.CompressorParams(
        device="cpu", quality_level=quality, effort=effort,
        perceptual_metric=perceptual))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams(
        quality_level=quality, effort=effort, perceptual_metric=perceptual))
    dp, ds = _drift(port, ref, img)
    assert abs(dp) <= 0.1 and abs(ds) <= 0.03


def test_compress_batch_matches_reference_and_is_deterministic(
        reference_fill):
    imgs = [synthetic_texture(128, 128, seed=s)[0] for s in (5, 6)]
    params = compressor.CompressorParams(device="cpu")
    port = compressor.compress_batch(imgs, params)
    ref = ref_compressor.compress_batch(imgs, ref_compressor.CompressorParams())
    for p, r, img in zip(port, ref, imgs):
        _agree(p, r, img)
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
