"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card (marked `cuda`; each test skips where there is none). This file
imports no jax; `tests/conftest.py` does, so where jax is not installed run
it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances are those of `test_torch_kernels.py`: floats rtol 1e-5, the
scan's plus 1e-6 of `checks.scan_term_magnitude` (the terms its formula
cancels); indices equal except at ties. Encodes on the card are repeated
and must give the same bytes (the segment sums are deterministic).
"""

import numpy as np
import pytest
import torch

from basis_universal_tpu_torch.ops import cuda_etc1s as ck

RTOL = 1e-5
B = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.reset_launch_counts()
    return torch.device("cuda")


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 1, 3)) + rng.integers(-24, 25, (n, 16, 3))
    px[: n // 6] = rng.integers(0, 256, (n // 6, 16, 3))
    return torch.as_tensor(np.clip(px, 0, 255), dtype=torch.float32)


def _close(got, want, mag=0.0):
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    bound = RTOL * want.abs() + 1e-6 * mag
    assert torch.all(err <= bound), f"worst err/bound {(err / bound).max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_factorized_scan_on_card(cuda, radius, perceptual):
    from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

    px = _blocks(B, 41 + radius)
    base5 = torch.as_tensor(np.random.default_rng(1).integers(0, 32, (B, 3)),
                            dtype=torch.float32)
    for base in (None, base5):
        kw = dict(radius=radius, perceptual=perceptual)
        got = ck.factorized_scan(px.to(cuda),
                                 None if base is None else base.to(cuda), **kw)
        want = ck.factorized_scan_reference(px, base, **kw)
        _close(got, want, scan_term_magnitude(px, base, **kw))
    assert ck.LAUNCHES["factorized_scan"] == 2


def _packed(rng, k):
    c5 = rng.integers(0, 32, (B, k, 3))
    return torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
                           | (rng.integers(0, 8, (B, k)) << 15),
                           dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 8])
@pytest.mark.parametrize("perceptual", [False, True])
def test_palette_errs_packed_on_card(cuda, perceptual, k):
    px = _blocks(B, 43)
    packed = _packed(np.random.default_rng(7), k)
    got = ck.palette_errs_packed(px.to(cuda), packed.to(cuda), perceptual)
    _close(got, ck.palette_errs_packed_reference(px, packed, perceptual))
    assert ck.LAUNCHES["palette_errs_packed"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
def test_palette_errs_on_card(cuda, perceptual):
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    px = _blocks(B, 44)
    packed = _packed(np.random.default_rng(8), 16)
    c5 = torch.stack([packed & 31, (packed >> 5) & 31, (packed >> 10) & 31], -1)
    tabs = torch.as_tensor(ck.ETC1_INTEN_TABLES, dtype=torch.float32)
    pal = torch.clamp(ops.expand5(c5).float()[:, :, None, :]
                      + tabs[((packed >> 15) & 7).long()][..., None], 0, 255)
    if perceptual:
        px, pal = ops.perceptual_transform(px), ops.perceptual_transform(pal)
    got = ck.palette_errs(px.to(cuda), pal.contiguous().to(cuda))
    want = ck.palette_errs_reference(px, pal)
    if perceptual:
        _close(got, want)
    else:
        # integer pixels and palettes: every partial sum is exact
        assert torch.equal(got.cpu(), want)
    assert ck.LAUNCHES["palette_errs"] == 1


@pytest.mark.cuda
def test_segment_sum_is_deterministic_on_card(cuda):
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    gen = torch.Generator().manual_seed(5)
    data = torch.randn((24576, 43), generator=gen) * 1000.0
    ids = torch.randint(0, 2416, (24576,), generator=gen)
    ids[:4000] = 7                                  # one large segment
    first = ops.segment_sum(data.to(cuda), ids.to(cuda), 2500)
    for _ in range(3):
        assert torch.equal(ops.segment_sum(data.to(cuda), ids.to(cuda), 2500),
                           first)
    cpu = ops.segment_sum(data, ids, 2500)
    scale = data.abs().max() * 4000
    assert torch.all((first.cpu() - cpu).abs() <= RTOL * (cpu.abs() + scale))
    print("segment_sum card == cpu bit for bit:", torch.equal(first.cpu(), cpu))


@pytest.mark.cuda
def test_uastc_search_on_card_matches_cpu(cuda):
    """Same tie rule as `test_torch_uastc_encode.py`: a block coded
    differently must decode to the same squared error."""
    from basis_universal_tpu.codecs.uastc.decode import decode_rgba
    from basis_universal_tpu_torch.codecs.uastc import encode, pack

    rng = np.random.default_rng(9)
    px = np.concatenate([_blocks(B - 20, 45).numpy(),
                         np.full((20, 16, 3), 255.0, np.float32)])
    alpha = rng.integers(0, 256, (B, 16, 1)).astype(np.float32)
    px = np.concatenate([px, alpha], -1)
    px[B // 2:, :, 3] = 255.0
    modes, ls_iters, extra, topk = pack._effort_mode_set(3, True)
    got = encode._search(torch.as_tensor(px).to(cuda), modes, ls_iters, extra,
                         topk)
    assert ck.LAUNCHES["factorized_scan"] == 1
    assert ck.LAUNCHES["palette_errs_packed"] == 1
    want = encode._search(torch.as_tensor(px), modes, ls_iters, extra, topk)
    got_b = pack._pack_from_compact(got, px, modes, extra)
    want_b = pack._pack_from_compact(want, px, modes, extra)
    differ = (got_b != want_b).any(1)

    def sse(blocks):
        dec = decode_rgba(blocks).reshape(-1, 16, 4).astype(np.float64)
        return ((dec - px[differ]) ** 2).sum((1, 2))

    np.testing.assert_array_equal(sse(got_b[differ]), sse(want_b[differ]))
    print(f"UASTC search card vs cpu: {int(differ.sum())} of {B} blocks "
          "differ, all ties")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 2100, 5000])
def test_find_best_selector_patterns_on_card(cuda, s):
    gen = torch.Generator().manual_seed(s)
    dists = torch.rand((B, 16, 4), generator=gen) * 5000.0
    pats = torch.randint(0, 4, (s, 16), generator=gen, dtype=torch.int32)
    best, val = ck.find_best_selector_patterns(dists.to(cuda), pats.to(cuda), s)
    pb, pv = ck.find_best_selector_patterns_reference(dists, pats, s)
    _close(val, pv)
    d = dists.to(torch.bfloat16).float()
    err_of = d.gather(2, pats[best.cpu().long()].long()[..., None])[..., 0].sum(-1)
    differ = best.cpu() != pb
    assert torch.all((err_of - pv).abs()[differ] <= RTOL * pv.abs()[differ])
    assert ck.LAUNCHES["find_best_selector_patterns"] == 1


@pytest.mark.cuda
def test_compress_on_card_launches_each_kernel(cuda):
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.checks import etc1s_psnr
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    from basis_universal_tpu_torch.codecs.etc1s import frontend

    img, _ = synthetic_texture(64, 64, seed=3)
    params = compressor.CompressorParams(device="cuda")
    out = compressor.compress(img, params)
    knobs, _, _ = frontend._knobs_and_neighbors(
        256, compressor._frontend_params(params, 256), None)
    refine, sel = knobs["refine_iters"], knobs["sel_iters"]
    # encode_blocks scans and rescores once; each refine pass scans once and
    # rescores twice; each selector iteration and the final pass search once
    assert ck.LAUNCHES == {"factorized_scan": 1 + refine,
                           "palette_errs_packed": 1 + 2 * refine,
                           "palette_errs": 0,
                           "find_best_selector_patterns": sel + 1}
    cpu = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    assert abs(etc1s_psnr(out.basis_data, img)
               - etc1s_psnr(cpu.basis_data, img)) <= 0.1
    # deterministic segment sums: the card gives the same file every time
    assert compressor.compress(img, params).basis_data == out.basis_data


@pytest.mark.cuda
def test_uastc_compress_on_card(cuda):
    from basis_universal_tpu.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.checks import uastc_psnr
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    imgs = [synthetic_texture(64, 64, seed=s, alpha=s == 1)[0] for s in (0, 1)]
    kw = dict(tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2)
    outs = compressor.compress_batch(imgs, compressor.CompressorParams(
        device="cuda", **kw))
    # one ETC1 hint per image: one scan (radius 0) and one rescore (K 8)
    assert ck.LAUNCHES["factorized_scan"] == 2
    assert ck.LAUNCHES["palette_errs_packed"] == 2
    for img, out in zip(imgs, outs):
        cpu = compressor.compress(img, compressor.CompressorParams(
            device="cpu", **kw))
        assert abs(uastc_psnr(out.basis_data, img)
                   - uastc_psnr(cpu.basis_data, img)) <= 0.05
        assert len(out.basis_data) == len(cpu.basis_data)
        again = compressor.compress(img, compressor.CompressorParams(
            device="cuda", **kw))
        assert again.basis_data == out.basis_data
