"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card (marked `cuda`; each test skips where there is none). This file
imports no jax; `tests/conftest.py` does, so where jax is not installed run
it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances are those of `test_torch_kernels.py`: floats rtol 1e-5, the
scan's plus 1e-6 of `checks.scan_term_magnitude` (the terms its formula
cancels); indices equal except at ties.
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


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
def test_palette_errs_packed_on_card(cuda, perceptual):
    rng = np.random.default_rng(7)
    px = _blocks(B, 43)
    c5 = rng.integers(0, 32, (B, 16, 3))
    packed = torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
                             | (rng.integers(0, 8, (B, 16)) << 15),
                             dtype=torch.int32)
    got = ck.palette_errs_packed(px.to(cuda), packed.to(cuda), perceptual)
    _close(got, ck.palette_errs_packed_reference(px, packed, perceptual))
    assert ck.LAUNCHES["palette_errs_packed"] == 1


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
                           "find_best_selector_patterns": sel + 1}
    cpu = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    assert abs(etc1s_psnr(out.basis_data, img)
               - etc1s_psnr(cpu.basis_data, img)) <= 0.1
