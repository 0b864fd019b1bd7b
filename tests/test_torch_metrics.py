"""The port's `ops/metrics.py` against the reference's: every function on
the same numpy-seeded inputs (relative tolerance 1e-5; SSIM and PSNR-HVS-M
at 64x64 and at a size not divisible by 8), and the cases of
`tests/test_metrics.py` re-run on the port."""

import numpy as np
import pytest
import torch

from basis_universal_tpu.ops import metrics as ref
from basis_universal_tpu_torch.ops import metrics

RTOL = 1e-5


def _pair(shape, seed, spread=12):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-spread, spread + 1, shape),
                0, 255).astype(np.uint8)
    return a, b


def _hdr_pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 80, shape).astype(np.float32)
    b = np.abs(a + rng.normal(0, 0.5, shape).astype(np.float32))
    return a, b


@pytest.mark.parametrize("shape", [(64, 64, 3), (50, 38, 3), (64, 64, 4),
                                   (41, 67)])
@pytest.mark.parametrize("name", ["psnr", "ssim", "psnr_hvs_m"])
def test_scalar_metrics_match_the_reference(name, shape):
    if name != "psnr" and len(shape) == 3 and shape[-1] == 4:
        shape = shape[:2] + (3,)
    a, b = _pair(shape, seed=len(shape) * 7 + shape[0])
    mine = getattr(metrics, name)(a, b, device="cpu")
    theirs = float(getattr(ref, name)(a, b))
    assert isinstance(mine, float)
    np.testing.assert_allclose(mine, theirs, rtol=RTOL)


@pytest.mark.parametrize("name", ["luma_601", "luma_709"])
def test_lumas_match_the_reference(name):
    a, _ = _pair((33, 21, 3), seed=5)
    mine = getattr(metrics, name)(a, device="cpu")
    assert isinstance(mine, np.ndarray) and mine.dtype == np.float32
    np.testing.assert_allclose(mine, np.asarray(getattr(ref, name)(a)),
                               rtol=RTOL)


@pytest.mark.parametrize("channels", [3, 4])
def test_image_metrics_match_the_reference(channels):
    a, b = _pair((50, 38, channels), seed=channels)
    mine = metrics.image_metrics(a, b, device="cpu")
    theirs = ref.image_metrics(a, b)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert isinstance(mine[k], float)
        np.testing.assert_allclose(mine[k], float(v), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("rec2020", [False, True])
def test_hdr_functions_match_the_reference(rec2020):
    a, b = _hdr_pair((30, 22, 3), seed=9)
    np.testing.assert_allclose(metrics.pq_oetf(a, device="cpu"),
                               np.asarray(ref.pq_oetf(a)), rtol=RTOL)
    # T and P are differences of PQ values near 0.5 that nearly cancel: the
    # absolute tolerance is 1e-4 of that scale
    np.testing.assert_allclose(
        metrics.linear_rgb_to_itp(a, rec2020, device="cpu"),
        np.asarray(ref.linear_rgb_to_itp(a, rec2020)), rtol=RTOL, atol=5e-5)
    # Delta-E is 720 times a distance between ITP triples, so it carries
    # 720 times their absolute tolerance (float32 `pow` with the PQ exponent
    # 78.8 differs between the two libraries in the last bits)
    de_tol = 720.0 * 5e-5
    de_ref = np.asarray(ref.delta_e_itp(a, b, rec2020))
    de = metrics.delta_e_itp(a, b, rec2020, device="cpu")
    np.testing.assert_allclose(de, de_ref, rtol=RTOL, atol=de_tol)
    mine = metrics.hdr_image_metrics(a, b, rec2020, device="cpu")
    theirs = ref.hdr_image_metrics(a, b, rec2020)
    assert set(mine) == set(theirs)
    for k in ("rgb_psnr", "log2_rgb_psnr", "half_rgb_psnr"):
        assert mine[k] == theirs[k], k                  # host float64, same code
    for k in ("mean_delta_itp", "max_delta_itp"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=RTOL,
                                   atol=de_tol, err_msg=k)


def test_tensors_are_accepted():
    a, b = _pair((40, 40, 3), seed=1)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert metrics.psnr(ta, tb, device="cpu") == metrics.psnr(a, b,
                                                              device="cpu")
    assert metrics.ssim(ta, tb, device="cpu") == metrics.ssim(a, b,
                                                              device="cpu")
    assert metrics.hdr_image_metrics(ta.float(), tb.float(), device="cpu") == \
        metrics.hdr_image_metrics(a, b, device="cpu")


def test_an_absent_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _pair((16, 16, 3), seed=2)
    for fn in (metrics.psnr, metrics.ssim, metrics.psnr_hvs_m,
               metrics.image_metrics, metrics.hdr_image_metrics,
               metrics.delta_e_itp):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(a, b)                                    # device defaults to cuda


def _case_psnr_identity_and_known():
    a = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    assert metrics.psnr(a, a, device="cpu") == 99.0
    b = a.astype(np.int32).copy()
    b[0, 0, 0] += 10
    p = metrics.psnr(a, np.clip(b, 0, 255), device="cpu")
    mse = 100.0 / (64 * 64 * 3)
    assert abs(p - 10 * np.log10(255 ** 2 / mse)) < 1e-3


def _case_ssim_bounds():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    assert metrics.ssim(a, a, device="cpu") > 0.999
    noise = np.clip(a.astype(np.int32) + rng.integers(-20, 20, a.shape), 0, 255)
    s = metrics.ssim(a, noise.astype(np.uint8), device="cpu")
    assert 0.0 < s < 0.999


def _case_psnr_hvs_m_ordering():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    small = np.clip(a.astype(np.int32) + rng.integers(-2, 3, a.shape),
                    0, 255).astype(np.uint8)
    big = np.clip(a.astype(np.int32) + rng.integers(-25, 26, a.shape),
                  0, 255).astype(np.uint8)
    assert metrics.psnr_hvs_m(a, small, device="cpu") > \
        metrics.psnr_hvs_m(a, big, device="cpu")
    assert metrics.psnr_hvs_m(a, a, device="cpu") == 99.0


def _case_image_metrics_dict():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-5, 6, a.shape),
                0, 255).astype(np.uint8)
    m = metrics.image_metrics(a, b, device="cpu")
    assert set(m) == {"rgb_psnr", "y601_psnr", "y709_psnr", "a_psnr",
                      "rgba_psnr"}
    for v in m.values():
        assert 20.0 < v <= 99.0


def _case_hdr_image_metrics():
    a, b = _hdr_pair((32, 32, 3), seed=0)
    m = metrics.hdr_image_metrics(a, b, device="cpu")
    for k in ("rgb_psnr", "log2_rgb_psnr", "half_rgb_psnr",
              "mean_delta_itp", "max_delta_itp"):
        assert k in m
    assert 0 < m["rgb_psnr"] < 1000
    assert m["mean_delta_itp"] > 0
    ident = metrics.hdr_image_metrics(a, a, device="cpu")
    assert ident["rgb_psnr"] == 1000.0
    assert ident["max_delta_itp"] == 0.0


def _case_pq_itp_reference_points():
    # forwardPQ(100 nits) ~= 0.508 (BT.2100)
    pq = float(metrics.pq_oetf(100.0, device="cpu"))
    assert abs(pq - 0.5081) < 1e-3
    # neutral gray maps to Ct=Cp=0 (L=M=S in both gamut matrices)
    itp = metrics.linear_rgb_to_itp(np.array([5.0, 5.0, 5.0], np.float32),
                                    device="cpu")
    assert abs(itp[1]) < 1e-4 and abs(itp[2]) < 1e-4


@pytest.mark.parametrize("case", [
    _case_psnr_identity_and_known, _case_ssim_bounds,
    _case_psnr_hvs_m_ordering, _case_image_metrics_dict,
    _case_hdr_image_metrics, _case_pq_itp_reference_points],
    ids=lambda f: f.__name__[len("_case_"):])
def test_reference_metric_cases_on_the_port(case):
    case()
