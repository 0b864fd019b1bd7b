"""Image quality metrics as batched PyTorch ops on `device`.

Counterpart of `basis_universal_tpu/ops/metrics.py` (the reference's
image_metrics / psnr_hvs_metrics / SSIM, encoder/basisu_enc.h:3848, :3940;
basisu_ssim.cpp): per-channel and 601/709-luma PSNR, gaussian-window SSIM,
PSNR-HVS-M (8x8 DCT with CSF weighting and masking) and the HDR metrics.
Every function takes numpy arrays or tensors, computes in float32 on
`device` (default "cuda"; a CUDA device that is absent raises), and returns
a Python float for a scalar and a numpy array otherwise.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..codecs.etc1s.frontend import resolve_device
from .etc1s_encode import exact_matmuls


@contextlib.contextmanager
def _exact_convs():
    """float32 convolutions and matmuls inside run without TF32; the
    caller's settings are restored."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with exact_matmuls():
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _f32(x, device):
    """`x` (numpy, tensor or number) as a float32 tensor on `device`."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x), device=dev).to(torch.float32)


def _psnr(a, b, max_val: float = 255.0):
    mse = torch.mean((a - b) ** 2)
    return torch.where(mse > 0, 10.0 * torch.log10(max_val * max_val / mse),
                       torch.full_like(mse, 99.0))


def psnr(a, b, max_val: float = 255.0, device="cuda") -> float:
    return float(_psnr(_f32(a, device), _f32(b, device), max_val))


def _luma_601(rgb):
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def _luma_709(rgb):
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def luma_601(rgb, device="cuda") -> np.ndarray:
    return _luma_601(_f32(rgb, device)).cpu().numpy()


def luma_709(rgb, device="cuda") -> np.ndarray:
    return _luma_709(_f32(rgb, device)).cpu().numpy()


def image_metrics(a, b, device="cuda") -> dict:
    """Dict of PSNRs mirroring image_stats fields (basisu_comp.h:75-163)."""
    a = _f32(a, device)
    b = _f32(b, device)
    out = {
        "rgb_psnr": _psnr(a[..., :3], b[..., :3]),
        "y601_psnr": _psnr(_luma_601(a[..., :3]), _luma_601(b[..., :3])),
        "y709_psnr": _psnr(_luma_709(a[..., :3]), _luma_709(b[..., :3])),
    }
    if a.shape[-1] == 4 and b.shape[-1] == 4:
        out["a_psnr"] = _psnr(a[..., 3], b[..., 3])
        out["rgba_psnr"] = _psnr(a, b)
    # one device-to-host copy for the whole dict
    vals = torch.stack(list(out.values())).cpu().tolist()
    return dict(zip(out, vals))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def ssim(a, b, max_val: float = 255.0, device="cuda") -> float:
    """Mean SSIM over a gaussian 11x11 window (single channel or 601 luma
    of an RGB image)."""
    a = _f32(a, device)
    b = _f32(b, device)
    if a.ndim == 3:
        a = _luma_601(a)
        b = _luma_601(b)
    win = torch.as_tensor(_gaussian_kernel(), device=a.device)[None, None]

    def filt(x):
        return F.conv2d(x[None, None], win)[0, 0]          # "VALID"

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    with _exact_convs():
        mu_a, mu_b = filt(a), filt(b)
        sa = filt(a * a) - mu_a * mu_a
        sb = filt(b * b) - mu_b * mu_b
        sab = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2))
    return float(torch.mean(s))


# --- PSNR-HVS-M -------------------------------------------------------------
# 8x8 DCT CSF weights (Nill/PSNR-HVS-M standard table)
_CSF = np.array([
    [1.6084, 2.3396, 2.5735, 1.6084, 1.0723, 0.6434, 0.5046, 0.4219],
    [2.1446, 2.1446, 1.8382, 1.3545, 0.9898, 0.4437, 0.4289, 0.4679],
    [1.8382, 1.9796, 1.6084, 1.0723, 0.6434, 0.4515, 0.3730, 0.4596],
    [1.8382, 1.5138, 1.1698, 0.8874, 0.5046, 0.2958, 0.3217, 0.4151],
    [1.4297, 1.1698, 0.6955, 0.4596, 0.3785, 0.2361, 0.2499, 0.3344],
    [1.0723, 0.7353, 0.4679, 0.3973, 0.3217, 0.2778, 0.2505, 0.3344],
    [0.5252, 0.3973, 0.3217, 0.2778, 0.2499, 0.2209, 0.2261, 0.2744],
    [0.3570, 0.3344, 0.2744, 0.2499, 0.2261, 0.2113, 0.2140, 0.2170],
], dtype=np.float32)

_MASK = _CSF * 0.7


def _dct_matrix(n=8):
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def psnr_hvs_m(a, b, device="cuda") -> float:
    """PSNR-HVS-M on the 601 luma (DCT-domain CSF weighting with contrast
    masking), the metric family of psnr_hvs_metrics
    (encoder/basisu_enc.h:3940)."""
    a = _f32(a, device)
    b = _f32(b, device)
    if a.ndim == 3:
        a = _luma_601(a)
        b = _luma_601(b)
    h, w = a.shape
    h8, w8 = h - h % 8, w - w % 8
    a = a[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).permute(0, 2, 1, 3)
    b = b[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).permute(0, 2, 1, 3)
    d = torch.as_tensor(_dct_matrix(), device=a.device)
    with exact_matmuls():
        A = torch.einsum("ij,nmjk,lk->nmil", d, a, d)
        B = torch.einsum("ij,nmjk,lk->nmil", d, b, d)
    csf = torch.as_tensor(_CSF, device=a.device)
    mask_w = torch.as_tensor(_MASK, device=a.device)
    # masking energy per block from the reference (masked) image
    e_a = torch.sum((A * mask_w) ** 2, dim=(-1, -2)) - (A[..., 0, 0] * mask_w[0, 0]) ** 2
    e_b = torch.sum((B * mask_w) ** 2, dim=(-1, -2)) - (B[..., 0, 0] * mask_w[0, 0]) ** 2
    m = torch.sqrt(torch.minimum(e_a, e_b) / 64.0)[..., None, None]
    diff = torch.abs(A - B)
    masked = torch.clamp(diff - m / torch.clamp(csf, min=1e-6), min=0.0)
    # DC and near-DC terms are not masked
    masked[..., 0, 0] = diff[..., 0, 0]
    werr = (masked * csf) ** 2
    mse = torch.mean(werr)
    return float(torch.where(mse > 0, 10.0 * torch.log10(255.0 ** 2 / mse),
                             torch.full_like(mse, 99.0)))


# --- HDR metrics -------------------------------------------------------------
# float-space, log2, half-float-space PSNRs (image_metrics::calc(imagef,log)
# and ::calc_half, encoder/basisu_enc.cpp:1917-2090) and Delta-E ITP
# (BT.2100 ICtCp with the ITP Ct*0.5 scaling, the 6x6 HDR encoder's internal
# error space, encoder/basisu_astc_hdr_6x6_enc.cpp:143-317).

# ITU-R BT.2100-2 PQ constants
_PQ_M1 = 0.1593017578125     # (2610 / 2^14) / 100
_PQ_M2 = 78.84375            # 2523 / 4096 * 128
_PQ_C1 = 0.8359375           # 3424 / 2^12
_PQ_C2 = 18.8515625          # 2413 / 128
_PQ_C3 = 18.6875             # 2392 / 128

# REC2020_to_LMS * REC709_to_2020 (reference basisu_astc_hdr_6x6_enc.cpp:287)
_REC709_TO_LMS = np.array([
    [0.2958097, 0.6230863, 0.0811040],
    [0.1562512, 0.7272980, 0.1164508],
    [0.0351435, 0.1565601, 0.8082964]], np.float32)
# BT.2100 spec matrix (rec2020/bt2100 gamut inputs)
_REC2020_TO_LMS = np.array([
    [0.412109375, 0.52392578125, 0.06396484375],
    [0.166748046875, 0.720458984375, 0.11279296875],
    [0.024169921875, 0.075439453125, 0.900390625]], np.float32)
# L'M'S' -> I (T = 0.5*Ct) P, ITP variant
_LMS_TO_ITP = np.array([
    [0.5, 0.5, 0.0],
    [0.806884765625, -1.6617431640625, 0.8548583984375],
    [4.378173828125, -4.24560546875, -0.132568359375]], np.float32)


def _pq_oetf(y):
    L = torch.clamp(y, min=0.0) * (1.0 / 10000.0)
    num = L ** _PQ_M1
    return ((_PQ_C1 + _PQ_C2 * num) / (1.0 + _PQ_C3 * num)) ** _PQ_M2


def pq_oetf(y, device="cuda") -> np.ndarray:
    """Linear absolute luminance (nits-scaled: 1.0 == 100 nits x 100) -> PQ."""
    return _pq_oetf(_f32(y, device)).cpu().numpy()


def _linear_rgb_to_itp(rgb, rec2020: bool):
    m = torch.as_tensor(_REC2020_TO_LMS if rec2020 else _REC709_TO_LMS,
                        device=rgb.device)
    itp = torch.as_tensor(_LMS_TO_ITP, device=rgb.device)
    with exact_matmuls():
        lms = torch.einsum("...c,kc->...k", rgb, m)
        return torch.einsum("...c,kc->...k", _pq_oetf(lms), itp)


def linear_rgb_to_itp(rgb, rec2020: bool = False, device="cuda") -> np.ndarray:
    """(..., 3) linear RGB -> ITP (I, T, P); REC709 gamut unless rec2020."""
    return _linear_rgb_to_itp(_f32(rgb, device), rec2020).cpu().numpy()


def _delta_e_itp(a, b, rec2020: bool):
    ia = _linear_rgb_to_itp(a, rec2020)
    ib = _linear_rgb_to_itp(b, rec2020)
    return 720.0 * torch.sqrt(torch.sum((ia - ib) ** 2, dim=-1))


def delta_e_itp(a, b, rec2020: bool = False, device="cuda") -> np.ndarray:
    """Per-pixel Delta-E ITP (BT.2124: 720 * euclidean ITP distance)."""
    return _delta_e_itp(_f32(a, device), _f32(b, device),
                        rec2020).cpu().numpy()


def hdr_image_metrics(a, b, rec2020: bool = False, device="cuda") -> dict:
    """Dict of HDR metrics for (H, W, 3+) float32 linear images:
      rgb_psnr       float-space PSNR, max_val 1.0 (calc(imagef))
      log2_rgb_psnr  PSNR of log2(max(x,0)+1) deltas (calc(..., log=true))
      half_rgb_psnr  PSNR of half-float bit-pattern deltas, max 65535
                     (calc_half)
      mean/max_delta_itp  Delta-E ITP statistics (the 6x6 encoder's space)
    The three PSNRs are float64 sums on the host, as in the reference; the
    Delta-E runs on `device`.
    """
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    a = np.asarray(a, np.float32)[..., :3]
    b = np.asarray(b, np.float32)[..., :3]
    d = a - b
    rms = float(np.sqrt(np.mean(np.float64(d) ** 2)))
    log2d = np.log2(np.maximum(a, 0) + 1.0) - np.log2(np.maximum(b, 0) + 1.0)
    log2_rms = float(np.sqrt(np.mean(np.float64(log2d) ** 2)))
    ha = a.astype(np.float16).view(np.uint16).astype(np.int64)
    hb = b.astype(np.float16).view(np.uint16).astype(np.int64)
    half_rms = float(np.sqrt(np.mean(np.float64(np.abs(ha - hb)) ** 2)))

    def _psnr_of(r, max_val):
        if r == 0:
            return 1000.0
        return float(np.clip(np.log10(max_val / r) * 20.0, 0.0, 1000.0))

    de = _delta_e_itp(_f32(a, device), _f32(b, device), rec2020)
    mean_de, max_de = torch.stack([de.mean(), de.max()]).cpu().tolist()
    return {
        "rgb_psnr": _psnr_of(rms, 1.0),
        "log2_rgb_psnr": _psnr_of(log2_rms, 1.0),
        "half_rgb_psnr": _psnr_of(half_rms, 65535.0),
        "mean_delta_itp": mean_de,
        "max_delta_itp": max_de,
    }
