"""Copy of `basis_universal_tpu/ops/resample.py`.

Mipmap generation / image resampling as batched array ops.

Replaces the reference's separable polyphase resampler
(encoder/basisu_resampler.cpp, filters in basisu_resample_filters.cpp:23-290).
True separable polyphase resampling (per-destination fractional
contribution tables, kernel stretched by the minification ratio, any
src/dst ratio incl. upsampling) with the reference's full filter bank and
optional sRGB-correct / premultiplied / wrapped filtering.
"""

import numpy as np

_SRGB_TO_LINEAR = None


def _srgb_to_linear_lut():
    global _SRGB_TO_LINEAR
    if _SRGB_TO_LINEAR is None:
        x = np.arange(256, dtype=np.float64) / 255.0
        lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
        _SRGB_TO_LINEAR = lin.astype(np.float32)
    return _SRGB_TO_LINEAR


def _linear_to_srgb(x):
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


# --- filter bank -------------------------------------------------------------
# Continuous kernels + supports mirroring the reference's filter table
# (encoder/basisu_resample_filters.cpp:309-326; standard textbook filters:
# Mitchell-Netravali, Dodgson quadratics, windowed sincs).

def _blackman_exact(x):
    return (0.42659071 + 0.49656062 * np.cos(np.pi * x)
            + 0.07684867 * np.cos(2.0 * np.pi * x))


def _mitchell(t, B, C):
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    inner = ((12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2
             + (6 - 2 * B)) / 6.0
    outer = ((-B - 6 * C) * t3 + (6 * B + 30 * C) * t2
             + (-12 * B - 48 * C) * t + (8 * B + 24 * C)) / 6.0
    return np.where(t < 1.0, inner, np.where(t < 2.0, outer, 0.0))


def _bell(t):
    t = np.abs(t)
    return np.where(t < 0.5, 0.75 - t * t,
                    np.where(t < 1.5, 0.5 * (t - 1.5) ** 2, 0.0))


def _b_spline(t):
    t = np.abs(t)
    t2 = t * t
    return np.where(t < 1.0, 0.5 * t2 * t - t2 + 2.0 / 3.0,
                    np.where(t < 2.0, (2.0 - t) ** 3 / 6.0, 0.0))


def _quadratic(t, R):
    t = np.abs(t)
    t2 = t * t
    return np.where(
        t <= 0.5, -2.0 * R * t2 + 0.5 * (R + 1.0),
        np.where(t < 1.5, R * t2 + (-2.0 * R - 0.5) * t + 0.75 * (R + 1.0),
                 0.0))


def _lanczos(t, s):
    t = np.abs(t)
    return np.where(t < s, np.sinc(t) * np.sinc(t / s), 0.0)


def _gaussian(t):
    t = np.abs(t)
    return np.where(
        t < 1.25,
        np.exp(-2.0 * t * t) * np.sqrt(2.0 / np.pi) * _blackman_exact(t / 1.25),
        0.0)


def _kaiser_att40(t):
    att = 40.0
    alpha = np.exp(np.log(0.58417 * (att - 20.96)) * 0.4) \
        + 0.07886 * (att - 20.96)
    t = np.abs(t)
    ratio = np.clip(t / 3.0, 0.0, 1.0)
    k = np.i0(alpha * np.sqrt(1 - ratio * ratio)) / np.i0(alpha)
    return np.where(t < 3.0, np.sinc(t) * k, 0.0)


# name -> (kernel fn of t, support)
FILTERS = {
    "bell": (_bell, 1.5),
    "b-spline": (_b_spline, 2.0),
    "mitchell": (lambda t: _mitchell(t, 1.0 / 3.0, 1.0 / 3.0), 2.0),
    "catmullrom": (lambda t: _mitchell(t, 0.0, 0.5), 2.0),
    "quadratic_interp": (lambda t: _quadratic(t, 1.0), 1.5),
    "quadratic_approx": (lambda t: _quadratic(t, 0.5), 1.5),
    "quadratic_mix": (lambda t: _quadratic(t, 0.8), 1.5),
    "blackman": (lambda t: np.where(np.abs(t) < 3.0,
                                    np.sinc(t) * _blackman_exact(t / 3.0),
                                    0.0), 3.0),
    "lanczos3": (lambda t: _lanczos(t, 3.0), 3.0),
    "lanczos4": (lambda t: _lanczos(t, 4.0), 4.0),
    "lanczos6": (lambda t: _lanczos(t, 6.0), 6.0),
    "lanczos12": (lambda t: _lanczos(t, 12.0), 12.0),
    "gaussian": (_gaussian, 1.25),
    "kaiser_att40": (_kaiser_att40, 3.0),
}


def _filter_fn(name: str):
    """Continuous kernel + support for any filter name (legacy aliases
    included)."""
    if name == "box":
        return (lambda t: (np.abs(t) <= 0.5).astype(np.float64), 0.5)
    if name == "tent":
        return (lambda t: np.maximum(1.0 - np.abs(t), 0.0), 1.0)
    if name == "kaiser":
        return (_kaiser_att40, 3.0)
    if name in FILTERS:
        return FILTERS[name]
    raise ValueError(f"unknown filter {name}")


def _axis_contribs(n_src: int, n_dst: int, name: str, wrap: bool):
    """Polyphase contribution table for one axis: (src_idx (n_dst, taps),
    weights (n_dst, taps)). Mirrors Resampler::make_clist
    (encoder/basisu_resampler.cpp:76-230): per-destination fractional
    centers, kernel stretched by the downsample ratio, weights normalized;
    handles any src/dst ratio including upsampling."""
    fn, support = _filter_fn(name)
    xscale = n_dst / n_src
    stretch = max(1.0, 1.0 / xscale)        # widen kernel when minifying
    half = support * stretch
    centers = (np.arange(n_dst) + 0.5) / xscale - 0.5
    left = np.floor(centers - half).astype(np.int64)
    ntaps = int(np.ceil(2.0 * half)) + 2
    src = left[:, None] + np.arange(ntaps)[None, :]
    t = (centers[:, None] - src) / stretch
    w = np.asarray(fn(t), dtype=np.float64)
    s = w.sum(1, keepdims=True)
    w = np.where(s != 0.0, w / np.where(s == 0.0, 1.0, s), 0.0)
    src = src % n_src if wrap else np.clip(src, 0, n_src - 1)
    return src, w.astype(np.float32)


def _resample_axis(img: np.ndarray, axis: int, out_size: int, name: str,
                   wrap: bool = False):
    """Separable polyphase resample along one axis (down or up), edge-
    clamped or wrapped (the reference's m_mip_wrapping)."""
    n = img.shape[axis]
    if n == out_size:
        return img
    src, w = _axis_contribs(n, out_size, name, wrap)
    moved = np.moveaxis(img, axis, 0)
    gathered = moved[src]                       # (out, taps, ...)
    out = np.einsum("ot...,ot->o...", gathered, w)
    return np.moveaxis(out, 0, axis)


def resample(img: np.ndarray, out_w: int, out_h: int, filter: str = "kaiser",
             srgb: bool = True, premultiplied: bool = False,
             wrap: bool = False) -> np.ndarray:
    """Downsample an (H, W, C) uint8 image to (out_h, out_w, C).

    premultiplied filters RGB weighted by alpha and unweights after (the
    reference's m_mip_premultiplied / STBIR_FLAG_ALPHA_PREMULTIPLIED,
    basisu_comp.cpp:2187); wrap tiles the edges (m_mip_wrapping)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if srgb:
        f = _srgb_to_linear_lut()[img]
        if img.shape[-1] == 4:  # alpha filters linearly
            f[..., 3] = img[..., 3].astype(np.float32) / 255.0
    else:
        f = img.astype(np.float32) / 255.0
    if premultiplied and img.shape[-1] == 4:
        f[..., :3] *= f[..., 3:4]
    f = _resample_axis(f, 0, out_h, filter, wrap=wrap)
    f = _resample_axis(f, 1, out_w, filter, wrap=wrap)
    if premultiplied and img.shape[-1] == 4:
        f[..., :3] /= np.maximum(f[..., 3:4], 1e-6)
    if srgb:
        if img.shape[-1] == 4:
            a = f[..., 3]
            f = _linear_to_srgb(f)
            f[..., 3] = a
        else:
            f = _linear_to_srgb(f)
    return np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8)


def renormalize_normal_map(img: np.ndarray) -> np.ndarray:
    """Re-unit-length filtered normal-map texels (the reference's
    image::renormalize_normal_map, encoder/basisu_enc.h:3244-3283)."""
    img = np.asarray(img).copy()
    rgb = img[..., :3].astype(np.float32)
    v = np.clip(rgb * (2.0 / 255.0) - 1.0, -1.0, 1.0)
    length = np.sqrt((v * v).sum(-1, keepdims=True))
    thresh = 0.077
    degenerate = length[..., 0] < thresh
    off_unit = np.abs(length[..., 0] - 1.0) > thresh
    vn = v / np.maximum(length, 1e-12)
    renorm = np.clip(np.floor((vn + 1.0) * 255.0 * 0.5 + 0.5), 0, 255)
    out = rgb.copy()
    out[off_unit] = renorm[off_unit]
    out[degenerate] = 128.0
    # snap near-vertical normals' Z to the extremes (reference :3272-3278)
    flat = (out[..., 0] == 128) & (out[..., 1] == 128) & off_unit
    out[..., 2] = np.where(flat, np.where(out[..., 2] < 128, 0.0, 255.0),
                           out[..., 2])
    keep = (img[..., 0] == 128) & (img[..., 1] == 128) & (img[..., 2] == 128)
    out[keep] = 128.0
    img[..., :3] = out.astype(np.uint8)
    return img


def generate_mipmaps(img: np.ndarray, smallest_dimension: int = 1,
                     filter: str = "kaiser", srgb: bool = True,
                     premultiplied: bool = False, renormalize: bool = False,
                     wrap: bool = False):
    """Full mip chain below the base level (basis_compressor::generate_mipmaps,
    encoder/basisu_comp.cpp:2145-2232: filter/srgb/premultiplied/wrapping
    options plus per-level renormalize_normal_map)."""
    levels = []
    h, w = img.shape[:2]
    # reference loops while max(w,h) > smallest_dimension (basisu_comp.cpp:2155)
    while max(h, w) > smallest_dimension:
        h, w = max(1, h // 2), max(1, w // 2)
        lvl = resample(img, w, h, filter=filter, srgb=srgb,
                       premultiplied=premultiplied, wrap=wrap)
        if renormalize:
            lvl = renormalize_normal_map(lvl)
        levels.append(lvl)
        if h == 1 and w == 1:
            break
    return levels


def resample_hdr(img: np.ndarray, out_w: int, out_h: int,
                 filter: str = "kaiser") -> np.ndarray:
    """Downsample an (H, W, C) float32 linear-light image (HDR mip path:
    no sRGB transfer, no quantization)."""
    f = np.asarray(img, dtype=np.float32)
    f = _resample_axis(f, 0, out_h, filter)
    f = _resample_axis(f, 1, out_w, filter)
    return np.maximum(f, 0.0)


def generate_mipmaps_hdr(img: np.ndarray, smallest_dimension: int = 1,
                         filter: str = "kaiser"):
    levels = []
    h, w = img.shape[:2]
    while max(h, w) > smallest_dimension:
        h, w = max(1, h // 2), max(1, w // 2)
        levels.append(resample_hdr(img, w, h, filter=filter))
        if h == 1 and w == 1:
            break
    return levels
