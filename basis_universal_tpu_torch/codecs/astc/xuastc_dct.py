"""Copy of `basis_universal_tpu/codecs/astc/xuastc_dct.py`.

XUASTC weight-grid DCT decode (IDCT + adaptive quantization).

Parity: grid_weight_dct (transcoder/basisu_transcoder_internal.h:1860,
basisu_transcoder.cpp:26875-27355) and the orthonormal DCT-III transforms of
transcoder/basisu_idct.h. The unrolled per-size reference transforms are
plain orthonormal cosine bases — here they are float32 numpy matrices (the
reference's own debug build checks its fast path against a naive variant at
1.25e-3 tolerance, so the transform is specified mathematically, not
bit-wise).
"""

import functools
import math

import numpy as np

from . import xuastc_tables as XT

DEADZONE_ALPHA = 0.5
SCALED_WEIGHT_BASE_CODING_SCALE = 0.5
DCT_RUN_LEN_EOB_SYM_INDEX = 64
DCT_MEAN_LEVELS0 = 9
DCT_MEAN_LEVELS1 = 33

# JPEG baseline luma quant matrix with a modified DC entry
# (basisu_transcoder.cpp:26933)
BASELINE_JPEG_Y = np.array([
    [4, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

# scale_quant_steps(levels) results (basisu_transcoder.cpp:27164)
SCALE_QUANT_STEPS = [1.51333141, 1.41198814, 1.35588217, 1.31743157,
                     1.28835952, 1.24573100, 1.21481407, 1.19067919,
                     1.15431654, 1.12734985, 1.10601568, 1.07348967]


@functools.lru_cache(maxsize=None)
def zigzag_order(width: int, height: int):
    """Diagonal zigzag scan with alternating direction
    (generate_zigzag_order, basisu_transcoder.cpp:26875)."""
    order = []
    for s in range(width + height - 1):
        x_start = 0 if s < height else s - height + 1
        x_end = s if s < width else width - 1
        diag = [x + (s - x) * width for x in range(x_start, x_end + 1)]
        order.extend(reversed(diag) if (s & 1) else diag)
    return order


@functools.lru_cache(maxsize=None)
def _idct_matrix(n: int) -> np.ndarray:
    """M[k, x] = alpha(k) cos(pi (2x+1) k / 2n) — the reference's exact
    float32 literals (extracted from basisu_idct.h; they carry codegen
    rounding noise, so recomputing via cos() drifts by ulps and flips
    weights on .5 boundaries)."""
    import pathlib

    data = np.load(pathlib.Path(__file__).with_name("xuastc_idct.npz"))
    return data[str(n)]


def idct2(coeffs: np.ndarray) -> np.ndarray:
    """(gh, gw) DCT coefficients → spatial samples.

    Matches idct_2d (basisu_transcoder.cpp:26477) to the last float32
    rounding: columns first then rows, accumulating in k-order."""
    gh, gw = coeffs.shape
    src = coeffs.astype(np.float32)
    mc = _idct_matrix(gh)
    tmp = np.zeros((gh, gw), dtype=np.float32)
    for k in range(gh):
        tmp += mc[k][:, None] * src[k][None, :]
    mr = _idct_matrix(gw)
    out = np.zeros((gh, gw), dtype=np.float32)
    for v in range(gw):
        out += tmp[:, v][:, None] * mr[v][None, :]
    return out


def get_num_weight_dc_levels(weight_ise_range: int) -> int:
    scale = SCALED_WEIGHT_BASE_CODING_SCALE
    if weight_ise_range <= 5:       # BISE_8_LEVELS
        scale = 1.0 / 8.0
    return int(64.0 * scale) + 1


def compute_level_scale(q: float, span_len: float,
                        weight_ise_range: int) -> np.float32:
    # float32 throughout: the level scale feeds integer quant steps, and a
    # float64 intermediate can flip a step by one vs the reference
    f = np.float32
    q = min(max(f(q), f(1.0)), f(100.0))
    if q < f(50.0):
        level_scale = f(5000.0) / q
    else:
        level_scale = f(200.0) - f(2.0) * q
    level_scale = level_scale * f(1.0 / 100.0)
    adaptive = f(64.0) / max(f(span_len), f(14.0))
    adaptive = adaptive * f(SCALE_QUANT_STEPS[weight_ise_range])
    return f(level_scale * adaptive)


def sample_quant(q: float, level_scale: float, bw: int, bh: int,
                 x: int, y: int) -> int:
    if q >= 100.0:
        return 1
    sx = np.float32(8.0 / bw)
    sy = np.float32(8.0 / bh)
    rx = min(np.float32(x) * sx, np.float32(7.0))
    ry = min(np.float32(y) * sy, np.float32(7.0))
    i0, j0 = int(rx), int(ry)
    i1, j1 = min(i0 + 1, 7), min(j0 + 1, 7)
    ti = rx - np.float32(i0)
    tj = ry - np.float32(j0)
    a = (1 - ti) * BASELINE_JPEG_Y[j0][i0] + ti * BASELINE_JPEG_Y[j0][i1]
    b = (1 - ti) * BASELINE_JPEG_Y[j1][i0] + ti * BASELINE_JPEG_Y[j1][i1]
    base = (1 - tj) * a + tj * b
    return max(1, int(np.float32(base) * np.float32(level_scale)
                      + np.float32(0.5)))


def dequant_deadzone(qv: int, L: int, alpha: float, x: int, y: int) -> float:
    if (x == 1 and y == 0) or (x == 0 and y == 1):
        return float(qv) * float(L)
    if qv == 0 or L <= 0:
        return 0.0
    tau = alpha * float(L)
    mag = tau + float(abs(qv)) * float(L)
    return -mag if qv < 0 else mag


def get_max_span_len(blk, cems_mod) -> float:
    """AQ span length (grid_weight_dct::get_max_span_len) for plane 0/1.

    blk: object with cems, endpoints, endpoint_ise_range, num_partitions,
    dual_plane, ccs. Returns (span_plane0, span_plane1)."""
    f = np.float32
    cem = blk.cems[0]
    if blk.dual_plane:
        l, h = cems_mod.decode_endpoints(cem, blk.endpoints,
                                         blk.endpoint_ise_range)
        s_other = f(0.0)
        s_sel = f(0.0)
        for c in range(4):
            d = (f(h[c]) - f(l[c])) * (f(h[c]) - f(l[c]))
            if c == blk.ccs:
                s_sel = s_sel + d
            else:
                s_other = s_other + d
        return f(math.sqrt(s_other)), f(math.sqrt(s_sel))
    nvals = XT.cem_num_values(cem)
    span = f(0.0)
    for p in range(blk.num_partitions):
        l, h = cems_mod.decode_endpoints(
            cem, blk.endpoints[nvals * p:nvals * (p + 1)],
            blk.endpoint_ise_range)
        acc = f(0.0)
        for c in range(4):
            acc = acc + (f(h[c]) - f(l[c])) * (f(h[c]) - f(l[c]))
        span = max(span, f(math.sqrt(acc)))
    return span, span


def quantize_deadzone(d: float, L: int, alpha: float, x: int, y: int) -> int:
    """Inverse of dequant_deadzone (grid_weight_dct::quantize_deadzone,
    transcoder/basisu_transcoder_internal.h:1920): mid-tread for the two
    lowest-frequency ACs, dead-zone + mid-tread elsewhere."""
    if (x == 1 and y == 0) or (x == 0 and y == 1):
        # round-half-away-from-zero (std::round semantics)
        r = d / float(L)
        return int(math.floor(r + 0.5)) if r >= 0 else int(math.ceil(r - 0.5))
    if L <= 0:
        return 0
    s = abs(float(d))
    tau = alpha * float(L)
    if s <= tau:
        return 0
    qv = int(math.floor((s - tau) / float(L) + 0.5))
    return -qv if d < 0.0 else qv


def fdct2(spatial: np.ndarray) -> np.ndarray:
    """(gh, gw) spatial samples → DCT coefficients. Exact inverse pair of
    idct2 (the stored bases are orthonormal: forward = M @ x per axis;
    dct2f::forward, transcoder/basisu_idct.h). Encode-side float drift only
    shifts quant decisions — the decoder reconstructs from the emitted
    integer syms, so conformance is unaffected."""
    gh, gw = spatial.shape
    src = spatial.astype(np.float32)
    mc = _idct_matrix(gh)           # (gh, gh): spatial = mc.T @ coeffs
    tmp = mc @ src                  # columns
    mr = _idct_matrix(gw)
    return tmp @ mr.T               # rows


def code_block_weights(q: float, plane_index: int, blk,
                       block_width: int, block_height: int,
                       span_len: float):
    """Forward path of the weight-grid DCT (code_block_weights,
    encoder/basisu_astc_ldr_encode.cpp:282): dequantize the plane's ISE
    weights to 0..64, mean-subtract, forward-DCT, dead-zone quantize with
    the adaptive table, zigzag-RLE. Returns (dc_sym, num_dc_levels, coeffs)
    with coeffs = [(num_zeros, coeff), ...] and a trailing (n, None) EOB
    entry when trailing zeros remain."""
    f = np.float32
    gw, gh = blk.grid_width, blk.grid_height
    total = gw * gh
    num_planes = 2 if blk.dual_plane else 1
    wtab = XT.weight_tab(blk.weight_ise_range)

    vals = np.array([float(wtab.ise_to_val[
        blk.weights[i * num_planes + plane_index]]) for i in range(total)],
        dtype=np.float32)

    scale = SCALED_WEIGHT_BASE_CODING_SCALE
    if blk.weight_ise_range <= 5:       # BISE_8_LEVELS
        scale = 1.0 / 8.0
    mean = f(vals.sum()) / f(total)
    # std::round = half away from zero (mean >= 0 here)
    scaled_mean = float(np.floor(f(scale) * mean + f(0.5)))
    scaled_mean = min(max(scaled_mean, 0.0), 64.0 * scale)
    mean_weight = f(scaled_mean) / f(scale)

    dct = fdct2((vals - mean_weight).reshape(gh, gw)).reshape(-1)

    level_scale = compute_level_scale(q, span_len, blk.weight_ise_range)
    coeffs_q = np.zeros(total, dtype=np.int64)
    for i in range(1, total):
        y, x = i // gw, i % gw
        L = sample_quant(q, level_scale, block_width, block_height, x, y)
        coeffs_q[i] = quantize_deadzone(float(dct[i]), L, DEADZONE_ALPHA,
                                        x, y)

    zz = zigzag_order(gw, gh)
    coeffs = []
    total_zeros = 0
    max_mag = 0
    for i in range(total):
        di = zz[i]
        if di == 0:
            continue
        c = int(coeffs_q[di])
        if c == 0:
            total_zeros += 1
            continue
        coeffs.append((total_zeros, c))
        max_mag = max(max_mag, abs(c))
        total_zeros = 0
    if total_zeros:
        coeffs.append((total_zeros, None))      # EOB
    num_dc_levels = get_num_weight_dc_levels(blk.weight_ise_range)
    return int(scaled_mean), num_dc_levels, coeffs, max_mag


def decode_block_weights_from_syms(q: float, plane_index: int, blk,
                                   block_width: int, block_height: int,
                                   dc_sym: int, coeffs, span_len: float):
    """IDCT path of grid_weight_dct::decode_block_weights (dct_syms input,
    i.e. the full-zstd syntax). Writes ISE weight symbols into blk.weights
    for the given plane. coeffs: list of (num_zeros, coeff)."""
    gw, gh = blk.grid_width, blk.grid_height
    total = gw * gh
    num_planes = 2 if blk.dual_plane else 1
    wtab = XT.weight_tab(blk.weight_ise_range).val_to_ise

    level_scale = compute_level_scale(q, span_len, blk.weight_ise_range)
    scale = SCALED_WEIGHT_BASE_CODING_SCALE
    if blk.weight_ise_range <= 5:
        scale = 1.0 / 8.0
    mean_weight = np.float32(dc_sym) / np.float32(scale)

    zz = zigzag_order(gw, gh)
    dct = np.zeros(total, dtype=np.float32)
    zig_idx = 1
    for run_len, coeff in coeffs:
        if run_len + zig_idx > total:
            raise ValueError("XUASTC DCT run overflow")
        zig_idx += run_len
        if zig_idx >= total:
            break
        di = zz[zig_idx]
        y, x = di // gw, di % gw
        quant = sample_quant(q, level_scale, block_width, block_height, x, y)
        dct[di] = dequant_deadzone(coeff, quant, DEADZONE_ALPHA, x, y)
        zig_idx += 1

    idct = idct2(dct.reshape(gh, gw)).reshape(-1)
    for i in range(total):
        x = float(mean_weight + idct[i])
        # fast_roundf_int: round half away from zero (transcoder.cpp:23977)
        v = int(x + 0.5) if x >= 0.0 else int(x - 0.5)
        blk.weights[i * num_planes + plane_index] = int(
            wtab[min(max(v, 0), 64)])
