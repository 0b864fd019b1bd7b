"""Copy of `basis_universal_tpu/codecs/bc7/xbc7_decode.py`.

XUBC7 decoder: latent-BC7 supercompression → logical BC7 blocks.

Integer-exact port of the reference's xbc7 decode path
(transcoder/basisu_xbc7_decoder.h + .inl):
  - Q15.16 fixed-point (basisu_transcoder_internal.h:3718 struct fixed) —
    Python ints make every op exact by construction
  - dct2fx fixed-point 4x4 orthonormal IDCT with integer-generated tables
  - blob container (0xB7 magic, varint directory, per-blob Zstd)
  - per-stripe decode: commands, configs, partitions, endpoint RAW/DPCM,
    the 50-candidate weight predictor bank with amplitude codes, and
    DCT / DPCM weight residuals

Stripes are independent (the format's parallel-decode axis) — decode_stripes
maps them across a thread pool, the stripe-parallel analog of the
reference's unpack_image_threaded.
"""

import dataclasses
import struct

import numpy as np

from . import logical as L

ONE = 1 << 16   # Q15.16


def _rounded_rshift(x: int, bits: int) -> int:
    half = 1 << (bits - 1)
    return (x + half) >> bits if x >= 0 else -(((-x) + half) >> bits)


def fx_from_sum(s: int) -> int:
    """int64 Q32 accumulator → Q15.16 raw."""
    return _rounded_rshift(s, 16)


def fx_mul(a: int, b: int) -> int:
    return _rounded_rshift(a * b, 16)


def fx_div(a: int, b: int) -> int:
    q = (a << 17) // b if (a >= 0) == (b > 0) else -((abs(a) << 17) // abs(b))
    return _rounded_rshift(q, 1)


def fx_round_to_int(v: int) -> int:
    return (v + (ONE >> 1)) >> 16 if v >= 0 else -(((-v) + (ONE >> 1)) >> 16)


def fx_mul_round_to_int(a: int, b: int) -> int:
    return _rounded_rshift(a * b, 32)


def _isqrt_floor(x: int) -> int:
    if x == 0:
        return 0
    import math

    r = math.isqrt(x)
    return r


def _isqrt_to_fixed(ssq: int) -> int:
    x = ssq << 32
    f = _isqrt_floor(x)
    if x - f * f > f:
        f += 1
    return f


# --- integer Q30 cosine / alpha tables (dct_detail) --------------------------

def _cos_pi_frac_q30(k: int, n: int) -> int:
    q30 = 1 << 30
    m = k % (2 * n)
    if m > n:
        m = 2 * n - m
    neg = False
    if 2 * m > n:
        m = n - m
        neg = True
    pi_q30 = 3373259426
    th = (pi_q30 * m) // n
    x2 = (th * th) >> 30
    r = q30
    for d in (182, 132, 90, 56, 30, 12, 2):
        r = q30 - ((x2 * r) >> 30) // d
    return -r if neg else r


def _alpha0_q30(n: int) -> int:
    return _isqrt_floor((1 << 60) // n)


def _alpha_q30(n: int) -> int:
    return _isqrt_floor((1 << 61) // n)


def _q60_to_q16(p: int) -> int:
    h = 1 << 43
    return (p + h) >> 44 if p >= 0 else -(((-p) + h) >> 44)


import functools


@functools.lru_cache(maxsize=None)
def _dct_table(n: int):
    """alpha(u)*cos table, Q15.16, [u][x]."""
    out = np.zeros((n, n), dtype=np.int64)
    for u in range(n):
        a = _alpha_q30(n) if u else _alpha0_q30(n)
        for x in range(n):
            c = _cos_pi_frac_q30((2 * x + 1) * u, 2 * n)
            out[u][x] = _q60_to_q16(a * c)
    return out


def _idct4x4(src):
    """Fixed-point 4x4 IDCT (dct2fx::inverse general path; the specialized
    butterflies are bit-identical by construction). src/dst: 16 Q15.16 ints
    row-major."""
    tab = _dct_table(4)
    work = [0] * 16
    for v in range(4):
        sums = [0, 0, 0, 0]
        for u in range(4):
            yu = src[u * 4 + v]
            if yu == 0:
                continue
            for x in range(4):
                sums[x] += yu * int(tab[u][x])
        for x in range(4):
            work[x * 4 + v] = fx_from_sum(sums[x])
    dst = [0] * 16
    for x in range(4):
        for y in range(4):
            acc = 0
            for v in range(4):
                acc += work[x * 4 + v] * int(tab[v][y])
            dst[x * 4 + y] = fx_from_sum(acc)
    return dst


# zigzag (g_zigzag4x4_xy)
ZIGZAG_XY = [(0, 0), (1, 0), (0, 1), (0, 2), (1, 1), (2, 0), (3, 0), (2, 1),
             (1, 2), (0, 3), (1, 3), (2, 2), (3, 1), (3, 2), (2, 3), (3, 3)]

# g_base_4x4_quant raw Q15.16 values
BASE_4X4_QUANT = [65536, 229376, 1572864, 3342336,
                  229376, 786432, 2621440, 5111808,
                  1572864, 2621440, 4456448, 6750208,
                  3342336, 5111808, 6750208, 7864320]

# g_scale_quant_steps_fixed raw
SCALE_QUANT_STEPS_FX = {2: 88859, 3: 81640, 4: 75649}
DEADZONE_ALPHA_FX = 32768


def _dc_quant(num_weight_bits: int) -> int:
    return 1 << (6 - num_weight_bits)


def _compute_quant_table(q_fx: int, level_scale_fx: int):
    tab = [1] * 16
    if q_fx >= 100 * ONE:
        return tab
    for y in range(4):
        for x in range(y if y else 1, 4):
            base = BASE_4X4_QUANT[x + y * 4]
            qs = max(1, fx_mul_round_to_int(base, level_scale_fx))
            if x + y == 1:
                qs = min(qs, 73)
            tab[x + y * 4] = qs
            tab[y + x * 4] = qs
    return tab


def _get_max_span_len(blk: L.LogBC7Block, plane: int) -> int:
    max_ssq = 0
    if blk.is_dual_plane():
        ep = L.unpack_endpoints(blk, 0)
        for c in range(4):
            pl = 1 - blk.mode4_index_selector if c == 3 \
                else blk.mode4_index_selector
            if pl == plane:
                d = ep[1][c] - ep[0][c]
                max_ssq += d * d
    else:
        for s in range(blk.num_partitions):
            ep = L.unpack_endpoints(blk, s)
            ssq = sum((ep[1][c] - ep[0][c]) ** 2 for c in range(4))
            max_ssq = max(max_ssq, ssq)
    return _isqrt_to_fixed(max_ssq)


def _compute_level_scale(q_fx: int, span_fx: int, num_weight_bits: int) -> int:
    q = min(max(q_fx, ONE), 100 * ONE)
    if q < 50 * ONE:
        ls = fx_div(5000 * ONE, q)
    else:
        ls = 200 * ONE - q * 2
    ls = _rounded_rshift(ls, 0) if False else ls
    # fixed operator/(int): round half away from zero
    ls = _fx_div_int(ls, 100)
    adaptive = fx_div(64 * ONE, max(span_fx, 14 * ONE))
    adaptive = fx_mul(adaptive, SCALE_QUANT_STEPS_FX[num_weight_bits])
    return fx_mul(ls, adaptive)


def _fx_div_int(v: int, s: int) -> int:
    half = s // 2 if s >= 0 else (-s) // 2
    neg = (v < 0) != (s < 0)
    q = (abs(v) + half) // abs(s)
    return -q if neg else q


def _dequant_deadzone(q: int, lvl: int, x: int, y: int) -> int:
    if (x == 1 and y == 0) or (x == 0 and y == 1):
        v = q * lvl * ONE
    else:
        if q == 0 or lvl <= 0:
            return 0
        mag = DEADZONE_ALPHA_FX * lvl + abs(q) * lvl * ONE
        v = -mag if q < 0 else mag
    lim = 2048 * ONE
    return min(max(v, -lim), lim)


def _fdct4x4(src):
    """Fixed-point 4x4 forward DCT (dct2fx::forward's 4x4 path — the dct4
    butterflies are bit-identical to this matrix product by construction,
    basisu_xbc7_decoder.h:100-133). src: 16 Q15.16 ints row-major."""
    tab = _dct_table(4)
    t = [0] * 16
    for x in range(4):                       # horizontal pass (row x)
        for u in range(4):
            acc = 0
            for k in range(4):
                acc += src[x * 4 + k] * int(tab[u][k])
            t[x * 4 + u] = fx_from_sum(acc)
    dst = [0] * 16
    for v in range(4):                       # vertical pass (column v)
        for u in range(4):
            acc = 0
            for k in range(4):
                acc += t[k * 4 + v] * int(tab[u][k])
            dst[u * 4 + v] = fx_from_sum(acc)
    return dst


def _quantize_deadzone(d: int, lvl: int, x: int, y: int) -> int:
    """xbc7_weight_grid_dct_fixed::quantize_deadzone (exact fixed-point)."""
    if (x == 1 and y == 0) or (x == 0 and y == 1):
        return fx_round_to_int(_fx_div_int(d, lvl))
    if lvl <= 0:
        return 0
    s = abs(d)
    tau = DEADZONE_ALPHA_FX * lvl            # alpha * L, Q15.16
    if s <= tau:
        return 0
    q = fx_round_to_int(_fx_div_int(s - tau, lvl))
    return -q if d < 0 else q


def dct_forward_weights(global_q: int, plane: int, preds,
                        blk: L.LogBC7Block):
    """xbc7_weight_grid_dct_fixed::forward — quantize the (weight − pred)
    grid; returns (dc_sym, ac_runs) in the exact symbol form
    dct_inverse_weights consumes ((run, 0x7FFF) = trailing-zeros marker)."""
    wb = blk.weight_bits[plane]
    span = _get_max_span_len(blk, plane)
    ls = _compute_level_scale(global_q, span, wb)
    quant_tab = _compute_quant_table(global_q, ls)

    src = [0] * 16
    for i in range(16):
        pred = preds[i] if preds is not None else 0
        src[i] = (L.dequant_weight(int(blk.weights[plane][i]), wb)
                  - pred) * ONE
    d = _fdct4x4(src)

    coeffs = [0] * 16
    dc = min(max(fx_round_to_int(d[0]), -255), 255)
    q = _dc_quant(wb)                        # uniform DC quantizer
    max_mag = 256 // q
    dc = (dc + q // 2) // q if dc >= 0 else -(((-dc) + q // 2) // q)
    coeffs[0] = min(max(dc, -max_mag), max_mag)
    for y in range(4):
        for x in range(4):
            if not x and not y:
                continue
            qz = _quantize_deadzone(d[x + y * 4], quant_tab[x + y * 4], x, y)
            coeffs[x + y * 4] = min(max(qz, -255), 255)

    ac = []
    zeros = 0
    for i in range(1, 16):
        x, y = ZIGZAG_XY[i]
        c = coeffs[x + y * 4]
        if not c:
            zeros += 1
            continue
        ac.append((zeros, c))
        zeros = 0
    if zeros:
        ac.append((zeros, 0x7FFF))
    return coeffs[0], ac


def dct_inverse_weights(global_q: int, plane: int, preds, syms_dc, syms_ac,
                        blk: L.LogBC7Block) -> bool:
    """xbc7_weight_grid_dct_fixed::inverse."""
    wb = blk.weight_bits[plane]
    span = _get_max_span_len(blk, plane)
    ls = _compute_level_scale(global_q, span, wb)
    quant_tab = _compute_quant_table(global_q, ls)

    dct = [0] * 16
    dct[0] = (syms_dc * _dc_quant(wb)) * ONE

    zig = 1
    for run_len, coeff in syms_ac:
        if run_len + zig > 16:
            return False
        zig += run_len
        if zig >= 16:
            break
        if coeff == 0x7FFF:
            return False
        x, y = ZIGZAG_XY[zig]
        di = x + y * 4
        dct[di] = _dequant_deadzone(coeff, quant_tab[di], x, y)
        zig += 1

    idct = _idct4x4(dct)
    for i in range(16):
        pred = preds[i] if preds is not None else 0
        v = fx_round_to_int(idct[i] + pred * ONE)
        blk.weights[plane][i] = L.quant_weight(min(max(v, 0), 64), wb)
    return True


# --- weight predictor bank (eval_weight_predictor) ---------------------------

CAND_ABSOLUTE = 0
CAND_LEFT_EDGE = 1
CAND_UPPER_EDGE = 2
CAND_LU_BLEND = 3
CAND_REFLECT_LEFT = 4
CAND_REFLECT_UPPER = 5
CAND_LU_AVG = 6
CAND_LU_BLEND_STRONG = 7
CAND_GRADIENT = 8
CAND_GRADIENT_DAMPED = 9
CAND_DIAG_AVG = 10
CAND_DIAG_EDGE_BLEND = 11
CAND_UPPER_DIAG_EDGE_BLEND = 12
CAND_MED = 13
CAND_GAB = 14
CAND_PLANE_FIT = 15
CAND_DDL = 16
CAND_DDR = 17
CAND_FIRST_XY_DELTA = 18
NUM_XY_DELTAS = 32
TOTAL_CANDIDATES = CAND_FIRST_XY_DELTA + NUM_XY_DELTAS

XY_DELTAS = [
    (-1, 0), (-2, 0), (-3, 0), (-4, 0),
    (3, -1), (2, -1), (1, -1), (0, -1), (-1, -1), (-2, -1), (-3, -1), (-4, -1),
    (3, -2), (2, -2), (1, -2), (0, -2), (-1, -2), (-2, -2), (-3, -2), (-4, -2),
    (3, -3), (2, -3), (1, -3), (0, -3), (-1, -3), (-2, -3), (-3, -3), (-4, -3),
    (3, -4), (2, -4), (1, -4), (0, -4),
]


def _fetch_w(blk: L.LogBC7Block, plane: int, w: int) -> int:
    sp = plane if blk.is_dual_plane() else 0
    return L.dequant_weight(int(blk.weights[sp][w]), blk.weight_bits[sp])


def eval_weight_predictor(cand, amp, bx, by, tile, log_blks, plane):
    """Returns preds[16] or None if the candidate is unavailable."""
    def get(nx, ny):
        if tile[0] <= nx <= tile[2] and tile[1] <= ny <= tile[3]:
            return log_blks[ny][nx]
        return None

    left = get(bx - 1, by)
    up = get(bx, by - 1)
    ldiag = get(bx - 1, by - 1)
    rdiag = get(bx + 1, by - 1)

    c = None
    if cand >= CAND_FIRST_XY_DELTA:
        dx, dy = XY_DELTAS[cand - CAND_FIRST_XY_DELTA]
        c = get(bx + dx, by + dy)
        if c is None:
            return None
    else:
        need = {
            CAND_LEFT_EDGE: (left,),
            CAND_UPPER_EDGE: (up,),
            CAND_LU_BLEND: (left, up),
            CAND_REFLECT_LEFT: (left,),
            CAND_REFLECT_UPPER: (up,),
            CAND_LU_AVG: (left, up),
            CAND_LU_BLEND_STRONG: (left, up),
            CAND_GRADIENT: (left, up, ldiag),
            CAND_GRADIENT_DAMPED: (left, up, ldiag),
            CAND_DIAG_AVG: (ldiag, rdiag),
            CAND_DIAG_EDGE_BLEND: (ldiag, rdiag),
            CAND_UPPER_DIAG_EDGE_BLEND: (up, ldiag, rdiag),
            CAND_MED: (left, up, ldiag),
            CAND_GAB: (left, up, ldiag),
            CAND_PLANE_FIT: (left, up),
            CAND_DDL: (up, rdiag),
            CAND_DDR: (left, up, ldiag),
        }[cand]
        if any(n is None for n in need):
            return None
        c = need[0]

    orig = [_fetch_w(c, plane, w) for w in range(16)]
    preds = list(orig)
    ix = lambda x, y: x + y * 4

    if cand == CAND_LEFT_EDGE:
        preds = [orig[ix(3, y)] for y in range(4) for _x in range(4)]
        preds = [orig[ix(3, i // 4)] for i in range(16)]
    elif cand == CAND_UPPER_EDGE:
        preds = [orig[ix(i % 4, 3)] for i in range(16)]
    elif cand in (CAND_LU_BLEND, CAND_LU_AVG, CAND_LU_BLEND_STRONG):
        ue = [_fetch_w(up, plane, ix(x, 3)) for x in range(4)]
        for y in range(4):
            lv = orig[ix(3, y)]
            for x in range(4):
                uv = ue[x]
                if cand == CAND_LU_BLEND:
                    wl, wu = 4 - x, 4 - y
                    den = wl + wu
                    p = (wl * lv + wu * uv + (den >> 1)) // den
                elif cand == CAND_LU_AVG:
                    p = (lv + uv + 1) >> 1
                else:
                    wl, wu = (4 - x) ** 2, (4 - y) ** 2
                    den = wl + wu
                    p = (wl * lv + wu * uv + (den >> 1)) // den
                preds[ix(x, y)] = p
    elif cand == CAND_REFLECT_LEFT:
        preds = [orig[ix(3 - (i % 4), i // 4)] for i in range(16)]
    elif cand == CAND_REFLECT_UPPER:
        preds = [orig[ix(i % 4, 3 - (i // 4))] for i in range(16)]
    elif cand in (CAND_GRADIENT, CAND_GRADIENT_DAMPED, CAND_MED, CAND_GAB):
        ue = [_fetch_w(up, plane, ix(x, 3)) for x in range(4)]
        corner = _fetch_w(ldiag, plane, ix(3, 3))
        for y in range(4):
            lv = orig[ix(3, y)]
            for x in range(4):
                uv = ue[x]
                if cand == CAND_GRADIENT:
                    p = min(max(lv + uv - corner, 0), 64)
                elif cand == CAND_GRADIENT_DAMPED:
                    g = min(max(lv + uv - corner, 0), 64)
                    wl, wu = 4 - x, 4 - y
                    den = wl + wu
                    b7 = (wl * lv + wu * uv + (den >> 1)) // den
                    p = (g + b7 + 1) >> 1
                elif cand == CAND_MED:
                    mn, mx = min(lv, uv), max(lv, uv)
                    if corner >= mx:
                        p = mn
                    elif corner <= mn:
                        p = mx
                    else:
                        p = lv + uv - corner
                    p = min(max(p, 0), 64)
                else:
                    wl = abs(lv - corner) + 1
                    wu = abs(uv - corner) + 1
                    den = wl + wu
                    p = (wl * lv + wu * uv + (den >> 1)) // den
                preds[ix(x, y)] = p
    elif cand == CAND_DIAG_AVG:
        for w in range(16):
            rv = _fetch_w(rdiag, plane, w)
            preds[w] = (orig[w] + rv + 1) >> 1
    elif cand == CAND_DIAG_EDGE_BLEND:
        re = [_fetch_w(rdiag, plane, ix(0, y)) for y in range(4)]
        for y in range(4):
            lv = orig[ix(3, y)]
            rv = re[y]
            for x in range(4):
                preds[ix(x, y)] = ((3 - x) * lv + x * rv + 1) // 3
    elif cand == CAND_UPPER_DIAG_EDGE_BLEND:
        ue = [_fetch_w(up, plane, ix(x, 3)) for x in range(4)]
        re = [_fetch_w(rdiag, plane, ix(0, y)) for y in range(4)]
        for y in range(4):
            ldv = orig[ix(3, y)]
            rdv = re[y]
            for x in range(4):
                diag = ((3 - x) * ldv + x * rdv + 1) // 3
                wu, wd = 4 - y, 1 + y
                den = wu + wd
                preds[ix(x, y)] = (wu * ue[x] + wd * diag
                                   + (den >> 1)) // den
    elif cand == CAND_PLANE_FIT:
        ue = [_fetch_w(up, plane, ix(x, 3)) for x in range(4)]
        le = [orig[ix(3, y)] for y in range(4)]
        sum_u = sum(ue)
        sum_l = sum(le)
        gx10 = -3 * ue[0] - ue[1] + ue[2] + 3 * ue[3]
        gy10 = -3 * le[0] - le[1] + le[2] + 3 * le[3]
        base = 5 * (sum_u + sum_l)
        for y in range(4):
            for x in range(4):
                num = base + gx10 * (4 * x - 1) + gy10 * (4 * y - 1)
                t = num + 20
                p = t // 40 if t >= 0 else -((-t + 39) // 40)
                preds[ix(x, y)] = min(max(p, 0), 64)
    elif cand == CAND_DDL:
        T = [_fetch_w(up, plane, ix(x, 3)) for x in range(4)] + \
            [_fetch_w(rdiag, plane, ix(x, 3)) for x in range(4)]
        for y in range(4):
            for x in range(4):
                d = x + y
                if d == 6:
                    p = (T[6] + 3 * T[7] + 2) >> 2
                else:
                    p = (T[d] + 2 * T[d + 1] + T[d + 2] + 2) >> 2
                preds[ix(x, y)] = p
    elif cand == CAND_DDR:
        A = [0] * 9
        for y in range(4):
            A[3 - y] = orig[ix(3, y)]
        A[4] = _fetch_w(ldiag, plane, ix(3, 3))
        for x in range(4):
            A[5 + x] = _fetch_w(up, plane, ix(x, 3))
        for y in range(4):
            for x in range(4):
                d = 4 + x - y
                preds[ix(x, y)] = (A[d - 1] + 2 * A[d] + A[d + 1] + 2) >> 2

    if amp:
        mean = (sum(preds) + 8) >> 4
        for i in range(16):
            w = preds[i]
            if amp == 1:
                v = min(max(2 * mean - w, 0), 64)
            elif amp == 2:
                v = (w + mean + 1) >> 1
            else:
                f = min(max(2 * mean - w, 0), 64)
                v = (f + mean + 1) >> 1
            preds[i] = v
    return preds


# --- blob container ----------------------------------------------------------

BLOB_MAGIC_BEGIN = 0xB7
BLOB_MAGIC_END = 0x6A

(B_HEADER, B_COMMANDS, B_CONFIG, B_PART2, B_PART3, B_PREDICTORS,
 B_DC_SMALL, B_DC_LARGE, B_AC, B_SIGNS, B_PBITS,
 B_EP_FINE_R, B_EP_FINE_G, B_EP_FINE_B, B_EP_FINE_A,
 B_EP_COARSE_R, B_EP_COARSE_G, B_EP_COARSE_B, B_EP_COARSE_A,
 B_EP_RAW, B_EP_BLOCK_INDEX, B_RAW_WEIGHTS, B_SOLID_DELTAS,
 B_WT_RESID2, B_WT_RESID3, B_WT_RESID4, B_SEEK) = range(27)


def read_blobs(data: bytes):
    """blob_stream_reader::init_internal."""
    import zstandard

    if len(data) < 3 or data[0] != BLOB_MAGIC_BEGIN:
        raise ValueError("bad XBC7 blob magic")
    ofs = 1
    num_blobs = data[ofs]
    ofs += 1
    blobs = {}

    def varint():
        nonlocal ofs
        v = 0
        shift = 0
        while True:
            b = data[ofs]
            ofs += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7

    dctx = zstandard.ZstdDecompressor()
    for _ in range(num_blobs):
        id_flag = data[ofs]
        ofs += 1
        bid = id_flag & 0x7F
        compressed = bool(id_flag & 0x80)
        uncomp = varint()
        stored = varint() if compressed else uncomp
        payload = data[ofs:ofs + stored]
        ofs += stored
        if bid in blobs:
            raise ValueError("duplicate blob id")
        if compressed:
            blobs[bid] = dctx.decompress(payload, max_output_size=uncomp)
        else:
            blobs[bid] = payload
    if ofs != len(data) - 1 or data[ofs] != BLOB_MAGIC_END:
        raise ValueError("bad XBC7 end marker")
    return blobs


class _ByteCursor:
    def __init__(self, data: bytes, start: int, end: int):
        self.data = data
        self.ofs = start
        self.end = end

    def get(self) -> int:
        if self.ofs >= self.end:
            raise ValueError("XBC7 stream underrun")
        b = self.data[self.ofs]
        self.ofs += 1
        return b


class _LsbBits:
    def __init__(self, data: bytes, start_bit: int, end_bit: int):
        self.data = data
        self.bit = start_bit
        self.end = end_bit

    def get(self, n: int) -> int:
        if self.bit + n > self.end:
            raise ValueError("XBC7 bit stream underrun")
        v = 0
        for i in range(n):
            bo = self.bit + i
            v |= ((self.data[bo >> 3] >> (bo & 7)) & 1) << i
        self.bit += n
        return v


# commands
CMD_REPEAT_LAST = 0
CMD_REPEAT_UPPER = 1
CMD_SOLID_DPCM = 2
CMD_NEW_CONFIG = 3
CMD_REUSE_LEFT = 4
CMD_REUSE_UPPER = 5
CMD_REUSE_LDIAG = 6
CMD_REUSE_RDIAG = 7

EP_RAW = 0
EP_DPCM_LEFT = 1
EP_DPCM_UP = 2
EP_DPCM_LDIAG = 3
EP_DPCM_RDIAG = 4
EP_DPCM_BLOCK_INDEX = 5
EP_DPCM_LEFT_S1 = 6
EP_DPCM_UP_S1 = 7


@dataclasses.dataclass
class Xbc7Image:
    width: int
    height: int
    num_blocks_x: int
    num_blocks_y: int
    global_q: int
    has_alpha: bool
    num_stripes: int


def _stripe_ranges(nby: int, n: int):
    base = nby // n
    extra = nby % n
    out = []
    cur = 0
    for i in range(n):
        rows = base + (1 if i < extra else 0)
        out.append((cur, rows))
        cur += rows
    return out


def decode_image(data: bytes, parallel: bool = True):
    """→ (Xbc7Image, [[LogBC7Block]*nbx]*nby). image_unpacker::init +
    decode_all; stripes decode concurrently when parallel."""
    if data[0] in (0xB8, 0xB9):
        # tiny-mip: [marker][nbx u8][nby u8] + 16 bytes/block raw BC7
        has_alpha = data[0] == 0xB9
        nbx, nby = data[1], data[2]
        blocks = [[None] * nbx for _ in range(nby)]
        for by in range(nby):
            for bx in range(nbx):
                o = 3 + (by * nbx + bx) * 16
                blocks[by][bx] = L.unpack_phys(data[o:o + 16])
        img = Xbc7Image(width=nbx * 4, height=nby * 4, num_blocks_x=nbx,
                        num_blocks_y=nby, global_q=100, has_alpha=has_alpha,
                        num_stripes=1)
        return img, blocks

    blobs = read_blobs(data)
    hdr = blobs[B_HEADER]
    if len(hdr) != 7:
        raise ValueError("bad XBC7 header size")
    width, height = struct.unpack_from("<HH", hdr, 0)
    global_q = hdr[4]
    flags = hdr[5]
    num_stripes = hdr[6]
    has_alpha = bool(flags & 1)
    nbx = (width + 3) // 4
    nby = (height + 3) // 4
    if len(blobs.get(B_COMMANDS, b"")) != nbx * nby:
        raise ValueError("XBC7 command blob size mismatch")

    stripes = _stripe_ranges(nby, num_stripes)

    # per-stripe seek offsets (absolute), ids 1..25
    seek = {}
    bit_blobs = {B_SIGNS, B_PBITS, B_EP_RAW}
    for bid in range(1, 26):
        size = len(blobs.get(bid, b""))
        end = size * 8 if bid in bit_blobs else size
        seek[bid] = [0] * num_stripes + [end]
    if num_stripes > 1:
        tbl = blobs[B_SEEK]
        n_streams = 25
        num_entries = num_stripes * n_streams
        if len(tbl) != num_entries * 4:
            raise ValueError("XBC7 seek table size mismatch")
        for bid in range(1, 26):
            running = 0
            for st in range(num_stripes):
                e = st * n_streams + (bid - 1)
                delta = (tbl[e] | (tbl[num_entries + e] << 8)
                         | (tbl[2 * num_entries + e] << 16)
                         | (tbl[3 * num_entries + e] << 24))
                running += delta
                seek[bid][st] = running

    img = Xbc7Image(width=width, height=height, num_blocks_x=nbx,
                    num_blocks_y=nby, global_q=global_q,
                    has_alpha=has_alpha, num_stripes=num_stripes)
    log_blks = [[None] * nbx for _ in range(nby)]

    if parallel and num_stripes > 1:
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(min(num_stripes, 8)) as ex:
            futs = [ex.submit(_decode_stripe, img, blobs, seek, stripes, s,
                              log_blks) for s in range(num_stripes)]
            for f in futs:
                f.result()
    else:
        for s in range(num_stripes):
            _decode_stripe(img, blobs, seek, stripes, s, log_blks)
    return img, log_blks


def _decode_stripe(img, blobs, seek, stripes, s, log_blks):
    first_row, n_rows = stripes[s]
    end_row = first_row + n_rows
    nbx = img.num_blocks_x
    tile = (0, first_row, nbx - 1, end_row - 1)
    has_alpha = img.has_alpha
    gq = img.global_q * ONE

    def bc(bid):
        return _ByteCursor(blobs.get(bid, b""), seek[bid][s], seek[bid][s + 1])

    commands = bc(B_COMMANDS)
    configs = bc(B_CONFIG)
    part2 = bc(B_PART2)
    part3 = bc(B_PART3)
    predictors = bc(B_PREDICTORS)
    dc_coeffs = bc(B_DC_SMALL)
    ac_coeffs = bc(B_AC)
    solid_deltas = bc(B_SOLID_DELTAS)
    ep_block_index = bc(B_EP_BLOCK_INDEX)
    raw_weights = bc(B_RAW_WEIGHTS)
    wt_resid = {2: bc(B_WT_RESID2), 3: bc(B_WT_RESID3), 4: bc(B_WT_RESID4)}
    ep_fine = [bc(B_EP_FINE_R + i) for i in range(4)]
    ep_coarse = [bc(B_EP_COARSE_R + i) for i in range(4)]
    coeff_signs = _LsbBits(blobs.get(B_SIGNS, b""), seek[B_SIGNS][s],
                           seek[B_SIGNS][s + 1])
    pbits_r = _LsbBits(blobs.get(B_PBITS, b""), seek[B_PBITS][s],
                       seek[B_PBITS][s + 1])
    ep_raw = _LsbBits(blobs.get(B_EP_RAW, b""), seek[B_EP_RAW][s],
                      seek[B_EP_RAW][s + 1])

    def neighbor(nx, ny):
        if tile[0] <= nx <= tile[2] and tile[1] <= ny <= tile[3]:
            return log_blks[ny][nx]
        return None

    for by in range(first_row, end_row):
        for bx in range(nbx):
            left = neighbor(bx - 1, by)
            up = neighbor(bx, by - 1)
            ldiag = neighbor(bx - 1, by - 1)
            rdiag = neighbor(bx + 1, by - 1)

            cmd_byte = commands.get()
            cmd = cmd_byte & 7
            ep_mode = (cmd_byte >> 3) & 7
            wt_mode = (cmd_byte >> 6) & 1
            if cmd_byte & 0x80:
                raise ValueError("XBC7 reserved P-frame flag")

            if cmd <= CMD_SOLID_DPCM:
                if cmd_byte != cmd:
                    raise ValueError("XBC7 non-canonical simple command")
                if cmd == CMD_REPEAT_LAST:
                    if left is None:
                        raise ValueError("XBC7 repeat-last at row start")
                    log_blks[by][bx] = left.copy()
                elif cmd == CMD_REPEAT_UPPER:
                    if up is None:
                        raise ValueError("XBC7 repeat-upper at top")
                    log_blks[by][bx] = up.copy()
                else:
                    preds = [0, 0, 0, 0]
                    num = 0
                    if left is not None:
                        lp = L.unpack_rgba(left)
                        for y in range(4):
                            px = lp[3 + y * 4]
                            for c in range(4):
                                preds[c] += int(px[c])
                        num += 4
                    if up is not None:
                        upx = L.unpack_rgba(up)
                        for x in range(4):
                            px = upx[x + 3 * 4]
                            for c in range(4):
                                preds[c] += int(px[c])
                        num += 4
                    if num:
                        preds = [(p + num // 2) // num for p in preds]
                    color = [0, 0, 0, 255]
                    for c in range(4 if has_alpha else 3):
                        color[c] = (solid_deltas.get() + preds[c]) & 0xFF
                    log_blks[by][bx] = L.create_solid_blk(color)
                continue

            # ---- config
            if cmd == CMD_NEW_CONFIG:
                config_byte = configs.get()
                if config_byte & 0xC0:
                    raise ValueError("XBC7 reserved config bits")
                mode = config_byte & 7
                rot = (config_byte >> 3) & 3
                sel = (config_byte >> 5) & 1
                blk = L.init_log_blk(mode)
                if blk.num_planes == 2:
                    blk.dp_rotation_index = rot
                elif rot:
                    raise ValueError("XBC7 rotation on SP mode")
                if mode == 4:
                    blk.mode4_index_selector = sel
                elif sel:
                    raise ValueError("XBC7 selector outside mode 4")
            else:
                src = {CMD_REUSE_LEFT: left, CMD_REUSE_UPPER: up,
                       CMD_REUSE_LDIAG: ldiag, CMD_REUSE_RDIAG: rdiag}[cmd]
                if src is None:
                    raise ValueError("XBC7 config reuse unavailable")
                blk = L.init_log_blk(src.mode)
                blk.dp_rotation_index = src.dp_rotation_index
                blk.mode4_index_selector = src.mode4_index_selector

            if blk.num_partitions == 2:
                pat = part2.get()
                if pat >= 64:
                    raise ValueError("XBC7 bad partition2")
                blk.pattern_index = pat
            elif blk.num_partitions == 3:
                pat = part3.get()
                if pat >= (1 << blk.pattern_bits):
                    raise ValueError("XBC7 bad partition3")
                blk.pattern_index = pat

            fmt = L.ENDPOINT_FORMATS[blk.mode]
            num_comps = blk.get_num_comps()

            # ---- endpoints
            if ep_mode == EP_RAW:
                for subset in range(blk.num_partitions):
                    for c in range(num_comps):
                        for e in range(2):
                            blk.endpoints[subset][e][c] = ep_raw.get(
                                blk.endpoint_bits[c == 3])
                for pb in range(blk.num_pbits):
                    blk.pbits[pb] = ep_raw.get(1)
            else:
                pred_subset = 0
                if ep_mode == EP_DPCM_LEFT:
                    pred_blk = left
                elif ep_mode == EP_DPCM_UP:
                    pred_blk = up
                elif ep_mode == EP_DPCM_LDIAG:
                    pred_blk = ldiag
                elif ep_mode == EP_DPCM_RDIAG:
                    pred_blk = rdiag
                elif ep_mode == EP_DPCM_LEFT_S1:
                    pred_blk = left
                    pred_subset = 1
                elif ep_mode == EP_DPCM_UP_S1:
                    pred_blk = up
                    pred_subset = 1
                else:  # EP_DPCM_BLOCK_INDEX
                    di = ep_block_index.get()
                    if di >= NUM_XY_DELTAS:
                        raise ValueError("XBC7 bad ep delta index")
                    dx, dy = XY_DELTAS[di]
                    pred_blk = neighbor(bx + dx, by + dy)
                if pred_blk is None:
                    raise ValueError("XBC7 ep predictor unavailable")
                if pred_subset and pred_blk.num_partitions < 2:
                    raise ValueError("XBC7 subset-1 on unpartitioned pred")
                fine = blk.endpoint_bits[0] >= 6
                for subset in range(blk.num_partitions):
                    num_residuals = num_comps * 2
                    residuals = [0] * 8
                    if (not has_alpha) and blk.mode == 6:
                        num_residuals = 6
                    for i in range(0, num_residuals, 2):
                        chan = i >> 1
                        strm = (ep_fine if fine else ep_coarse)[chan]
                        residuals[i] = strm.get()
                        residuals[i + 1] = strm.get()
                    residual_pbits = [0, 0]
                    for pb in range(fmt[2]):
                        residual_pbits[pb] = pbits_r.get(1)
                    L.endpoint_dpcm_decode(pred_blk, pred_subset, blk,
                                           subset, residuals, residual_pbits)
                    if (not has_alpha) and blk.mode == 6:
                        blk.endpoints[0][0][3] = 127
                        blk.endpoints[0][1][3] = 127

            # ---- weights
            pred_byte = predictors.get()
            if pred_byte >= TOTAL_CANDIDATES * 4:
                raise ValueError("XBC7 bad predictor byte")
            cand = pred_byte % TOTAL_CANDIDATES
            amp = pred_byte // TOTAL_CANDIDATES
            if amp and cand == CAND_ABSOLUTE:
                raise ValueError("XBC7 amp on absolute predictor")

            for p in range(blk.num_planes):
                preds = None
                if cand != CAND_ABSOLUTE:
                    preds = eval_weight_predictor(cand, amp, bx, by, tile,
                                                  log_blks, p)
                    if preds is None:
                        raise ValueError("XBC7 predictor unavailable")
                if wt_mode == 0:
                    # lossless DPCM weights
                    nb = blk.weight_bits[p]
                    mask = (1 << nb) - 1
                    strm = raw_weights if cand == CAND_ABSOLUTE \
                        else wt_resid[nb]
                    syms = []
                    if nb == 2:
                        for _ in range(4):
                            b = strm.get()
                            syms += [b & 3, (b >> 2) & 3, (b >> 4) & 3,
                                     b >> 6]
                    else:
                        for _ in range(8):
                            b = strm.get()
                            lo, hi = b & 0xF, b >> 4
                            if nb == 3 and (lo > 7 or hi > 7):
                                raise ValueError("XBC7 bad 3-bit nibble")
                            syms += [lo, hi]
                    for i in range(16):
                        pi = L.quant_weight(preds[i], nb) if preds else 0
                        blk.weights[p][i] = (syms[i] + pi) & mask
                    continue
                # DCT weights
                dc = dc_coeffs.get()
                if pred_byte != CAND_ABSOLUTE:
                    if coeff_signs.get(1):
                        dc = -dc
                ac = []
                zig = 1
                while zig < 16:
                    b = ac_coeffs.get()
                    if b == 0xFF:
                        ac.append((16 - zig, 0x7FFF))
                        break
                    run = b
                    if zig + run > 15:
                        raise ValueError("XBC7 AC run overflow")
                    mag = ac_coeffs.get()
                    if not mag:
                        raise ValueError("XBC7 zero AC coefficient")
                    sign = coeff_signs.get(1)
                    ac.append((run, -mag if sign else mag))
                    zig += run + 1
                if not dct_inverse_weights(gq, p, preds, dc, ac, blk):
                    raise ValueError("XBC7 DCT decode failed")

            log_blks[by][bx] = blk


def decode_rgba(data: bytes):
    """→ (Xbc7Image, (H, W, 4) uint8)."""
    img, blks = decode_image(data)
    out = np.zeros((img.num_blocks_y * 4, img.num_blocks_x * 4, 4), np.uint8)
    for by in range(img.num_blocks_y):
        for bx in range(img.num_blocks_x):
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                L.unpack_rgba(blks[by][bx]).reshape(4, 4, 4)
    return img, out[:img.height, :img.width]


def decode_bc7(data: bytes):
    """→ (Xbc7Image, (N, 16) uint8 physical BC7 blocks)."""
    img, blks = decode_image(data)
    out = np.zeros((img.num_blocks_y * img.num_blocks_x, 16), np.uint8)
    i = 0
    for by in range(img.num_blocks_y):
        for bx in range(img.num_blocks_x):
            out[i] = np.frombuffer(L.pack_phys(blks[by][bx]), np.uint8)
            i += 1
    return img, out
