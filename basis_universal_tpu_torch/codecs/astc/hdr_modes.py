"""Copy of `basis_universal_tpu/codecs/astc/hdr_modes.py`.

Vectorized ASTC HDR CEM 7 / CEM 11 submode packing, requantization and
decode — the endpoint machinery behind the multi-mode UASTC HDR 4x4 / ASTC
HDR 6x6 encoders.

Parity sources (behavior, not code):
  - submode field layouts: the CEM 11/7 endpoint decoders
    (transcoder/basisu_transcoder.cpp:22150+, mirrored in
    codecs/astc/helpers.py _decode_mode11_qlog12/_decode_mode7_qlog12)
  - pack direction: encoder/basisu_astc_hdr_common.cpp
    pack_astc_mode11_submode (:1439), pack_astc_mode11_direct (:1786),
    pack_astc_mode7_submode (:1866), quant_qlog16 (:98)
  - ISE requantization before decode: requantize_ise_endpoints usage in
    pack_mode11 (encoder/basisu_astc_hdr_common.cpp:2398-2450)
  - error metric: eval_selectors q()/q2() perceptual log2 approximation
    with 2/3/1 RGB weights (encoder/basisu_astc_hdr_common.h:183-207)

Everything operates on int64 numpy arrays batched over blocks.
"""

import functools

import numpy as np

from ..uastc import tables as T

# CEM 11 submode bit widths (a = 9 + (submode >> 1))
S_B_BITS = (7, 8, 6, 7, 8, 6, 7, 6)
S_C_BITS = (6, 6, 7, 7, 6, 7, 7, 7)
S_D_BITS = (7, 6, 7, 6, 5, 6, 5, 6)

# CEM 7 submode bit widths
M7_R_BITS = (11, 11, 10, 9, 8, 7)
M7_GB_BITS = (5, 6, 5, 6, 7, 7)
M7_S_BITS = (7, 5, 8, 7, 6, 7)

MAX_QLOG = {7: 123, 8: 247, 9: 495, 10: 991, 11: 1983, 12: 3967, 16: 63487}

Q_LOG_BIAS_4x4 = 0.125
Q_LOG_BIAS_6x6 = 1.0


def _bit(v, n):
    return (v >> n) & 1


def quant_qlog16(q16: np.ndarray, bits: int) -> np.ndarray:
    """quant_qlog16 (round-to-nearest-up, clamped)."""
    shift = 16 - bits
    e = (q16 + (1 << (shift - 1)) - 1) >> shift
    return np.clip(e, 0, (1 << bits) - 1)


# ---------------------------------------------------------------------------
# CEM 11 pack (vectorized over B blocks)
# ---------------------------------------------------------------------------

def pack_mode11_direct(lo_q16: np.ndarray, hi_q16: np.ndarray) -> np.ndarray:
    """(B,3),(B,3) qlog16 → (B,6) uint8 direct-mode endpoint bytes."""
    lo = lo_q16.astype(np.int64).copy()
    hi = hi_q16.astype(np.int64).copy()
    swap = lo.sum(-1) > hi.sum(-1)
    lo2 = np.where(swap[:, None], hi, lo)
    hi2 = np.where(swap[:, None], lo, hi)
    bits = np.array([8, 8, 7])
    lq = np.minimum(np.clip((lo2 + (1 << (16 - bits - 1)) - 1)
                            >> (16 - bits), 0, (1 << bits) - 1),
                    np.array([MAX_QLOG[8], MAX_QLOG[8], MAX_QLOG[7]]))
    hq = np.minimum(np.clip((hi2 + (1 << (16 - bits - 1)) - 1)
                            >> (16 - bits), 0, (1 << bits) - 1),
                    np.array([MAX_QLOG[8], MAX_QLOG[8], MAX_QLOG[7]]))
    # de-degenerate equal pairs (reference pack_astc_mode11_direct)
    m = np.array([MAX_QLOG[8], MAX_QLOG[8], MAX_QLOG[7]])
    eq = lq == hq
    lq = np.where(eq & (lq > 0), lq - 1, lq)
    hq = np.where(eq & (hq < m), hq + 1, hq)
    out = np.zeros(lo.shape[:1] + (6,), dtype=np.int64)
    out[:, 0] = lq[:, 0]
    out[:, 1] = hq[:, 0]
    out[:, 2] = lq[:, 1]
    out[:, 3] = hq[:, 1]
    out[:, 4] = lq[:, 2] | 0x80
    out[:, 5] = hq[:, 2] | 0x80
    return out.astype(np.uint8)


def pack_mode11_submode(submode: int, lo_q16: np.ndarray,
                        hi_q16: np.ndarray) -> np.ndarray:
    """(B,3),(B,3) qlog16 → (B,6) uint8 endpoint bytes for CEM-11
    submode 0-7 (main pass of pack_astc_mode11_submode; clamped deltas are
    allowed — callers evaluate the true requantized decode error)."""
    a_bits = 9 + (submode >> 1)
    b_bits, c_bits, d_bits = (S_B_BITS[submode], S_C_BITS[submode],
                              S_D_BITS[submode])
    max_b = (1 << b_bits) - 1
    max_c = (1 << c_bits) - 1
    min_d = -(1 << (d_bits - 1))
    max_d = -min_d - 1

    v0q = np.minimum(quant_qlog16(lo_q16.astype(np.int64), a_bits),
                     MAX_QLOG[a_bits])                       # (B,3)
    v1q = np.minimum(quant_qlog16(hi_q16.astype(np.int64), a_bits),
                     MAX_QLOG[a_bits])

    both = np.stack([v0q, v1q], axis=1)                      # (B,2,3)
    flat = both.reshape(-1, 6)
    hi_idx = flat.argmax(1)                                  # (B,)
    highest_val = hi_idx // 3
    highest_comp = hi_idx % 3

    # swap lo/hi so val[1] holds the highest, then maj-comp to slot 0
    swap_vals = highest_val != 1
    v0 = np.where(swap_vals[:, None], v1q, v0q)
    v1 = np.where(swap_vals[:, None], v0q, v1q)
    bidx = np.arange(flat.shape[0])
    t0 = v0[bidx, highest_comp].copy()
    t1 = v1[bidx, highest_comp].copy()
    v0[bidx, highest_comp] = v0[:, 0]
    v1[bidx, highest_comp] = v1[:, 0]
    v0[:, 0] = t0
    v1[:, 0] = t1

    va = v1[:, 0]
    vb0 = np.clip(va - v1[:, 1], 0, max_b)
    vb1 = np.clip(va - v1[:, 2], 0, max_b)
    vc = np.clip(va - v0[:, 0], 0, max_c)
    vd0 = np.clip((va - vb0 - vc) - v0[:, 1], min_d, max_d)
    vd1 = np.clip((va - vb1 - vc) - v0[:, 2], min_d, max_d)

    z = np.zeros_like(va)
    if submode == 0:
        x = (_bit(vb0, 6), _bit(vb1, 6), _bit(vd0, 6), _bit(vd1, 6),
             _bit(vd0, 5), _bit(vd1, 5))
    elif submode == 1:
        x = (_bit(vb0, 6), _bit(vb1, 6), _bit(vb0, 7), _bit(vb1, 7),
             _bit(vd0, 5), _bit(vd1, 5))
    elif submode == 2:
        x = (_bit(va, 9), _bit(vc, 6), _bit(vd0, 6), _bit(vd1, 6),
             _bit(vd0, 5), _bit(vd1, 5))
    elif submode == 3:
        x = (_bit(vb0, 6), _bit(vb1, 6), _bit(va, 9), _bit(vc, 6),
             _bit(vd0, 5), _bit(vd1, 5))
    elif submode == 4:
        x = (_bit(vb0, 6), _bit(vb1, 6), _bit(vb0, 7), _bit(vb1, 7),
             _bit(va, 9), _bit(va, 10))
    elif submode == 5:
        x = (_bit(va, 9), _bit(va, 10), _bit(vc, 7), _bit(vc, 6),
             _bit(vd0, 5), _bit(vd1, 5))
    elif submode == 6:
        x = (_bit(vb0, 6), _bit(vb1, 6), _bit(va, 11), _bit(vc, 6),
             _bit(va, 9), _bit(va, 10))
    elif submode == 7:
        x = (_bit(va, 9), _bit(va, 10), _bit(va, 11), _bit(vc, 6),
             _bit(vd0, 5), _bit(vd1, 5))
    else:
        raise ValueError(submode)
    x0, x1, x2, x3, x4, x5 = x

    o = np.zeros(va.shape + (6,), dtype=np.int64)
    o[:, 0] = va & 0xFF
    o[:, 1] = ((_bit(z + submode, 0) << 7) | (_bit(va, 8) << 6) | (vc & 63))
    o[:, 2] = ((_bit(z + submode, 1) << 7) | (x0 << 6) | (vb0 & 63))
    o[:, 3] = ((_bit(z + submode, 2) << 7) | (x1 << 6) | (vb1 & 63))
    o[:, 4] = ((_bit(highest_comp, 0) << 7) | (x2 << 6) | (x4 << 5)
               | (vd0 & 31))
    o[:, 5] = ((_bit(highest_comp, 1) << 7) | (x3 << 6) | (x5 << 5)
               | (vd1 & 31))
    return o.astype(np.uint8)


# ---------------------------------------------------------------------------
# CEM 7 pack
# ---------------------------------------------------------------------------

def pack_mode7_submode(submode: int, rgb_q16: np.ndarray, s_q16: np.ndarray,
                       ise_weight_range: int) -> np.ndarray:
    """(B,3) high-color qlog16 + (B,) scale qlog16 → (B,4) uint8 CEM-7
    endpoint bytes for submode 0-5."""
    prec = M7_R_BITS[submode]
    pb = (M7_R_BITS[submode], M7_GB_BITS[submode], M7_GB_BITS[submode],
          M7_S_BITS[submode])
    q = np.zeros(rgb_q16.shape[:1] + (4,), dtype=np.int64)
    for i in range(4):
        f = s_q16 if i == 3 else rgb_q16[:, i]
        qi = quant_qlog16(np.clip(f.astype(np.int64), 0, MAX_QLOG[16]), prec)
        if ise_weight_range >= 4:
            # bias high color + scale to exploit the weight range
            K = 3
            maxv = (1 << prec) - 1
            qi = np.minimum(qi + (K * 2 if i == 3 else K), maxv)
        if i != 3:
            qi = np.minimum(qi, MAX_QLOG[prec])
        if i == 3:
            qi = np.maximum(qi, 1)        # S=0 kills weight freedom
        q[:, i] = qi

    maj = np.zeros(q.shape[0], dtype=np.int64)
    if submode != 5:
        maj = q[:, :3].argmax(1)
        bidx = np.arange(q.shape[0])
        t = q[bidx, maj].copy()
        q[bidx, maj] = q[:, 0]
        q[:, 0] = t
        q[:, 1] = np.clip(q[:, 0] - q[:, 1], 0, (1 << pb[1]) - 1)
        q[:, 2] = np.clip(q[:, 0] - q[:, 2], 0, (1 << pb[2]) - 1)
        q[:, 3] = np.minimum(q[:, 3], (1 << pb[3]) - 1)
        mode = (maj << 2) | submode if submode < 4 else (maj | 0xC)
    else:
        mode = np.full(q.shape[0], 0xF, dtype=np.int64)
    if submode == 4:
        mode = maj | 0xC

    q0, q1, q2_, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    if submode == 0:
        x = (_bit(q0, 9), _bit(q0, 8), _bit(q0, 7), _bit(q0, 10),
             _bit(q0, 6), _bit(q3, 6), _bit(q3, 5))
    elif submode == 1:
        x = (_bit(q0, 8), _bit(q1, 5), _bit(q0, 7), _bit(q2_, 5),
             _bit(q0, 6), _bit(q0, 10), _bit(q0, 9))
    elif submode == 2:
        x = (_bit(q0, 9), _bit(q0, 8), _bit(q0, 7), _bit(q0, 6),
             _bit(q3, 7), _bit(q3, 6), _bit(q3, 5))
    elif submode == 3:
        x = (_bit(q0, 8), _bit(q1, 5), _bit(q0, 7), _bit(q2_, 5),
             _bit(q0, 6), _bit(q3, 6), _bit(q3, 5))
    elif submode == 4:
        x = (_bit(q1, 6), _bit(q1, 5), _bit(q2_, 6), _bit(q2_, 5),
             _bit(q0, 6), _bit(q0, 7), _bit(q3, 5))
    elif submode == 5:
        x = (_bit(q1, 6), _bit(q1, 5), _bit(q2_, 6), _bit(q2_, 5),
             _bit(q0, 6), _bit(q3, 6), _bit(q3, 5))
    else:
        raise ValueError(submode)
    x0, x1, x2, x3, x4, x5, x6 = x

    o = np.zeros(q.shape[:1] + (4,), dtype=np.int64)
    o[:, 0] = (_bit(mode, 1) << 7) | (_bit(mode, 0) << 6) | (q0 & 63)
    o[:, 1] = (_bit(mode, 2) << 7) | (x0 << 6) | (x1 << 5) | (q1 & 31)
    o[:, 2] = (_bit(mode, 3) << 7) | (x2 << 6) | (x3 << 5) | (q2_ & 31)
    o[:, 3] = (x4 << 7) | (x5 << 6) | (x6 << 5) | (q3 & 31)
    return o.astype(np.uint8)


# ---------------------------------------------------------------------------
# ISE requantization + batch decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def quant_tables(rng: int):
    """(byte → nearest ISE code, code → unquantized byte) for a color ISE
    range."""
    unq = np.asarray(T.color_unquant_table(rng), dtype=np.int64)
    inv = np.argmin(np.abs(unq[None, :] - np.arange(256)[:, None]), axis=1)
    return inv.astype(np.int64), unq


def requantize(v_bytes: np.ndarray, ep_range: int):
    """(…,) endpoint bytes → (ISE codes, post-unquant bytes)."""
    inv, unq = quant_tables(ep_range)
    codes = inv[v_bytes.astype(np.int64)]
    return codes, unq[codes]


def decode_mode11(v: np.ndarray) -> tuple:
    """(B,6) endpoint BYTES (post-unquant) → (e0, e1) each (B,3) qlog12.
    Vectorized mirror of helpers._decode_mode11_qlog12."""
    v = v.astype(np.int64)
    v0, v1, v2, v3, v4, v5 = (v[:, i] for i in range(6))
    maj = ((v4 >> 7) & 1) | (((v5 >> 7) & 1) << 1)

    # direct path (maj == 3)
    d_e0 = np.stack([v0 << 4, v2 << 4, (v4 & 127) << 5], -1)
    d_e1 = np.stack([v1 << 4, v3 << 4, (v5 & 127) << 5], -1)

    mode = ((v1 >> 7) & 1) | (((v2 >> 7) & 1) << 1) | (((v3 >> 7) & 1) << 2)
    va = v0 | (((v1 >> 6) & 1) << 8)
    vb0 = v2 & 63
    vb1 = v3 & 63
    vc = v1 & 63
    dbits = np.array((7, 6, 7, 6, 5, 6, 5, 6))[mode]
    vd0 = v4 & ((1 << dbits) - 1)
    vd1 = v5 & ((1 << dbits) - 1)
    sign0 = (vd0 >> (dbits - 1)) & 1
    sign1 = (vd1 >> (dbits - 1)) & 1
    vd0 = vd0 - (sign0 << dbits)
    vd1 = vd1 - (sign1 << dbits)
    x0, x1 = (v2 >> 6) & 1, (v3 >> 6) & 1
    x2, x3 = (v4 >> 6) & 1, (v5 >> 6) & 1
    x4, x5 = (v4 >> 5) & 1, (v5 >> 5) & 1
    ohm = 1 << mode

    def add(base, cond_mask, xbit, shift):
        return base | np.where((ohm & cond_mask) != 0, xbit << shift, 0)

    va = add(va, 0xA4, x0, 9)
    va = add(va, 0x08, x2, 9)
    va = add(va, 0x50, x4, 9)
    va = add(va, 0x50, x5, 10)
    va = add(va, 0xA0, x1, 10)
    va = add(va, 0xC0, x2, 11)
    vc = add(vc, 0x04, x1, 6)
    vc = add(vc, 0xE8, x3, 6)
    vc = add(vc, 0x20, x2, 7)
    vb0 = add(vb0, 0x5B, x0, 6)
    vb1 = add(vb1, 0x5B, x1, 6)
    vb0 = add(vb0, 0x12, x2, 7)
    vb1 = add(vb1, 0x12, x3, 7)
    shamt = (mode >> 1) ^ 3
    va <<= shamt
    vb0 <<= shamt
    vb1 <<= shamt
    vc <<= shamt
    vd0 = vd0 << shamt
    vd1 = vd1 << shamt
    clamp = lambda a: np.clip(a, 0, 0xFFF)
    s_e1 = np.stack([clamp(va), clamp(va - vb0), clamp(va - vb1)], -1)
    s_e0 = np.stack([clamp(va - vc), clamp(va - vb0 - vc - vd0),
                     clamp(va - vb1 - vc - vd1)], -1)
    # maj-comp unswap (maj in 0..2)
    bidx = np.arange(v.shape[0])
    mj = np.where(maj == 3, 0, maj)
    for e in (s_e0, s_e1):
        t = e[bidx, mj].copy()
        e[bidx, mj] = e[:, 0]
        e[:, 0] = t
    e0 = np.where((maj == 3)[:, None], d_e0, s_e0)
    e1 = np.where((maj == 3)[:, None], d_e1, s_e1)
    return e0, e1


def decode_mode7(v: np.ndarray) -> tuple:
    """(B,4) endpoint BYTES (post-unquant) → (e0, e1) each (B,3) qlog12.
    Vectorized mirror of helpers._decode_mode7_qlog12."""
    v = v.astype(np.int64)
    v0, v1, v2, v3 = (v[:, i] for i in range(4))
    modeval = ((v0 & 0xC0) >> 6) | ((v1 & 0x80) >> 5) | ((v2 & 0x80) >> 4)
    cond_a = (modeval & 0xC) != 0xC
    cond_b = modeval != 0xF
    majcomp = np.where(cond_a, modeval >> 2, np.where(cond_b, modeval & 3, 0))
    mode = np.where(cond_a, modeval & 3, np.where(cond_b, 4, 5))
    red, green, blue, scale = v0 & 0x3F, v1 & 0x1F, v2 & 0x1F, v3 & 0x1F
    x0, x1 = (v1 >> 6) & 1, (v1 >> 5) & 1
    x2, x3 = (v2 >> 6) & 1, (v2 >> 5) & 1
    x4, x5, x6 = (v3 >> 7) & 1, (v3 >> 6) & 1, (v3 >> 5) & 1
    ohm = 1 << mode

    def add(base, mask, xbit, shift):
        return base | np.where((ohm & mask) != 0, xbit << shift, 0)

    green = add(green, 0x30, x0, 6)
    green = add(green, 0x3A, x1, 5)
    blue = add(blue, 0x30, x2, 6)
    blue = add(blue, 0x3A, x3, 5)
    scale = add(scale, 0x3D, x6, 5)
    scale = add(scale, 0x2D, x5, 6)
    scale = add(scale, 0x04, x4, 7)
    red = add(red, 0x3B, x4, 6)
    red = add(red, 0x04, x3, 6)
    red = add(red, 0x10, x5, 7)
    red = add(red, 0x0F, x2, 7)
    red = add(red, 0x05, x1, 8)
    red = add(red, 0x0A, x0, 8)
    red = add(red, 0x05, x0, 9)
    red = add(red, 0x02, x6, 9)
    red = add(red, 0x01, x3, 10)
    red = add(red, 0x02, x5, 10)
    shamt = np.array((1, 1, 2, 3, 4, 5))[mode]
    red <<= shamt
    green <<= shamt
    blue <<= shamt
    scale <<= shamt
    ns = mode != 5
    green = np.where(ns, red - green, green)
    blue = np.where(ns, red - blue, blue)
    r2, g2, b2 = red.copy(), green.copy(), blue.copy()
    m1 = majcomp == 1
    m2 = majcomp == 2
    red = np.where(m1, g2, np.where(m2, b2, r2))
    green = np.where(m1, r2, g2)
    blue = np.where(m2, r2, b2)
    clamp = lambda a: np.clip(a, 0, 0xFFF)
    e1 = np.stack([clamp(red), clamp(green), clamp(blue)], -1)
    e0 = np.stack([clamp(red - scale), clamp(green - scale),
                   clamp(blue - scale)], -1)
    return e0, e1


# ---------------------------------------------------------------------------
# Perceptual q-space error helpers
# ---------------------------------------------------------------------------

def half_to_qspace(half_bits: np.ndarray, log_bias: float) -> np.ndarray:
    """half bits → int64 'q' scale: bit pattern of float32(half)+bias —
    the reference's piecewise-linear log2 approximation (q2)."""
    h = np.asarray(half_bits, dtype=np.uint16).view(np.float16)
    f = h.astype(np.float32) + np.float32(log_bias)
    return f.view(np.uint32).astype(np.int64)


RGB_ERR_WEIGHTS = np.array([2, 3, 1], dtype=np.int64)
