"""Copy of `basis_universal_tpu/ops/transcode.py`.

ETC1S → GPU block format conversion kernels (batched, device-friendly).

TPU-native replacement for the reference's table-driven converters
(convert_etc1s_to_dxt1 basisu_transcoder.cpp:2271, ..._to_bc7_m5_color :4310,
EAC/BC4/BC5 paths) — instead of baked .inc lookup tables, endpoints are
fitted per block with closed-form least squares on the ETC1S palette line and
packed with vectorized integer ops. Everything is (N, ...) batched numpy
(used on host after entropy decode) with jnp-compatible arithmetic.

Fixed-point/bit-packing conventions follow the public format specs (BC1-5,
BC7 mode 5, EAC A8); decode-side unpackers for validation live in
gpu_unpack.py.
"""

import numpy as np

from .etc1 import SELECTOR_INDEX_TO_ETC1, etc1s_palette, pack_etc1_blocks

# position of each ETC1S selector along the palette line [0,1] is roughly
# {0, 3/8, 5/8, 1} (mods are ±a, ±b with a≈3b) — matching BC1's {0,1/3,2/3,1}
# and BC7's {0,21/64,43/64,1}, so selector values map index-identically.

# selector k (0=low..3=high) → BC1 2-bit index when c0=High, c1=Low:
# palette [c0, c1, (2c0+c1)/3, (c0+2c1)/3] → positions [1, 0, 2/3, 1/3]
_SEL_TO_BC1_IDX = np.array([1, 3, 2, 0], dtype=np.uint32)


def _expand_565(r5, g6, b5):
    r = (r5 << 3) | (r5 >> 2)
    g = (g6 << 2) | (g6 >> 4)
    b = (b5 << 3) | (b5 >> 2)
    return r, g, b


def _pack_565(rgb):
    """(..., 3) float/int RGB [0,255] → packed 565 uint32."""
    rgb = np.asarray(rgb)
    r = np.clip((rgb[..., 0].astype(np.int64) * 31 + 127) // 255, 0, 31)
    g = np.clip((rgb[..., 1].astype(np.int64) * 63 + 127) // 255, 0, 63)
    b = np.clip((rgb[..., 2].astype(np.int64) * 31 + 127) // 255, 0, 31)
    return ((r << 11) | (g << 5) | b).astype(np.uint32)


def etc1s_to_bc1(endpoint_idx, selector_idx, color5, inten5, selectors,
                 use_threecolor_for_solid: bool = False):
    """ETC1S indices + codebooks → BC1 blocks (BY, BX, 8) uint8.

    Per-block: High/Low palette colors become c0/c1 (4-color mode enforced),
    selectors map through the fixed line-position table; equal endpoints get
    a one-step c1 nudge to stay in 4-color mode.
    """
    e = np.asarray(endpoint_idx)
    shape = e.shape
    pal = etc1s_palette(color5, inten5)[e.ravel()]        # (N,4,3) int32
    sel = selectors[np.asarray(selector_idx).ravel()]     # (N,16) uint8
    n = pal.shape[0]

    c_low = _pack_565(pal[:, 0, :])
    c_high = _pack_565(pal[:, 3, :])

    # ensure c0 > c1 (4-color); if equal, bump blue of c1 down or c0 up
    c0 = np.maximum(c_high, c_low)
    c1 = np.minimum(c_high, c_low)
    swapped = c_high < c_low
    eq = c0 == c1
    can_dec = (c1 & 31) > 0
    c1 = np.where(eq & can_dec, c1 - 1, c1)
    c0 = np.where(eq & ~can_dec, c0 + 1, c0)

    idx_map = _SEL_TO_BC1_IDX[sel.astype(np.int64)]       # (N,16)
    # swapped: c0/c1 roles flipped → index remap 0<->1, 2<->3
    flip = np.array([1, 0, 3, 2], dtype=np.uint32)
    idx_map = np.where(swapped[:, None], flip[idx_map], idx_map)
    # degenerate equal case: keep selectors pointing at interpolants anyway
    bits = np.zeros(n, dtype=np.uint32)
    for i in range(16):
        bits |= idx_map[:, i].astype(np.uint32) << (2 * i)

    out = np.empty((n, 8), dtype=np.uint8)
    out[:, 0] = c0 & 0xFF
    out[:, 1] = c0 >> 8
    out[:, 2] = c1 & 0xFF
    out[:, 3] = c1 >> 8
    for b in range(4):
        out[:, 4 + b] = (bits >> (8 * b)) & 0xFF
    return out.reshape(*shape, 8)


_BC7_M5_WEIGHTS = np.array([0, 21, 43, 64], dtype=np.int64)


def etc1s_to_bc7_m5(endpoint_idx, selector_idx, color5, inten5, selectors,
                    alpha_endpoint_idx=None, alpha_selector_idx=None):
    """ETC1S → BC7 mode 5 blocks (BY, BX, 16) uint8.

    Color endpoints are the exact low/high palette colors quantized to 7
    bits; selector k maps to 2-bit index k (line positions nearly coincide).
    Alpha from an optional alpha slice (green-channel palette) or opaque.
    Mirrors the role of convert_etc1s_to_bc7_m5_color/alpha
    (basisu_transcoder.cpp:4310/4472).
    """
    e = np.asarray(endpoint_idx)
    shape = e.shape
    pal = etc1s_palette(color5, inten5)[e.ravel()]        # (N,4,3)
    sel = selectors[np.asarray(selector_idx).ravel()].astype(np.int64)  # (N,16)
    n = pal.shape[0]

    # Least-squares endpoints: BC7 2-bit weights sit at {0,21,43,64}/64 while
    # the ETC1S palette sits at ±a,±b around the base — fit (L,H) so the four
    # interpolants best match the four palette colors (normal equations are
    # constant, so this is two dots + a 2x2 solve, vectorized).
    w = _BC7_M5_WEIGHTS.astype(np.float64) / 64.0          # (4,)
    a_k, b_k = 1.0 - w, w
    A = float(np.sum(a_k * a_k))
    B = float(np.sum(a_k * b_k))
    C = float(np.sum(b_k * b_k))
    det = A * C - B * B
    t = pal.astype(np.float64)                              # (N,4,3)
    P = np.einsum("k,nkc->nc", a_k, t)
    Q = np.einsum("k,nkc->nc", b_k, t)
    Lf = np.clip((C * P - B * Q) / det, 0, 255)
    Hf = np.clip((A * Q - B * P) / det, 0, 255)
    # 7-bit endpoints, rounded for the (e<<1)|(e>>6) expansion
    lo = np.clip(np.round(Lf * 127.0 / 255.0), 0, 127).astype(np.int64)
    hi = np.clip(np.round(Hf * 127.0 / 255.0), 0, 127).astype(np.int64)

    idx = sel                                             # (N,16) values 0..3
    # anchor constraint: index[0] must be < 2, else swap endpoints + invert
    need_swap = idx[:, 0] >= 2
    idx = np.where(need_swap[:, None], 3 - idx, idx)
    l2 = np.where(need_swap[:, None], hi, lo)
    h2 = np.where(need_swap[:, None], lo, hi)

    if alpha_endpoint_idx is not None:
        apal = etc1s_palette(color5, inten5)[np.asarray(alpha_endpoint_idx).ravel()][:, :, 1]
        asel = selectors[np.asarray(alpha_selector_idx).ravel()].astype(np.int64)
        a_lo = apal[:, 0].astype(np.int64)
        a_hi = apal[:, 3].astype(np.int64)
        aidx = asel
        a_need = aidx[:, 0] >= 2
        aidx = np.where(a_need[:, None], 3 - aidx, aidx)
        al = np.where(a_need, a_hi, a_lo)
        ah = np.where(a_need, a_lo, a_hi)
    else:
        al = np.full(n, 255, dtype=np.int64)
        ah = np.full(n, 255, dtype=np.int64)
        aidx = np.zeros((n, 16), dtype=np.int64)

    # bit-pack 128 bits per block via two uint64 lanes
    lo64 = np.zeros(n, dtype=np.uint64)
    hi64 = np.zeros(n, dtype=np.uint64)

    def put(value, nbits, pos_arr):
        nonlocal lo64, hi64
        pos = pos_arr[0]
        v = value.astype(np.uint64) & np.uint64((1 << nbits) - 1)
        if pos < 64:
            lo64 = lo64 | (v << np.uint64(pos))
            if pos + nbits > 64:
                hi64 = hi64 | (v >> np.uint64(64 - pos))
        else:
            hi64 = hi64 | (v << np.uint64(pos - 64))
        pos_arr[0] = pos + nbits

    p = [0]
    put(np.full(n, 0b100000, dtype=np.int64), 6, p)       # mode 5
    put(np.zeros(n, dtype=np.int64), 2, p)                # rotation 0
    for ch in range(3):
        put(l2[:, ch], 7, p)
        put(h2[:, ch], 7, p)
    put(al, 8, p)
    put(ah, 8, p)
    # color indices: pixel 0 anchor has 1 bit, rest 2 bits
    put(idx[:, 0], 1, p)
    for i in range(1, 16):
        put(idx[:, i], 2, p)
    put(aidx[:, 0], 1, p)
    for i in range(1, 16):
        put(aidx[:, i], 2, p)
    assert p[0] == 128

    out = np.empty((n, 16), dtype=np.uint8)
    for b in range(8):
        out[:, b] = ((lo64 >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
        out[:, 8 + b] = ((hi64 >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(*shape, 16)


def etc1s_to_atc(endpoint_idx, selector_idx, color5, inten5, selectors):
    """ETC1S → ATC RGB blocks (BY,BX,8): c0=low palette color (555),
    c1=high (565); ATC's interpolants sit at exactly ETC1S's {0,3/8,5/8,1}
    line positions, so selectors map identity (convert_etc1s_to_atc analog)."""
    e = np.asarray(endpoint_idx)
    shape = e.shape
    pal = etc1s_palette(color5, inten5)[e.ravel()].astype(np.int64)
    sel = selectors[np.asarray(selector_idx).ravel()].astype(np.uint32)
    n = pal.shape[0]
    lo, hi = pal[:, 0, :], pal[:, 3, :]
    c0 = (((lo[:, 0] * 31 + 127) // 255) << 10) \
        | (((lo[:, 1] * 31 + 127) // 255) << 5) \
        | ((lo[:, 2] * 31 + 127) // 255)          # 555, mode bit 0
    c1 = (((hi[:, 0] * 31 + 127) // 255) << 11) \
        | (((hi[:, 1] * 63 + 127) // 255) << 5) \
        | ((hi[:, 2] * 31 + 127) // 255)          # 565
    bits = np.zeros(n, dtype=np.uint32)
    for i in range(16):
        bits |= sel[:, i] << (2 * i)
    out = np.empty((n, 8), dtype=np.uint8)
    out[:, 0] = c0 & 0xFF
    out[:, 1] = c0 >> 8
    out[:, 2] = c1 & 0xFF
    out[:, 3] = c1 >> 8
    for b in range(4):
        out[:, 4 + b] = (bits >> (8 * b)) & 0xFF
    return out.reshape(*shape, 8)


def values_to_bc4(vals):
    """(N, 16) int values [0,255] → BC4/BC3-alpha 8-byte blocks (N, 8).

    a0 > a1 8-interpolant mode; indices per the BC4 palette order
    [a0, a1, then 6 interpolants]."""
    vals = np.asarray(vals, dtype=np.int64)
    n = vals.shape[0]
    a0 = vals.max(axis=1)
    a1 = vals.min(axis=1)
    eq = a0 == a1
    a0 = np.where(eq & (a0 < 255), a0 + 1, a0)
    a1 = np.where(eq & (a0 == 255) & (a1 > 0), a1 - 1, a1)
    # both stuck (only possible if a0==a1==255... handled by +/-): final guard
    denom = np.maximum(a0 - a1, 1)
    # interpolant k (0..7): value = ((7-k)*a0 + k*a1)/7 ; solve nearest k
    t = np.clip(np.round(7.0 * (a0[:, None] - vals) / denom[:, None]), 0, 7).astype(np.int64)
    # map interpolation step k to BC4 index: 0→0 (a0), 7→1 (a1), else k+1
    idx = np.where(t == 0, 0, np.where(t == 7, 1, t + 1))
    out = np.zeros((n, 8), dtype=np.uint8)
    out[:, 0] = a0
    out[:, 1] = a1
    bits = np.zeros(n, dtype=np.uint64)
    for i in range(16):
        bits |= idx[:, i].astype(np.uint64) << np.uint64(3 * i)
    for b in range(6):
        out[:, 2 + b] = ((bits >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out


def etc1s_block_values(endpoint_idx, selector_idx, color5, inten5, selectors,
                       channel=1):
    """Per-pixel channel values of decoded ETC1S blocks: (N, 16) int.
    channel=1 (green) carries alpha in ETC1S alpha slices."""
    pal = etc1s_palette(color5, inten5)[np.asarray(endpoint_idx).ravel()]
    sel = selectors[np.asarray(selector_idx).ravel()].astype(np.int64)
    return np.take_along_axis(pal[:, :, channel], sel, axis=1)


# --- EAC A8 (ETC2 alpha) ---------------------------------------------------
# modifier tables from the ETC2/EAC spec
EAC_MODIFIERS = np.array([
    [-3, -6, -9, -15, 2, 5, 8, 14],
    [-3, -7, -10, -13, 2, 6, 9, 12],
    [-2, -5, -8, -13, 1, 4, 7, 12],
    [-2, -4, -6, -13, 1, 3, 5, 12],
    [-3, -6, -8, -12, 2, 5, 7, 11],
    [-3, -7, -9, -11, 2, 6, 8, 10],
    [-4, -7, -8, -11, 3, 6, 7, 10],
    [-3, -5, -8, -11, 2, 4, 7, 10],
    [-2, -6, -8, -10, 1, 5, 7, 9],
    [-2, -5, -8, -10, 1, 4, 7, 9],
    [-2, -4, -8, -10, 1, 3, 7, 9],
    [-2, -5, -7, -10, 1, 4, 6, 9],
    [-3, -4, -7, -10, 2, 3, 6, 9],
    [-1, -2, -3, -10, 0, 1, 2, 9],
    [-4, -6, -8, -9, 3, 5, 7, 8],
    [-3, -5, -7, -9, 2, 4, 6, 8],
], dtype=np.int64)


def values_to_eac_a8(vals, chunk: int = 8192):
    """(N,16) int [0,255] → EAC A8 blocks (N,8): search all (table, mult)
    candidates with per-pixel best selectors; base = block mean. Chunked over
    blocks and looped over the 16 tables to bound memory."""
    vals = np.asarray(vals, dtype=np.int64)
    n = vals.shape[0]
    out = np.zeros((n, 8), dtype=np.uint8)
    mults = np.arange(1, 16, dtype=np.int64)
    for c0 in range(0, n, chunk):
        v = vals[c0:c0 + chunk]                               # (C,16)
        cn = v.shape[0]
        base = np.clip(np.round(v.mean(axis=1)), 0, 255).astype(np.int64)
        best_err = np.full(cn, np.inf)
        best_tm = np.zeros((cn, 2), dtype=np.int64)
        best_sel = np.zeros((cn, 16), dtype=np.int64)
        for t in range(16):
            cand = EAC_MODIFIERS[t][None, :] * mults[:, None]     # (15,8)
            recon = np.clip(base[:, None, None] + cand[None], 0, 255).astype(np.float32)
            d = recon[:, :, :, None] - v[:, None, None, :].astype(np.float32)
            d2 = d * d                                            # (C,15,8,16)
            sel_t = np.argmin(d2, axis=2)                         # (C,15,16)
            err_t = np.min(d2, axis=2).sum(axis=-1)               # (C,15)
            bm = np.argmin(err_t, axis=1)
            rows = np.arange(cn)
            e = err_t[rows, bm]
            better = e < best_err
            best_err = np.where(better, e, best_err)
            best_tm[better, 0] = t
            best_tm[better, 1] = bm[better]
            best_sel[better] = sel_t[rows, bm][better]
        o = out[c0:c0 + chunk]
        o[:, 0] = base
        o[:, 1] = ((best_tm[:, 1] + 1) << 4) | best_tm[:, 0]
        # selectors: 3 bits/pixel, pixel order x*4+y, MSB-first across 6 bytes
        bits = np.zeros(cn, dtype=np.uint64)
        for x in range(4):
            for y in range(4):
                s = best_sel[:, y * 4 + x].astype(np.uint64)
                bits |= s << np.uint64(45 - 3 * (x * 4 + y))
        for b in range(6):
            o[:, 2 + b] = ((bits >> np.uint64(8 * (5 - b))) & np.uint64(0xFF)).astype(np.uint8)
    return out


def values_to_eac_r11(vals8, chunk: int = 8192):
    """(N,16) 8-bit values → EAC R11 blocks (N,8). Same bit layout as A8
    but 11-bit decode arithmetic: v11 = base*8+4 + mod*mult*8."""
    vals8 = np.asarray(vals8, dtype=np.int64)
    v11 = (vals8 * 2047 + 127) // 255
    n = vals8.shape[0]
    out = np.zeros((n, 8), dtype=np.uint8)
    mults = np.arange(1, 16, dtype=np.int64)
    for c0 in range(0, n, chunk):
        v = v11[c0:c0 + chunk]
        cn = v.shape[0]
        base = np.clip((v.mean(axis=1) - 4) / 8.0, 0, 255).round().astype(np.int64)
        best_err = np.full(cn, np.inf)
        best_tm = np.zeros((cn, 2), dtype=np.int64)
        best_sel = np.zeros((cn, 16), dtype=np.int64)
        for t in range(16):
            cand = EAC_MODIFIERS[t][None, :] * mults[:, None] * 8   # (15,8)
            recon = np.clip((base * 8 + 4)[:, None, None] + cand[None], 0, 2047).astype(np.float32)
            d = recon[:, :, :, None] - v[:, None, None, :].astype(np.float32)
            d2 = d * d
            sel_t = np.argmin(d2, axis=2)
            err_t = np.min(d2, axis=2).sum(axis=-1)
            bm = np.argmin(err_t, axis=1)
            rows = np.arange(cn)
            e = err_t[rows, bm]
            better = e < best_err
            best_err = np.where(better, e, best_err)
            best_tm[better, 0] = t
            best_tm[better, 1] = bm[better]
            best_sel[better] = sel_t[rows, bm][better]
        o = out[c0:c0 + chunk]
        o[:, 0] = base
        o[:, 1] = ((best_tm[:, 1] + 1) << 4) | best_tm[:, 0]
        bits = np.zeros(cn, dtype=np.uint64)
        for x in range(4):
            for y in range(4):
                s = best_sel[:, y * 4 + x].astype(np.uint64)
                bits |= s << np.uint64(45 - 3 * (x * 4 + y))
        for b in range(6):
            o[:, 2 + b] = ((bits >> np.uint64(8 * (5 - b))) & np.uint64(0xFF)).astype(np.uint8)
    return out


# --- generic RGBA block re-encoders (real-time class, like the reference's
# bc15 SPMD encoders, basisu_bc15_spmd.cpp) ----------------------------------

def _line_fit_weights(v, levels):
    """Fit a line to (N,16,C) values; return (lo, hi, per-texel level idx).
    levels: (L,) interpolation factors 0..64."""
    n = v.shape[0]
    mean = v.mean(axis=1, keepdims=True)
    c = v - mean
    cov = np.einsum("bif,big->bfg", c, c)
    d = np.ones((n, v.shape[2]), dtype=np.float64)
    for _ in range(6):
        d = np.einsum("bfg,bg->bf", cov, d)
        d /= (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
    proj = np.einsum("bif,bf->bi", c, d)
    lo = mean[:, 0] + d * proj.min(1, keepdims=True)
    hi = mean[:, 0] + d * proj.max(1, keepdims=True)
    # two LS refinement rounds
    for _ in range(2):
        rec = (lo[:, None, :] * (64.0 - levels)[None, :, None]
               + hi[:, None, :] * levels[None, :, None]) / 64.0   # (N,L,C)
        e = np.sum((v[:, :, None, :] - rec[:, None, :, :]) ** 2, -1)
        k = np.argmin(e, axis=-1)                                  # (N,16)
        a_k = (64.0 - levels[k]) / 64.0
        b_k = levels[k] / 64.0
        A = np.sum(a_k * a_k, 1); Bm = np.sum(a_k * b_k, 1); C = np.sum(b_k * b_k, 1)
        P = np.einsum("bi,bic->bc", a_k, v)
        Q = np.einsum("bi,bic->bc", b_k, v)
        det = A * C - Bm * Bm
        ok = np.abs(det) > 1e-9
        lo = np.where(ok[:, None], (C[:, None] * P - Bm[:, None] * Q) / np.where(ok, det, 1)[:, None], lo)
        hi = np.where(ok[:, None], (A[:, None] * Q - Bm[:, None] * P) / np.where(ok, det, 1)[:, None], hi)
        lo = np.clip(lo, 0, 255)
        hi = np.clip(hi, 0, 255)
    rec = (lo[:, None, :] * (64.0 - levels)[None, :, None]
           + hi[:, None, :] * levels[None, :, None]) / 64.0
    e = np.sum((v[:, :, None, :] - rec[:, None, :, :]) ** 2, -1)
    k = np.argmin(e, axis=-1)
    return lo, hi, k


_BC1_LEVELS = np.array([0, 64 / 3, 128 / 3, 64.0])   # c0, c2, c3, c1 order on line


def rgba_blocks_to_bc1(pixels):
    """(N,16,4) float/int RGBA → BC1 blocks (N,8). Real-time line-fit encode."""
    v = np.asarray(pixels, dtype=np.float64)[..., :3]
    lo, hi, k = _line_fit_weights(v, _BC1_LEVELS)
    n = v.shape[0]
    c0 = _pack_565(hi)   # hi at t=1 → but BC1 line param below maps explicitly
    c1 = _pack_565(lo)
    # k: 0→lo,1→1/3,2→2/3,3→hi along lo→hi; BC1 idx with c0=hi,c1=lo:
    # hi=c0(idx0), lo=c1(idx1), 2/3 point (closer to hi)=c2(idx2), 1/3=c3(idx3)
    k_to_idx = np.array([1, 3, 2, 0], dtype=np.uint32)
    idx = k_to_idx[k]
    swapped = c0 < c1
    c0s = np.where(swapped, c1, c0)
    c1s = np.where(swapped, c0, c1)
    flipm = np.array([1, 0, 3, 2], dtype=np.uint32)
    idx = np.where(swapped[:, None], flipm[idx], idx)
    eq = c0s == c1s
    can_dec = (c1s & 31) > 0
    c1s = np.where(eq & can_dec, c1s - 1, c1s)
    c0s = np.where(eq & ~can_dec, c0s + 1, c0s)
    bits = np.zeros(n, dtype=np.uint32)
    for i in range(16):
        bits |= idx[:, i].astype(np.uint32) << (2 * i)
    out = np.empty((n, 8), dtype=np.uint8)
    out[:, 0] = c0s & 0xFF
    out[:, 1] = c0s >> 8
    out[:, 2] = c1s & 0xFF
    out[:, 3] = c1s >> 8
    for b in range(4):
        out[:, 4 + b] = (bits >> (8 * b)) & 0xFF
    return out


def rgba_blocks_to_bc7_m5(pixels):
    """(N,16,4) RGBA → BC7 mode 5 blocks (N,16). Line-fit color + alpha."""
    v = np.asarray(pixels, dtype=np.float64)
    n = v.shape[0]
    levels = _BC7_M5_WEIGHTS.astype(np.float64)
    lo, hi, k = _line_fit_weights(v[..., :3], levels)
    a = v[..., 3]
    a_lo, a_hi = a.min(1), a.max(1)
    denom = np.maximum(a_hi - a_lo, 1e-9)
    ak = np.clip(np.round(3.0 * (a - a_lo[:, None]) / denom[:, None]), 0, 3).astype(np.int64)
    # anchor constraints
    flip_c = k[:, 0] >= 2
    k = np.where(flip_c[:, None], 3 - k, k)
    lo2 = np.where(flip_c[:, None], hi, lo)
    hi2 = np.where(flip_c[:, None], lo, hi)
    flip_a = ak[:, 0] >= 2
    ak = np.where(flip_a[:, None], 3 - ak, ak)
    al = np.where(flip_a, a_hi, a_lo)
    ah = np.where(flip_a, a_lo, a_hi)

    lo7 = np.clip(np.round(lo2 * 127.0 / 255.0), 0, 127).astype(np.int64)
    hi7 = np.clip(np.round(hi2 * 127.0 / 255.0), 0, 127).astype(np.int64)
    lo64 = np.zeros(n, dtype=np.uint64)
    hi64 = np.zeros(n, dtype=np.uint64)

    pos = [0]

    def put(value, nbits):
        p = pos[0]
        val = value.astype(np.uint64) & np.uint64((1 << nbits) - 1)
        nonlocal lo64, hi64
        if p < 64:
            lo64 = lo64 | (val << np.uint64(p))
            if p + nbits > 64:
                hi64 = hi64 | (val >> np.uint64(64 - p))
        else:
            hi64 = hi64 | (val << np.uint64(p - 64))
        pos[0] = p + nbits

    put(np.full(n, 0b100000, np.int64), 6)
    put(np.zeros(n, np.int64), 2)
    for ch in range(3):
        put(lo7[:, ch], 7)
        put(hi7[:, ch], 7)
    put(np.round(al).astype(np.int64), 8)
    put(np.round(ah).astype(np.int64), 8)
    put(k[:, 0], 1)
    for i in range(1, 16):
        put(k[:, i], 2)
    put(ak[:, 0], 1)
    for i in range(1, 16):
        put(ak[:, i], 2)
    assert pos[0] == 128
    out = np.empty((n, 16), dtype=np.uint8)
    for b in range(8):
        out[:, b] = ((lo64 >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
        out[:, 8 + b] = ((hi64 >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out


# --- uncompressed raster outputs -------------------------------------------

def rgba_to_rgb565(img):
    img = np.asarray(img, dtype=np.int64)
    v = _pack_565(img[..., :3])
    return v.astype(np.uint16)


def rgba_to_bgr565(img):
    img = np.asarray(img, dtype=np.int64)
    v = _pack_565(img[..., [2, 1, 0]])
    return v.astype(np.uint16)


def rgba_to_rgba4444(img):
    img = np.asarray(img, dtype=np.int64)
    q = (img * 15 + 127) // 255
    return ((q[..., 0] << 12) | (q[..., 1] << 8)
            | (q[..., 2] << 4) | q[..., 3]).astype(np.uint16)


# ---------------------------------------------------------------------------
# FXT1 (CC_MIXED mode): pairs of DXT1-style 4x4 halves in one 8x4 block.
# Parity: transcoder/basisu_transcoder.cpp convert_etc1s_to_fxt1:2573 —
# transcode to DXT1 first, then repack.  FXT1's CC_MIXED stores 555 colors
# per half plus shared green-LSB bits; the anchor selector's MSB XOR
# recovers color0's green LSB, so the repack is near-lossless.
# ---------------------------------------------------------------------------

# per-2-bit-selector map DXT1{c0,c1,2/3c0,2/3c1} → FXT1{c0,lerp1,lerp2,c1}
_FXT1_SEL_MAP = np.array([0, 3, 1, 2], dtype=np.uint8)
_FXT1_SEL_BYTE = np.zeros(256, dtype=np.uint8)
for _b in range(256):
    _FXT1_SEL_BYTE[_b] = (
        _FXT1_SEL_MAP[_b & 3]
        | (_FXT1_SEL_MAP[(_b >> 2) & 3] << 2)
        | (_FXT1_SEL_MAP[(_b >> 4) & 3] << 4)
        | (_FXT1_SEL_MAP[(_b >> 6) & 3] << 6))
# right-half duplication of the x=3 selector (s_border_dup:2636)
_FXT1_BORDER_DUP = np.array([0, 85, 170, 255], dtype=np.uint8)


def bc1_to_fxt1(bc1_blocks):
    """(nby, nbx, 8) packed BC1 blocks → (nby, ceil(nbx/2), 16) FXT1
    CC_MIXED blocks (mode=1, alpha=0).  Each FXT1 block holds two 4x4
    halves; an odd trailing BC1 column fills only the left half with the
    right half duplicating its border column."""
    bc1_blocks = np.asarray(bc1_blocks, dtype=np.uint8)
    nby, nbx = bc1_blocks.shape[:2]
    u16 = bc1_blocks.view("<u2").reshape(nby, nbx, 4).astype(np.int64)
    low, high = u16[..., 0], u16[..., 1]
    sels = _FXT1_SEL_BYTE[bc1_blocks[..., 4:8]]            # (nby,nbx,4)

    r0, g0, b0 = (low >> 11) & 31, (low >> 5) & 63, low & 31
    r1, g1, b1 = (high >> 11) & 31, (high >> 5) & 63, high & 31
    g0_lsb, g1_lsb = g0 & 1, g1 & 1
    g0, g1 = g0 >> 1, g1 >> 1

    # anchor fixup: the (0,0) selector's MSB must equal g0_lsb ^ g1_lsb
    swap = ((sels[..., 0].astype(np.int64) >> 1) & 1) != (g0_lsb ^ g1_lsb)
    sels = np.where(swap[..., None], sels ^ 0xFF, sels)
    r0, r1 = np.where(swap, r1, r0), np.where(swap, r0, r1)
    g0, g1 = np.where(swap, g1, g0), np.where(swap, g0, g1)
    b0, b1 = np.where(swap, b1, b0), np.where(swap, b0, b1)
    g1_lsb = np.where(swap, g0_lsb, g1_lsb)

    nfx = (nbx + 1) // 2
    out = np.zeros((nby, nfx, 2), dtype=np.uint64)

    def hi_word(ra, ga, ba, rb, gb, bb, shift):
        w = (ba.astype(np.uint64) << np.uint64(shift)
             | ga.astype(np.uint64) << np.uint64(shift + 5)
             | ra.astype(np.uint64) << np.uint64(shift + 10)
             | bb.astype(np.uint64) << np.uint64(shift + 15)
             | gb.astype(np.uint64) << np.uint64(shift + 20)
             | rb.astype(np.uint64) << np.uint64(shift + 25))
        return w

    # left halves (even BC1 columns): colors 0/1 + defaults for 2/3
    le = slice(0, nbx, 2)
    out[..., 1] = (hi_word(r0[:, le], g0[:, le], b0[:, le],
                           r1[:, le], g1[:, le], b1[:, le], 0)
                   | hi_word(r0[:, le], g0[:, le], b0[:, le],
                             r1[:, le], g1[:, le], b1[:, le], 30)
                   | (g1_lsb[:, le].astype(np.uint64) * np.uint64(3)) << np.uint64(61)
                   | np.uint64(1) << np.uint64(63))        # mode=1, alpha=0
    lo_left = sels[:, le].astype(np.uint64)
    dup = _FXT1_BORDER_DUP[sels[:, le] >> 6].astype(np.uint64)
    lo = (lo_left[..., 0] | lo_left[..., 1] << np.uint64(8)
          | lo_left[..., 2] << np.uint64(16) | lo_left[..., 3] << np.uint64(24)
          | dup[..., 0] << np.uint64(32) | dup[..., 1] << np.uint64(40)
          | dup[..., 2] << np.uint64(48) | dup[..., 3] << np.uint64(56))
    out[..., 0] = lo

    # right halves (odd BC1 columns) overwrite color slots 2/3 + selectors
    if nbx > 1:
        ro = slice(1, nbx, 2)
        n_r = r0[:, ro].shape[1]
        hi = out[:, :n_r, 1]
        hi = hi & ~((np.uint64(0x3FFFFFFF) << np.uint64(30))
                    | (np.uint64(1) << np.uint64(62)))
        hi = hi | hi_word(r0[:, ro], g0[:, ro], b0[:, ro],
                          r1[:, ro], g1[:, ro], b1[:, ro], 30)
        hi = hi | (g1_lsb[:, ro].astype(np.uint64) << np.uint64(62))
        out[:, :n_r, 1] = hi
        lo_right = sels[:, ro].astype(np.uint64)
        lo2 = (lo_right[..., 0] << np.uint64(32)
               | lo_right[..., 1] << np.uint64(40)
               | lo_right[..., 2] << np.uint64(48)
               | lo_right[..., 3] << np.uint64(56))
        out[:, :n_r, 0] = (out[:, :n_r, 0]
                           & np.uint64(0x00000000FFFFFFFF)) | lo2
    if out.dtype.byteorder not in ("<", "="):  # pragma: no cover
        out = out.astype("<u8")
    return out.view(np.uint8).reshape(nby, nfx, 16)
