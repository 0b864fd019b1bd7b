"""Copy of `basis_universal_tpu/ops/pvrtc1.py`.

PVRTC1 4bpp transcode targets + validation decoder.

PVRTC1 stores two low-frequency endpoint images (A/B) at block resolution
that the hardware bilinearly upscales 4x, plus 2 bits/texel of modulation
blending the two interpolated signals.  Transcoding ETC1S→PVRTC1 is a
two-pass algorithm (parity: transcoder/basisu_transcoder.cpp,
fixup_pvrtc1_4_modulation_rgb:3621 / _rgba:3798 and the cPVRTC1_4_RGB(A)
cases of transcode_slice at :8901/:8937):

  pass 1  per block: PVRTC endpoint A = floor-quantized min of the ETC1S
          block's RGB(A) bounding box, endpoint B = ceil-quantized max
          (pvrtc4_block::set_opaque_endpoint_floor/ceil:3309, 5554 packing).
  pass 2  per texel: pick the 2-bit modulation whose blend of the
          *bilinearly interpolated* endpoint lumas best matches the ETC1S
          texel luma.  The interpolation window wraps (PVRTC1 textures are
          power-of-two) so each block needs its 3x3 block neighborhood —
          expressed here as nine rolled copies of the endpoint-luma image,
          a dense stencil instead of the reference's sliding scalar window.

Blocks are stored Morton/swizzle order (g_pvrtc_swizzle_table:3000 is the
standard part1by1 bit spread, generated here), 8 bytes each: uint32
modulation then uint32 endpoints, little-endian.

The decoder below mirrors encoder/basisu_pvrtc1_4.h/.cpp
(pvrtc4_image::get_pixel / interpolate / get_interpolated_colors:300) so
transcode output can be validated pixel-exactly against the reference's
unpacked PNGs.
"""

import numpy as np

from .etc1 import ETC1_INTEN_TABLES, color5_to_8

# ---------------------------------------------------------------------------
# Quantization tables (derived from the PVRTC component expansions, parity
# with g_pvrtc_5/g_pvrtc_4/g_pvrtc_3/g_pvrtc_alpha, basisu_transcoder.cpp:3013)
# ---------------------------------------------------------------------------

_V5 = np.arange(32, dtype=np.int32)
EXPAND_5 = (_V5 << 3) | (_V5 >> 2)                       # 5-bit → 8-bit

_V4 = np.arange(16, dtype=np.int32)
_B4_AS5 = _V4 << 1
_B4_AS5 = _B4_AS5 | (_B4_AS5 >> 4)                       # ep0 blue: 4 → 5 bit
EXPAND_4 = EXPAND_5[_B4_AS5]                             # then 5 → 8

_V3 = np.arange(8, dtype=np.int32)
_B3_AS5 = (_V3 << 2) | (_V3 >> 1)                        # translucent ep0 blue
EXPAND_3 = EXPAND_5[_B3_AS5]

_A3 = np.arange(8, dtype=np.int32)
EXPAND_A3 = (_A3 << 1) * 17                              # 3-bit alpha → 8
EXPAND_A3 = np.concatenate([EXPAND_A3, [255]])           # [8] = opaque

# 4-bit components of translucent endpoints expand r |= r >> 4 style:
_R4_AS8 = (_V4 << 4) | _V4                               # == g_pvrtc_4? no —
# translucent r/g use (packed 4-bit << 1)|replication in 5554 space; their
# 8-bit expansion in get_endpoint_8888 is g_pvrtc_4 (same table as ep0 blue).


def _floor_tbl(expand):
    """floor_tbl[c8] = largest q with expand[q] <= c8 (clamped at 0)."""
    out = np.zeros(256, dtype=np.int32)
    for c in range(256):
        q = np.searchsorted(expand, c, side="right") - 1
        out[c] = max(q, 0)
    return out


def _ceil_tbl(expand):
    """ceil_tbl[c8] = smallest q with expand[q] >= c8."""
    out = np.zeros(256, dtype=np.int32)
    for c in range(256):
        q = np.searchsorted(expand, c, side="left")
        out[c] = min(q, len(expand) - 1)
    return out


P5_FLOOR, P5_CEIL = _floor_tbl(EXPAND_5), _ceil_tbl(EXPAND_5)
P4_FLOOR, P4_CEIL = _floor_tbl(EXPAND_4), _ceil_tbl(EXPAND_4)
P3_FLOOR, P3_CEIL = _floor_tbl(EXPAND_3), _ceil_tbl(EXPAND_3)
PA_FLOOR, PA_CEIL = _floor_tbl(EXPAND_A3), _ceil_tbl(EXPAND_A3)

# Bilinear weights per texel (ly*4+lx) over the 2x2 endpoint-block corners
# surrounding that texel's quadrant (g_pvrtc_bilinear_weights:3524; also the
# inline weights of the DO_PIX invocations in the fixup functions).
BILINEAR_W = np.array([
    [4, 4, 4, 4], [2, 6, 2, 6], [8, 0, 8, 0], [6, 2, 6, 2],
    [2, 2, 6, 6], [1, 3, 3, 9], [4, 0, 12, 0], [3, 1, 9, 3],
    [8, 8, 0, 0], [4, 12, 0, 0], [16, 0, 0, 0], [12, 4, 0, 0],
    [6, 6, 2, 2], [3, 9, 1, 3], [12, 0, 4, 0], [9, 3, 3, 1],
], dtype=np.int64)


def _part1by1(v):
    """Spread bits of v so bit k lands at position 2k (Morton helper)."""
    v = v.astype(np.uint32)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def swizzle_indices(nbx, nby):
    """(nby, nbx) array of the swizzled (Morton) block index for each
    raster-order block, incl. the reference's non-square handling
    (fixup_pvrtc1_4_modulation_rgb:3659)."""
    y = np.arange(nby, dtype=np.uint32)[:, None]
    x = np.arange(nbx, dtype=np.uint32)[None, :]
    sw = _part1by1(np.broadcast_to(y, (nby, nbx))) | (
        _part1by1(np.broadcast_to(x, (nby, nbx))) << np.uint32(1))
    if nbx != nby:
        x_bits = int(nbx - 1).bit_length()
        y_bits = int(nby - 1).bit_length()
        min_bits = min(x_bits, y_bits)
        mask = np.uint32((1 << (min_bits * 2)) - 1)
        sw = sw & mask
        if nbx > nby:
            sw = sw | ((x >> np.uint32(min_bits)) << np.uint32(min_bits * 2))
        else:
            sw = sw | ((y >> np.uint32(min_bits)) << np.uint32(min_bits * 2))
    return sw.astype(np.int64)


# ---------------------------------------------------------------------------
# Pass 2 core: modulation fit against the interpolated endpoint lumas
# ---------------------------------------------------------------------------


def _neighbor_grid(img):
    """(nby, nbx) → (3, 3, nby, nbx) wrapped-neighbor stack: entry [ey, ex]
    is the image shifted so [., ., by, bx] = img[by+ey-1, bx+ex-1] (wrap)."""
    return np.stack([
        np.stack([np.roll(img, (1 - ey, 1 - ex), axis=(0, 1))
                  for ex in range(3)], axis=0)
        for ey in range(3)], axis=0)


def _fit_modulation(l0, l1, luma16):
    """Per-texel 2-bit modulation (fixup DO_PIX math, :3722).

    l0/l1: (nby, nbx) int endpoint-A/B lumas.
    luma16: (nby, nbx, 16) texel luma * 16, idx = ly*4+lx.
    Returns (nby, nbx) uint32 packed modulation words.
    """
    nby, nbx = l0.shape
    g0 = _neighbor_grid(l0.astype(np.int64))               # (3,3,nby,nbx)
    g1 = _neighbor_grid(l1.astype(np.int64))
    mod_word = np.zeros((nby, nbx), dtype=np.uint32)
    for ly in range(4):
        ey = ly >> 1
        for lx in range(4):
            ex = lx >> 1
            w = BILINEAR_W[ly * 4 + lx]
            # corners a0..a3 = e[ex..ex+1][ey..ey+1] of the 3x3 window
            ca = (w[0] * g0[ey, ex] + w[1] * g0[ey, ex + 1]
                  + w[2] * g0[ey + 1, ex] + w[3] * g0[ey + 1, ex + 1])
            cb = (w[0] * g1[ey, ex] + w[1] * g1[ey, ex + 1]
                  + w[2] * g1[ey + 1, ex] + w[3] * g1[ey + 1, ex + 1])
            cl = luma16[:, :, ly * 4 + lx].astype(np.int64)
            d = cb - ca
            p = (cl - ca) * 16
            flip = ca > cb
            p = np.where(flip, -p, p)
            d = np.where(flip, -d, d)
            m = ((p > 3 * d).astype(np.uint32)
                 + (p > 8 * d).astype(np.uint32)
                 + (p > 13 * d).astype(np.uint32))
            mod_word |= m << np.uint32(ly * 8 + lx * 2)
    return mod_word


def _emit(mod_word, endpoints, nbx, nby):
    """Scatter (modulation, endpoints) block words into swizzled order and
    serialize little-endian (pvrtc4_block layout)."""
    sw = swizzle_indices(nbx, nby).ravel()
    out = np.zeros((nby * nbx, 2), dtype=np.uint32)
    out[sw, 0] = mod_word.ravel()
    out[sw, 1] = endpoints.ravel()
    if out.dtype.byteorder not in ("<", "="):  # pragma: no cover
        out = out.astype("<u4")
    return out.view(np.uint8).reshape(-1)


def _check_pow2(nbx, nby):
    if nbx & (nbx - 1) or nby & (nby - 1) or not nbx or not nby:
        raise ValueError(
            "PVRTC1 requires power-of-two dimensions "
            f"(got {nbx * 4}x{nby * 4})")


# ---------------------------------------------------------------------------
# ETC1S → PVRTC1
# ---------------------------------------------------------------------------


def etc1s_to_pvrtc1_4_rgb(endpoint_idx, selector_idx, color5, inten5,
                          selectors):
    """ETC1S slice → opaque PVRTC1 4bpp data (bit parity with the
    reference's cPVRTC1_4_RGB path :8901 + fixup :3621)."""
    nby, nbx = endpoint_idx.shape
    _check_pow2(nbx, nby)
    base8 = color5_to_8(np.asarray(color5, dtype=np.int32))[endpoint_idx]
    it = np.asarray(inten5)[endpoint_idx]                  # (nby,nbx)
    sel = np.asarray(selectors)[selector_idx]              # (nby,nbx,16)

    lo = sel.min(axis=-1)
    hi = sel.max(axis=-1)
    c_lo = np.clip(base8 + ETC1_INTEN_TABLES[it, lo][..., None], 0, 255)
    c_hi = np.clip(base8 + ETC1_INTEN_TABLES[it, hi][..., None], 0, 255)

    # endpoint A: floor quantize (554), endpoint B: ceil quantize (555)
    r0 = P5_FLOOR[c_lo[..., 0]]
    g0 = P5_FLOOR[c_lo[..., 1]]
    b0 = P4_FLOOR[c_lo[..., 2]] << 1
    w0 = 0x8000 | (r0 << 10) | (g0 << 5) | b0
    r1 = P5_CEIL[c_hi[..., 0]]
    g1 = P5_CEIL[c_hi[..., 1]]
    b1 = P5_CEIL[c_hi[..., 2]]
    w1 = 0x8000 | (r1 << 10) | (g1 << 5) | b1
    endpoints = (w0 | (w1 << 16)).astype(np.uint32)

    # opaque endpoint lumas, scaled to ~0..765 (get_opaque_endpoint_l0:3533)
    b0l = b0 | (b0 >> 4)
    l0 = ((r0 + g0 + b0l) * 255) // 31
    l1 = ((r1 + g1 + b1) * 255) // 31

    # texel luma*16 = (r8+g8+b8)*16 + 48*inten[sel]   (unclamped, :3690)
    luma16 = (base8.sum(axis=-1) * 16)[..., None] + \
        48 * ETC1_INTEN_TABLES[it[..., None], sel]

    mod_word = _fit_modulation(l0, l1, luma16)
    return _emit(mod_word, endpoints, nbx, nby)


def _endpoint_words_rgba(c, ceil, ep_index):
    """Vectorized pvrtc4_block::set_endpoint_floor/ceil (:3428/:3459).
    c: (..., 4) int RGBA.  Returns 16-bit packed endpoint."""
    a_tab = PA_CEIL if ceil else PA_FLOOR
    f5 = P5_CEIL if ceil else P5_FLOOR
    f4 = P4_CEIL if ceil else P4_FLOOR
    f3 = P3_CEIL if ceil else P3_FLOOR
    a3 = a_tab[c[..., 3]]
    opaque = a3 == 8

    # opaque: 554 (ep0) / 555 (ep1)
    ro, go = f5[c[..., 0]], f5[c[..., 1]]
    bo = f4[c[..., 2]] if ep_index == 0 else f5[c[..., 2]]
    if ep_index == 0:
        packed_o = 0x8000 | (ro << 10) | (go << 5) | (bo << 1)
    else:
        packed_o = 0x8000 | (ro << 10) | (go << 5) | bo

    # translucent: 3443 (ep0) / 3444 (ep1)
    rt, gt = f4[c[..., 0]], f4[c[..., 1]]
    bt = f3[c[..., 2]] if ep_index == 0 else f4[c[..., 2]]
    if ep_index == 0:
        packed_t = (a3 << 12) | (rt << 8) | (gt << 4) | (bt << 1)
    else:
        packed_t = (a3 << 12) | (rt << 8) | (gt << 4) | bt

    return np.where(opaque, packed_o, packed_t)


def _endpoint_l8(packed, ep_index):
    """Vectorized get_endpoint_l8 (:3202 via get_endpoint_8888): sum of the
    8-bit-expanded RGBA components of a 16-bit endpoint."""
    packed = packed.astype(np.int64)
    opaque = (packed & 0x8000) != 0

    r5 = (packed >> 10) & 31
    g5 = (packed >> 5) & 31
    b5 = packed & 31
    if ep_index == 0:
        bo = EXPAND_4[(b5 >> 1)]
    else:
        bo = EXPAND_5[b5]
    lo_sum = EXPAND_5[r5] + EXPAND_5[g5] + bo + 255

    r4 = (packed >> 8) & 0xF
    g4 = (packed >> 4) & 0xF
    b4 = packed & 0xF
    a3 = (packed >> 12) & 7
    if ep_index == 0:
        bt = EXPAND_3[b4 >> 1]
    else:
        bt = EXPAND_4[b4]
    lt_sum = EXPAND_4[r4] + EXPAND_4[g4] + bt + EXPAND_A3[a3]

    return np.where(opaque, lo_sum, lt_sum)


def etc1s_to_pvrtc1_4_rgba(endpoint_idx, selector_idx,
                           alpha_endpoint_idx, alpha_selector_idx,
                           color5, inten5, selectors):
    """ETC1S color+alpha slices → PVRTC1 4bpp RGBA data (parity:
    cPVRTC1_4_RGBA case :8937 + fixup_pvrtc1_4_modulation_rgba :3798)."""
    nby, nbx = endpoint_idx.shape
    _check_pow2(nbx, nby)
    color5 = np.asarray(color5, dtype=np.int32)
    inten5 = np.asarray(inten5)
    selectors = np.asarray(selectors)

    base8 = color5_to_8(color5)[endpoint_idx]              # (nby,nbx,3)
    it = inten5[endpoint_idx]
    sel = selectors[selector_idx]                          # (nby,nbx,16)
    lo, hi = sel.min(axis=-1), sel.max(axis=-1)
    c_lo = np.clip(base8 + ETC1_INTEN_TABLES[it, lo][..., None], 0, 255)
    c_hi = np.clip(base8 + ETC1_INTEN_TABLES[it, hi][..., None], 0, 255)

    # alpha bounds come from the alpha slice's green channel
    a_base8 = color5_to_8(color5)[alpha_endpoint_idx][..., 1]
    a_it = inten5[alpha_endpoint_idx]
    a_sel = selectors[alpha_selector_idx]
    a_lo = np.clip(a_base8 + ETC1_INTEN_TABLES[a_it, a_sel.min(-1)], 0, 255)
    a_hi = np.clip(a_base8 + ETC1_INTEN_TABLES[a_it, a_sel.max(-1)], 0, 255)

    c0 = np.concatenate([c_lo, a_lo[..., None]], axis=-1)
    c1 = np.concatenate([c_hi, a_hi[..., None]], axis=-1)

    w0 = _endpoint_words_rgba(c0, ceil=False, ep_index=0)
    w1 = _endpoint_words_rgba(c1, ceil=True, ep_index=1)
    endpoints = (w0 | (w1 << 16)).astype(np.uint32)

    l0 = _endpoint_l8(w0, 0)
    l1 = _endpoint_l8(w1, 1)

    # texel luma*16: clamped color sum + clamped alpha term (:3874)
    col16 = np.clip(
        (base8.sum(axis=-1) * 16)[..., None]
        + 48 * ETC1_INTEN_TABLES[it[..., None], sel],
        0, 48 * 255)
    alp16 = np.clip(
        (a_base8 * 16)[..., None]
        + 16 * ETC1_INTEN_TABLES[a_it[..., None], a_sel],
        0, 16 * 255)
    luma16 = col16 + alp16

    mod_word = _fit_modulation(l0, l1, luma16)
    return _emit(mod_word, endpoints, nbx, nby)


# ---------------------------------------------------------------------------
# RGBA blocks → PVRTC1 (UASTC path: bounding box + true texel lumas,
# parity: transcode_uastc_to_pvrtc1_4_rgb/_rgba in basisu_transcoder.cpp)
# ---------------------------------------------------------------------------


def rgba_blocks_to_pvrtc1(blocks, has_alpha):
    """(nby, nbx, 4, 4, 4) uint8 RGBA blocks → PVRTC1 4bpp data.

    Endpoints = floor/ceil-quantized per-block RGB(A) bounds; modulation is
    fit against the texels' luma (r+g+b [+a]), same stencil as the ETC1S
    path.  Matches the reference's UASTC→PVRTC1 real-time approach
    (per-block bounding box, luma modulation)."""
    nby, nbx = blocks.shape[:2]
    _check_pow2(nbx, nby)
    px = blocks.reshape(nby, nbx, 16, 4).astype(np.int64)
    c_lo = px.min(axis=2)                                  # (nby,nbx,4)
    c_hi = px.max(axis=2)

    if has_alpha:
        w0 = _endpoint_words_rgba(c_lo, ceil=False, ep_index=0)
        w1 = _endpoint_words_rgba(c_hi, ceil=True, ep_index=1)
        l0, l1 = _endpoint_l8(w0, 0), _endpoint_l8(w1, 1)
        luma16 = (px[..., 0] + px[..., 1] + px[..., 2]) * 16 + px[..., 3] * 16
    else:
        r0 = P5_FLOOR[c_lo[..., 0]]
        g0 = P5_FLOOR[c_lo[..., 1]]
        b0 = P4_FLOOR[c_lo[..., 2]] << 1
        w0 = 0x8000 | (r0 << 10) | (g0 << 5) | b0
        r1 = P5_CEIL[c_hi[..., 0]]
        g1 = P5_CEIL[c_hi[..., 1]]
        b1 = P5_CEIL[c_hi[..., 2]]
        w1 = 0x8000 | (r1 << 10) | (g1 << 5) | b1
        b0l = b0 | (b0 >> 4)
        l0 = ((r0 + g0 + b0l) * 255) // 31
        l1 = ((r1 + g1 + b1) * 255) // 31
        luma16 = (px[..., 0] + px[..., 1] + px[..., 2]) * 16

    endpoints = (w0 | (w1 << 16)).astype(np.uint32)
    mod_word = _fit_modulation(l0, l1, luma16)
    return _emit(mod_word, endpoints, nbx, nby)


# ---------------------------------------------------------------------------
# Decoder (validation): pvrtc4_image::get_pixel, basisu_pvrtc1_4.cpp:300
# ---------------------------------------------------------------------------


def _decode_endpoint_5554(packed, ep_index):
    """16-bit endpoint → (r5, g5, b5, a4) per get_endpoint_5554 (:3158)."""
    packed = packed.astype(np.int64)
    if ep_index == 0:
        packed = packed & 0xFFFE
    opaque = (packed & 0x8000) != 0

    r_o = (packed >> 10) & 31
    g_o = (packed >> 5) & 31
    b_o = packed & 31
    if ep_index == 0:
        b_o = b_o | (b_o >> 4)
    a_o = np.full_like(r_o, 0xF)

    r_t = (packed >> 7) & 0x1E
    g_t = (packed >> 3) & 0x1E
    b_t = (packed & 0xF) << 1
    r_t = r_t | (r_t >> 4)
    g_t = g_t | (g_t >> 4)
    if ep_index == 0:
        b_t = b_t | (b_t >> 3)
    else:
        b_t = b_t | (b_t >> 4)
    a_t = (packed >> 11) & 0xE

    pick = lambda o, t: np.where(opaque, o, t)  # noqa: E731
    return np.stack([pick(r_o, r_t), pick(g_o, g_t),
                     pick(b_o, b_t), pick(a_o, a_t)], axis=-1)


def unpack_pvrtc1_4(data, width, height):
    """PVRTC1 4bpp data → (height, width, 4) uint8 RGBA (exact mirror of
    the reference software decoder, for conformance tests)."""
    nbx, nby = width // 4, height // 4
    _check_pow2(nbx, nby)
    words = np.frombuffer(np.ascontiguousarray(data), dtype="<u4")
    words = words.reshape(nby * nbx, 2)
    sw = swizzle_indices(nbx, nby).ravel()
    mod_word = words[sw, 0].reshape(nby, nbx)
    endpoints = words[sw, 1].reshape(nby, nbx)

    ep0 = _decode_endpoint_5554(endpoints & 0xFFFF, 0)     # (nby,nbx,4)
    ep1 = _decode_endpoint_5554(endpoints >> 16, 1)
    trans_mod = (endpoints & 1).astype(bool)               # (nby,nbx)

    ys = np.arange(height)
    xs = np.arange(width)
    by0 = ((ys - 2) >> 2) % nby
    by1 = (by0 + 1) % nby
    bx0 = ((xs - 2) >> 2) % nbx
    bx1 = (bx0 + 1) % nbx
    u = np.array([2, 3, 0, 1], dtype=np.int64)[xs & 3]     # (W,)
    v = np.array([2, 3, 0, 1], dtype=np.int64)[ys & 3]     # (H,)

    def interp(ep):
        p = ep[by0[:, None], bx0[None, :]].astype(np.int64)   # (H,W,4)
        q = ep[by0[:, None], bx1[None, :]].astype(np.int64)
        r = ep[by1[:, None], bx0[None, :]].astype(np.int64)
        s = ep[by1[:, None], bx1[None, :]].astype(np.int64)
        t = p * 4 + u[None, :, None] * (q - p)
        b = r * 4 + u[None, :, None] * (s - r)
        val = t * 4 + v[:, None, None] * (b - t)
        rgb = val[..., :3] >> 1
        rgb = rgb + (rgb >> 5)
        a = val[..., 3:] + (val[..., 3:] >> 4)
        return np.concatenate([rgb, a], axis=-1)           # (H,W,4) 0..255

    ca = interp(ep0)
    cb = interp(ep1)

    m = (mod_word[(ys >> 2)[:, None], (xs >> 2)[None, :]]
         >> (((ys & 3)[:, None] * 4 + (xs & 3)[None, :]) * 2)) & 3
    tm = trans_mod[(ys >> 2)[:, None], (xs >> 2)[None, :]]

    std = np.select(
        [m[..., None] == 0, m[..., None] == 1, m[..., None] == 2],
        [ca, (ca * 5 + cb * 3) // 8, (ca * 3 + cb * 5) // 8],
        default=cb)
    avg = (ca + cb) // 2
    pt = np.select(
        [m[..., None] == 0, m[..., None] == 3], [ca, cb], default=avg)
    pt[..., 3] = np.where(m == 2, 0, pt[..., 3])
    out = np.where(tm[..., None], pt, std)
    return out.astype(np.uint8)
