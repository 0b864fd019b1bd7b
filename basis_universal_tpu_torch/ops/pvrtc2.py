"""Copy of `basis_universal_tpu/ops/pvrtc2.py`.

PVRTC2 4bpp transcode targets (hard_flag=1, non-interpolated subset).

In the subset every real-world transcoder emits (parity:
transcoder/basisu_transcoder.cpp convert_etc1s_to_pvrtc2_rgb:7153 /
_rgba:7285, unpacker encoder/basisu_gpu_texture.cpp unpack_pvrtc2), PVRTC2
behaves like BC1/ATC: each 4x4 block is independent (no neighbor
interpolation), with colorA=554 / colorB=555 (opaque) or RGBA 4433/4443
(translucent) endpoints and a 4-level modulation ramp at {0, 3/8, 5/8, 1}.

The opaque (RGB) path reproduces the reference's table scheme exactly —
per-channel exhaustive (lo,hi) solutions over 10 shared selector
mappings — but computes the tables lazily with dense numpy scans instead
of shipping baked .inc files; output is bit-identical to the reference.
The RGBA path is our own construction (bounds quantization + per-texel
modulation argmin against the decoded RGBA): the reference's translucent
path runs a float 4D PCA per block whose exact arithmetic isn't worth
replicating bit-for-bit, so that path is quality-validated instead.  The
decoder below is an exact mirror and validated pixel-exactly.

Block layout: 4 modulation bytes (row-major, 2 bits/texel) then a 32-bit
color word, little-endian.  Blocks are stored in raster order (PVRTC2 has
no Morton swizzle requirement in this mode).
"""

import numpy as np

from .etc1 import ETC1_INTEN_TABLES, color5_to_8


def _nearest_tbl(expand):
    """nearest_tbl[c8] = q minimizing |expand[q] - c8| (ties → lower q)."""
    out = np.zeros(256, dtype=np.int64)
    exp = np.asarray(expand, dtype=np.int64)
    for c in range(256):
        out[c] = int(np.argmin(np.abs(exp - c)))
    return out


_V5 = np.arange(32, dtype=np.int64)
_EXP5 = (_V5 << 3) | (_V5 >> 2)

_V4 = np.arange(16, dtype=np.int64)
_B4_OP = (_V4 << 1) | (_V4 >> 3)            # opaque blue_a: 4 → 5 bit
EXP_OP5 = _EXP5
EXP_OP_B4 = _EXP5[_B4_OP]

_RG4_TR = (_V4 << 1) | (_V4 >> 3)           # translucent r/g: 4 → 5
EXP_TR_RG4 = _EXP5[_RG4_TR]
_V3 = np.arange(8, dtype=np.int64)
_B3_TR = (_V3 << 2) | (_V3 >> 1)            # translucent blue_a: 3 → 5
EXP_TR_B3 = _EXP5[_B3_TR]
_B4_TR = (_V4 << 1) | (_V4 >> 3)            # translucent blue_b: 4 → 5
EXP_TR_B4 = _EXP5[_B4_TR]
_A4_LO = _V3 << 1                            # alpha_a: (a<<1) → 4-bit
EXP_TR_A3_LO = (_A4_LO << 4) | _A4_LO
_A4_HI = (_V3 << 1) | 1                      # alpha_b: (a<<1)|1 (never 0)
EXP_TR_A3_HI = (_A4_HI << 4) | _A4_HI

N_OP5 = _nearest_tbl(EXP_OP5)
N_OP_B4 = _nearest_tbl(EXP_OP_B4)
N_TR_RG4 = _nearest_tbl(EXP_TR_RG4)
N_TR_B3 = _nearest_tbl(EXP_TR_B3)
N_TR_B4 = _nearest_tbl(EXP_TR_B4)
N_TR_A3_LO = _nearest_tbl(EXP_TR_A3_LO)
N_TR_A3_HI = _nearest_tbl(EXP_TR_A3_HI)


def _modulation_refit(ramp, px):
    """ramp (..., 4, C), px (..., 16, C) → (...,) uint32 modulation words
    via per-texel squared-error argmin."""
    d = px[..., :, None, :].astype(np.int64) - ramp[..., None, :, :]
    err = (d * d).sum(axis=-1)                          # (..., 16, 4)
    sel = err.argmin(axis=-1).astype(np.uint32)         # (..., 16)
    word = np.zeros(sel.shape[:-1], dtype=np.uint32)
    for i in range(16):
        word |= sel[..., i] << np.uint32(2 * i)
    return word


def _emit(mod_word, color_word):
    n = mod_word.size
    out = np.empty((n, 2), dtype=np.uint32)
    out[:, 0] = mod_word.ravel()
    out[:, 1] = color_word.ravel()
    return out.view(np.uint8).reshape(*mod_word.shape, 8)


def _opaque_words(c_lo, c_hi):
    """(..., 3) lo/hi RGB → PVRTC2 opaque color words + decoded ramp."""
    ra, ga, ba = N_OP5[c_lo[..., 0]], N_OP5[c_lo[..., 1]], N_OP_B4[c_lo[..., 2]]
    rb, gb, bb = N_OP5[c_hi[..., 0]], N_OP5[c_hi[..., 1]], N_OP5[c_hi[..., 2]]
    word = ((np.uint32(1) << np.uint32(31))                # opaque_flag
            | (rb.astype(np.uint32) << np.uint32(26))
            | (gb.astype(np.uint32) << np.uint32(21))
            | (bb.astype(np.uint32) << np.uint32(16))
            | (np.uint32(1) << np.uint32(15))              # hard_flag
            | (ra.astype(np.uint32) << np.uint32(10))
            | (ga.astype(np.uint32) << np.uint32(5))
            | (ba.astype(np.uint32) << np.uint32(1)))      # mod_flag=0
    a8 = np.stack([EXP_OP5[ra], EXP_OP5[ga], EXP_OP_B4[ba]], axis=-1)
    b8 = np.stack([EXP_OP5[rb], EXP_OP5[gb], EXP_OP5[bb]], axis=-1)
    ramp = np.stack([a8, (a8 * 5 + b8 * 3) // 8,
                     (a8 * 3 + b8 * 5) // 8, b8], axis=-2)  # (...,4,3)
    return word, ramp


def _trans_words(c_lo, c_hi):
    """(..., 4) lo/hi RGBA → PVRTC2 translucent color words + RGBA ramp."""
    ra, ga = N_TR_RG4[c_lo[..., 0]], N_TR_RG4[c_lo[..., 1]]
    ba, aa = N_TR_B3[c_lo[..., 2]], N_TR_A3_LO[c_lo[..., 3]]
    rb, gb = N_TR_RG4[c_hi[..., 0]], N_TR_RG4[c_hi[..., 1]]
    bb, ab = N_TR_B4[c_hi[..., 2]], N_TR_A3_HI[c_hi[..., 3]]
    word = ((ab.astype(np.uint32) << np.uint32(28))
            | (rb.astype(np.uint32) << np.uint32(24))
            | (gb.astype(np.uint32) << np.uint32(20))
            | (bb.astype(np.uint32) << np.uint32(16))
            | (np.uint32(1) << np.uint32(15))              # hard_flag
            | (aa.astype(np.uint32) << np.uint32(12))
            | (ra.astype(np.uint32) << np.uint32(8))
            | (ga.astype(np.uint32) << np.uint32(4))
            | (ba.astype(np.uint32) << np.uint32(1)))      # opaque=0, mod=0
    a8 = np.stack([EXP_TR_RG4[ra], EXP_TR_RG4[ga],
                   EXP_TR_B3[ba], EXP_TR_A3_LO[aa]], axis=-1)
    b8 = np.stack([EXP_TR_RG4[rb], EXP_TR_RG4[gb],
                   EXP_TR_B4[bb], EXP_TR_A3_HI[ab]], axis=-1)
    ramp = np.stack([a8, (a8 * 5 + b8 * 3) // 8,
                     (a8 * 3 + b8 * 5) // 8, b8], axis=-2)  # (...,4,4)
    return word, ramp


# ---------------------------------------------------------------------------
# Reference-exact ETC1S → PVRTC2 RGB scheme: per-channel exhaustive
# (lo,hi) solutions over 10 shared selector mappings.  The reference bakes
# these as .inc tables (g_etc1s_to_atc_55 / g_etc1s_to_pvrtc2_45,
# generated by the loops around basisu_transcoder.cpp:6734); we compute
# the identical tables lazily with dense numpy scans.
# ---------------------------------------------------------------------------

_SEL_MAPPINGS = np.array([
    [0, 0, 1, 1], [0, 0, 1, 2], [0, 0, 1, 3], [0, 0, 2, 3],
    [0, 1, 1, 1], [0, 1, 2, 2], [0, 1, 2, 3], [0, 2, 3, 3],
    [1, 2, 2, 2], [1, 2, 3, 3]], dtype=np.int64)
_IDENTITY_MAPPING = 6
_SEL_RANGES = [(0, 3), (1, 3), (0, 2), (1, 2), (2, 3), (0, 1)]
_RANGE_INDEX = np.zeros((4, 4), dtype=np.int64)
for _i, (_l, _h) in enumerate(_SEL_RANGES):
    _RANGE_INDEX[_l, _h] = _i

_tables_cache = {}


def _palette_256():
    """pal[inten*32 + g, s] = clamp(expand5(g) + inten_table[inten][s])."""
    g = np.arange(32, dtype=np.int64)
    base8 = (g << 3) | (g >> 2)
    pal = base8[None, :, None] + ETC1_INTEN_TABLES[:, None, :]  # (8,32,4)
    return np.clip(pal, 0, 255).reshape(256, 4)


def _solution_table(exp_lo, exp_hi):
    """(256, 6, 10) arrays (lo, hi, err): exhaustive per-channel best
    endpoint pair per (inten*32+base, selector range, mapping); candidate
    scan order hi-outer/lo-inner with first-min tie-break, err_scale=5 on
    the extreme selectors of the (inten 7, range 0-3) case — exactly the
    reference's generator."""
    pal = _palette_256()                                    # (256,4)
    lo_q = np.arange(len(exp_lo), dtype=np.int64)
    hi_q = np.arange(len(exp_hi), dtype=np.int64)
    # candidate index = hi * n_lo + lo  (hi outer, lo inner)
    r0 = np.broadcast_to(exp_lo[None, :], (len(exp_hi), len(exp_lo)))
    r3 = np.broadcast_to(exp_hi[:, None], (len(exp_hi), len(exp_lo)))
    r0, r3 = r0.reshape(-1), r3.reshape(-1)                 # (P,)
    ramp = np.stack([r0, (r0 * 5 + r3 * 3) // 8,
                     (r3 * 5 + r0 * 3) // 8, r3], axis=-1)  # (P,4)
    n_lo = len(exp_lo)
    lo_of = np.tile(lo_q, len(exp_hi))
    hi_of = np.repeat(hi_q, n_lo)

    out_lo = np.zeros((256, 6, 10), dtype=np.int64)
    out_hi = np.zeros((256, 6, 10), dtype=np.int64)
    out_err = np.zeros((256, 6, 10), dtype=np.int64)
    inten_of_e = np.repeat(np.arange(8), 32)                # (256,)
    for sr, (lo_s, hi_s) in enumerate(_SEL_RANGES):
        for m in range(10):
            err = np.zeros((256, ramp.shape[0]), dtype=np.int64)
            for s in range(lo_s, hi_s + 1):
                d = pal[:, s, None] - ramp[None, :, _SEL_MAPPINGS[m, s]]
                scale = np.where(
                    (inten_of_e == 7) & (lo_s == 0) & (hi_s == 3)
                    & (s in (0, 3)), 5, 1)
                err += (d * d) * scale[:, None]
            best = err.argmin(axis=1)                       # first min
            out_lo[:, sr, m] = lo_of[best]
            out_hi[:, sr, m] = hi_of[best]
            out_err[:, sr, m] = np.minimum(err[np.arange(256), best], 0xFFFF)
    return out_lo, out_hi, out_err


def _match_table(size0, size1, sel):
    """Mirror of prepare_atc_single_color_table (:6400): best (lo,hi) for
    a single 8-bit value; scan lo-outer/hi-inner, first-min."""
    def expand(v, size):
        if size == 16:
            v5 = (v << 1) | (v >> 3)
            return (v5 << 3) | (v5 >> 2)
        if size == 32:
            return (v << 3) | (v >> 2)
        return (v << 2) | (v >> 4)

    lo = np.arange(size0, dtype=np.int64)
    hi = np.arange(size1, dtype=np.int64)
    lo_e = expand(lo, size0)
    hi_e = expand(hi, size1)
    # candidate index = lo * size1 + hi
    le = np.repeat(lo_e, size1)
    he = np.tile(hi_e, size0)
    if sel == 1:
        vals = (le * 5 + he * 3) // 8
    else:
        vals = he
    i = np.arange(256, dtype=np.int64)
    e = np.abs(vals[None, :] - i[:, None])
    best = e.argmin(axis=1)
    return best // size1, best % size1                      # (m_lo, m_hi)


def _pvrtc2_tables():
    if "rgb" not in _tables_cache:
        v5 = np.arange(32, dtype=np.int64)
        e5 = (v5 << 3) | (v5 >> 2)
        v4 = np.arange(16, dtype=np.int64)
        v4_5 = (v4 << 1) | (v4 >> 3)
        e45 = (v4_5 << 3) | (v4_5 >> 2)
        _tables_cache["rgb"] = {
            "t55": _solution_table(e5, e5),
            "t45": _solution_table(e45, e5),
            "match55_1": _match_table(32, 32, 1),
            "match45_1": _match_table(16, 32, 1),
            "match5_3": _match_table(1, 32, 3),
            "match4_3": _match_table(1, 16, 3),
        }
    return _tables_cache["rgb"]


def etc1s_to_pvrtc2_4_rgb(endpoint_idx, selector_idx, color5, inten5,
                          selectors):
    """ETC1S slice → opaque PVRTC2 blocks (BY, BX, 8); bit parity with
    convert_etc1s_to_pvrtc2_rgb:7153 (solid, inten-7-extreme, and
    table-mapped general cases)."""
    t = _pvrtc2_tables()
    shape = np.asarray(endpoint_idx).shape
    base5 = np.asarray(color5, dtype=np.int64)[endpoint_idx].reshape(-1, 3)
    it = np.asarray(inten5, dtype=np.int64)[endpoint_idx].reshape(-1)
    sel = np.asarray(selectors, dtype=np.int64)[selector_idx].reshape(-1, 16)
    base8 = color5_to_8(base5.astype(np.int32)).astype(np.int64)
    pal = np.clip(base8[:, None, :]
                  + ETC1_INTEN_TABLES[it][:, :, None], 0, 255)  # (N,4,3)

    lo_s, hi_s = sel.min(axis=1), sel.max(axis=1)
    n_unique = np.zeros_like(lo_s)
    for s in range(4):
        n_unique += (sel == s).any(axis=1)

    # --- general case: per-channel table solutions over shared mappings
    sr = np.where(lo_s < hi_s, _RANGE_INDEX[lo_s, hi_s], 0)
    e_r = it * 32 + base5[:, 0]
    e_g = it * 32 + base5[:, 1]
    e_b = it * 32 + base5[:, 2]
    t55_lo, t55_hi, t55_err = t["t55"]
    t45_lo, t45_hi, t45_err = t["t45"]
    tot_err = (t55_err[e_r][np.arange(len(sr)), sr]
               + t55_err[e_g][np.arange(len(sr)), sr]
               + t45_err[e_b][np.arange(len(sr)), sr])       # (N,10)
    m_best = tot_err.argmin(axis=1)                          # (N,)
    ar = np.arange(len(sr))
    ra = t55_lo[e_r, sr, m_best]
    ga = t55_lo[e_g, sr, m_best]
    ba = t45_lo[e_b, sr, m_best]
    rb = t55_hi[e_r, sr, m_best]
    gb = t55_hi[e_g, sr, m_best]
    bb = t45_hi[e_b, sr, m_best]
    gen_mod = _SEL_MAPPINGS[m_best[:, None], sel]            # (N,16)

    # --- solid case: single-color match tables, modulation all-1s
    c_solid = np.take_along_axis(pal, lo_s[:, None, None], axis=1)[:, 0, :]
    m55_lo, m55_hi = t["match55_1"]
    m45_lo, m45_hi = t["match45_1"]
    sol = {
        "ra": m55_lo[c_solid[:, 0]], "rb": m55_hi[c_solid[:, 0]],
        "ga": m55_lo[c_solid[:, 1]], "gb": m55_hi[c_solid[:, 1]],
        "ba": m45_lo[c_solid[:, 2]], "bb": m45_hi[c_solid[:, 2]],
    }

    # --- inten-7 extreme case: selectors exactly {0,3}
    _, m5_hi = t["match5_3"]
    _, m4_hi = t["match4_3"]
    ext = {
        "ra": m5_hi[pal[:, 0, 0]], "rb": m5_hi[pal[:, 3, 0]],
        "ga": m5_hi[pal[:, 0, 1]], "gb": m5_hi[pal[:, 3, 1]],
        "ba": m4_hi[pal[:, 0, 2]], "bb": m5_hi[pal[:, 3, 2]],
    }

    is_solid = lo_s == hi_s
    is_ext = (~is_solid & (it >= 7) & (n_unique == 2)
              & (lo_s == 0) & (hi_s == 3))

    def pick(gen, so, ex):
        return np.where(is_solid, so, np.where(is_ext, ex, gen))

    ra = pick(ra, sol["ra"], ext["ra"])
    ga = pick(ga, sol["ga"], ext["ga"])
    ba = pick(ba, sol["ba"], ext["ba"])
    rb = pick(rb, sol["rb"], ext["rb"])
    gb = pick(gb, sol["gb"], ext["gb"])
    bb = pick(bb, sol["bb"], ext["bb"])

    word = ((np.uint32(1) << np.uint32(31))
            | (rb.astype(np.uint32) << np.uint32(26))
            | (gb.astype(np.uint32) << np.uint32(21))
            | (bb.astype(np.uint32) << np.uint32(16))
            | (np.uint32(1) << np.uint32(15))
            | (ra.astype(np.uint32) << np.uint32(10))
            | (ga.astype(np.uint32) << np.uint32(5))
            | (ba.astype(np.uint32) << np.uint32(1)))

    mod_sel = np.where(is_solid[:, None], 1,
                       np.where(is_ext[:, None], sel, gen_mod))
    mod_word = np.zeros(len(sr), dtype=np.uint32)
    for i in range(16):
        mod_word |= mod_sel[:, i].astype(np.uint32) << np.uint32(2 * i)

    return _emit(mod_word.reshape(shape), word.reshape(shape))


def etc1s_to_pvrtc2_4_rgba(endpoint_idx, selector_idx,
                           alpha_endpoint_idx, alpha_selector_idx,
                           color5, inten5, selectors):
    """ETC1S color+alpha slices → PVRTC2 RGBA blocks (BY, BX, 8).

    Blocks whose alpha never drops below 250 use the opaque mode (matching
    the reference's >= 250 cutoff, :7325); the rest use the translucent
    endpoints.  Per-texel modulation is refit against the decoded RGBA."""
    color5 = np.asarray(color5, dtype=np.int32)
    inten5 = np.asarray(inten5)
    selectors = np.asarray(selectors)

    base8 = color5_to_8(color5)[endpoint_idx]
    it = inten5[endpoint_idx]
    sel = selectors[selector_idx]
    pal = np.clip(base8[..., None, :]
                  + ETC1_INTEN_TABLES[it][..., :, None], 0, 255)
    px_rgb = np.take_along_axis(
        pal, sel[..., :, None].astype(np.int64), axis=-2)

    a_base8 = color5_to_8(color5)[alpha_endpoint_idx][..., 1]
    a_it = inten5[alpha_endpoint_idx]
    a_sel = selectors[alpha_selector_idx]
    a_pal = np.clip(a_base8[..., None] + ETC1_INTEN_TABLES[a_it], 0, 255)
    px_a = np.take_along_axis(a_pal, a_sel.astype(np.int64), axis=-1)

    px = np.concatenate([px_rgb, px_a[..., None]], axis=-1)  # (...,16,4)
    c_lo = np.concatenate([pal[..., 0, :],
                           a_pal.min(-1, keepdims=True)], axis=-1)
    c_hi = np.concatenate([pal[..., 3, :],
                           a_pal.max(-1, keepdims=True)], axis=-1)

    opaque = px_a.min(axis=-1) >= 250                       # (BY,BX)

    w_op, ramp_op = _opaque_words(c_lo[..., :3], c_hi[..., :3])
    ramp_op4 = np.concatenate(
        [ramp_op, np.full(ramp_op.shape[:-1] + (1,), 255, ramp_op.dtype)],
        axis=-1)
    w_tr, ramp_tr = _trans_words(c_lo, c_hi)

    word = np.where(opaque, w_op, w_tr)
    ramp = np.where(opaque[..., None, None], ramp_op4, ramp_tr)
    return _emit(_modulation_refit(ramp, px), word)


def rgba_blocks_to_pvrtc2(blocks, has_alpha):
    """(BY, BX, 4, 4, 4) uint8 RGBA → PVRTC2 blocks (UASTC path:
    per-block bounds + modulation argmin, analogous to our PVRTC1)."""
    nby, nbx = blocks.shape[:2]
    px = blocks.reshape(nby, nbx, 16, 4).astype(np.int64)
    c_lo, c_hi = px.min(axis=2), px.max(axis=2)
    if has_alpha:
        opaque = px[..., 3].min(axis=-1) >= 250
        w_op, ramp_op = _opaque_words(c_lo[..., :3], c_hi[..., :3])
        ramp_op4 = np.concatenate(
            [ramp_op, np.full(ramp_op.shape[:-1] + (1,), 255, ramp_op.dtype)],
            axis=-1)
        w_tr, ramp_tr = _trans_words(c_lo, c_hi)
        word = np.where(opaque, w_op, w_tr)
        ramp = np.where(opaque[..., None, None], ramp_op4, ramp_tr)
        return _emit(_modulation_refit(ramp, px), word)
    word, ramp = _opaque_words(c_lo[..., :3], c_hi[..., :3])
    return _emit(_modulation_refit(ramp, px[..., :3]), word)


def unpack_pvrtc2(blocks):
    """(N, 8) PVRTC2 blocks → (N, 4, 4, 4) uint8 RGBA (exact mirror of
    encoder/basisu_gpu_texture.cpp unpack_pvrtc2 for the supported
    subset)."""
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, 8)
    words = blocks.view("<u4").astype(np.int64)
    mod_word, cw = words[:, 0], words[:, 1]
    hard = (cw >> 15) & 1
    modf = cw & 1
    if not (hard == 1).all() or not (modf == 0).all():
        raise ValueError("PVRTC2: only hard/non-interpolated supported")
    opaque = ((cw >> 31) & 1).astype(bool)

    # opaque decode
    a_op = np.stack([_EXP5[(cw >> 10) & 31], _EXP5[(cw >> 5) & 31],
                     EXP_OP_B4[(cw >> 1) & 15],
                     np.full_like(cw, 255)], axis=-1)
    b_op = np.stack([_EXP5[(cw >> 26) & 31], _EXP5[(cw >> 21) & 31],
                     _EXP5[(cw >> 16) & 31],
                     np.full_like(cw, 255)], axis=-1)
    # translucent decode
    a_tr = np.stack([EXP_TR_RG4[(cw >> 8) & 15], EXP_TR_RG4[(cw >> 4) & 15],
                     EXP_TR_B3[(cw >> 1) & 7],
                     EXP_TR_A3_LO[(cw >> 12) & 7]], axis=-1)
    b_tr = np.stack([EXP_TR_RG4[(cw >> 24) & 15], EXP_TR_RG4[(cw >> 20) & 15],
                     EXP_TR_B4[(cw >> 16) & 15],
                     EXP_TR_A3_HI[(cw >> 28) & 7]], axis=-1)
    a = np.where(opaque[:, None], a_op, a_tr)
    b = np.where(opaque[:, None], b_op, b_tr)
    ramp = np.stack([a, (a * 5 + b * 3) // 8, (a * 3 + b * 5) // 8, b],
                    axis=1)                                  # (N,4,4)
    sel = (mod_word[:, None] >> (2 * np.arange(16))) & 3     # (N,16)
    out = np.take_along_axis(ramp, sel[..., None], axis=1)
    return out.astype(np.uint8).reshape(-1, 4, 4, 4)
