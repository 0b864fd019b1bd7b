"""Copy of `basis_universal_tpu/codecs/astc/hdr_encode.py`.

UASTC HDR 4x4 encoder: batched CEM-11 direct fit in qlog space.

TPU-first reformulation of the UASTC HDR 4x4 encoder
(encoder/basisu_uastc_hdr_4x4_enc.cpp): blocks are standard ASTC HDR —
we emit CEM 11 (HDR RGB direct) single-partition blocks with a 4x4 3-bit
weight grid and 8-bit (ISE range 20) endpoint values, the one layout whose
inferred endpoint range is exactly byte-valued so the CEM-11 mode/flag bits
survive quantization. Endpoints are per-channel qlog min/max (the maj=3
'direct' submode: R,G qlog8 pairs + B qlog7 pair); weights are a dense
8-level argmin in qlog16 space. Effort scales the refinement passes.
"""

import functools

import numpy as np

from . import helpers as ah


@functools.lru_cache(maxsize=None)
def _qlog16_to_half_lut() -> np.ndarray:
    k = np.arange(65536, dtype=np.int64)
    e = (k & 0xF800) >> 11
    m = k & 0x7FF
    mt = np.where(m < 512, 3 * m, np.where(m >= 1536, 5 * m - 2048, 4 * m - 512))
    return ((e << 10) + (mt >> 3)).astype(np.uint16)


@functools.lru_cache(maxsize=None)
def _half_to_qlog16_lut() -> np.ndarray:
    """Inverse LUT: half bits (non-negative, finite) → qlog16.
    qlog16_to_half is monotonic non-decreasing; invert by first occurrence."""
    fwd = _qlog16_to_half_lut().astype(np.int64)
    inv = np.zeros(0x8000, dtype=np.uint16)
    # first qlog producing each half value (fwd is non-decreasing)
    firsts = np.searchsorted(fwd, np.arange(0x8000), side="left")
    inv[:] = np.clip(firsts, 0, 65535)
    return inv


def half_to_qlog16(half_bits: np.ndarray) -> np.ndarray:
    h = np.asarray(half_bits, dtype=np.uint16)
    return _half_to_qlog16_lut()[np.clip(h, 0, 0x7FFF).astype(np.int64)]


def float_to_half_bits(f: np.ndarray) -> np.ndarray:
    return np.asarray(np.clip(f, 0, 65504.0), dtype=np.float16).view(np.uint16)


def _eval_hdr_endpoints(e0_q12, e1_q12, wlevels, tgt_q, log_bias):
    """Per-texel best weight + total q-space error for decoded endpoints.

    e0_q12/e1_q12 (B,3) qlog12; wlevels (L,) dequantized [0,64] weights;
    tgt_q (B,nt,3) q-space targets. Returns (err (B,), weights (B,nt)).
    Error = 2*dR² + 3*dG² + dB² in the reference's q-space (eval_selectors,
    encoder/basisu_astc_hdr_common.cpp:1001).  Candidates whose endpoints
    decode to Inf/NaN halfs are rejected (err = +inf) — the reference
    transcoder refuses such blocks."""
    from . import hdr_modes as HM

    b, nt = tgt_q.shape[:2]
    L = wlevels.shape[0]
    lut = _qlog16_to_half_lut().astype(np.int64)
    le = (e0_q12.astype(np.int64) << 4)[:, None, :]        # (B,1,3)
    he = (e1_q12.astype(np.int64) << 4)[:, None, :]
    rec = (le * (64 - wlevels)[None, :, None]
           + he * wlevels[None, :, None] + 32) >> 6        # (B,L,3)
    rec_h = lut[np.clip(rec, 0, 65535)]
    rec_h = np.where((rec_h & 0x7C00) == 0x7C00, 0x7BFF, rec_h)  # Inf clamp
    rec_q = HM.half_to_qspace(rec_h.astype(np.uint16), log_bias)  # (B,L,3)
    bad = (e0_q12 > 3967).any(-1) | (e1_q12 > 3967).any(-1)       # (B,)

    err_tot = np.zeros(b)
    wsel = np.zeros((b, nt), dtype=np.int64)
    W = HM.RGB_ERR_WEIGHTS.astype(np.float32)
    rec32 = rec_q.astype(np.int32)
    tgt32 = tgt_q.astype(np.int32)
    CH = 8192
    for s in range(0, b, CH):
        e = s + CH
        d = (rec32[s:e, None, :, :]
             - tgt32[s:e, :, None, :]).astype(np.float32)    # (C,nt,L,3)
        pe = (d * d) @ W                                     # (C,nt,L)
        wsel[s:e] = pe.argmin(-1)
        err_tot[s:e] = pe.min(-1).sum(-1, dtype=np.float64)
    return np.where(bad, np.inf, err_tot), wsel


def _ls_line_q16(q16f, wlevels, wsel):
    """LS endpoints (B,3) given chosen weights: min Σ ||q - ((64-u)lo+u·hi)/64||²."""
    u = wlevels[wsel]                                        # (B,nt)
    a = (64.0 - u) / 64.0
    bb = u / 64.0
    A = (a * a).sum(1)
    Bm = (a * bb).sum(1)
    C = (bb * bb).sum(1)
    P = np.einsum("bi,bic->bc", a, q16f)
    Q = np.einsum("bi,bic->bc", bb, q16f)
    det = A * C - Bm * Bm
    ok = np.abs(det) > 1e-6
    dd = np.where(ok, det, 1.0)
    lo = np.clip((C[:, None] * P - Bm[:, None] * Q) / dd[:, None], 0, 65535)
    hi = np.clip((A[:, None] * Q - Bm[:, None] * P) / dd[:, None], 0, 65535)
    mean = q16f.mean(1)
    lo = np.where(ok[:, None], lo, mean)
    hi = np.where(ok[:, None], hi, mean)
    return lo, hi


def _ls_mode7_q16(q16f, wlevels, wsel):
    """LS (high color h (B,3), scale s (B,)) for rec = h - s*(64-u)/64."""
    a = (64.0 - wlevels[wsel]) / 64.0                        # (B,nt)
    am = a.mean(1, keepdims=True)
    qm = q16f.mean(1, keepdims=True)                         # (B,1,3)
    ac = a - am                                              # (B,nt)
    num = -(ac[..., None] * (q16f - qm)).sum(axis=(1, 2))
    den = np.maximum(3.0 * (ac * ac).sum(1), 1e-9)
    s = np.clip(num / den, 0, 65535)                         # (B,)
    h = np.clip(qm[:, 0] + s[:, None] * am, 0, 65535)
    return h, s


def plan_blocks_hdr_4x4(px_half: np.ndarray, effort: int = 1,
                        log_bias: float = None) -> dict:
    """Multi-mode UASTC HDR 4x4 trial search (TPU-batched analog of the
    reference's mode-11 submode / mode-7 sweep, encoder/
    basisu_uastc_hdr_4x4_enc.cpp:920-980 + basisu_astc_hdr_common.cpp
    pack_mode11/pack_mode7). Returns the per-block winning config:
    dict(cem (B,), wrange (B,), ep_codes (B,6) ISE symbols, weights (B,16),
    err (B,)). CEM 11 wranges 5-7 pair with endpoint ISE 20, wrange 8 with
    ISE 19; CEM 7 always ISE 20 — the combinations the reference
    transcoder's BC6H fast path accepts (basisu_transcoder.cpp:22680-22710).
    """
    from . import hdr_modes as HM

    if log_bias is None:
        log_bias = HM.Q_LOG_BIAS_4x4
    b = px_half.shape[0]
    q16 = half_to_qlog16(px_half).astype(np.int64)           # (B,16,3)
    q16f = q16.astype(np.float64)
    tgt_q = HM.half_to_qspace(px_half, log_bias)             # (B,16,3)

    # principal-axis line fit in qlog16 space
    mean = q16f.mean(1, keepdims=True)
    c = q16f - mean
    cov = np.einsum("bif,big->bfg", c, c)
    d = np.ones((b, 3))
    for _ in range(5):
        d = np.einsum("bfg,bg->bf", cov, d)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    proj = np.einsum("bif,bf->bi", c, d)
    lo0 = np.clip(mean[:, 0] + d * proj.min(1, keepdims=True), 0, 65535)
    hi0 = np.clip(mean[:, 0] + d * proj.max(1, keepdims=True), 0, 65535)

    # mode 7 initial: gray-axis line (h = brightest point, s = spread)
    t = q16f.mean(-1)                                        # (B,16)
    tmin, tmax = t.min(1), t.max(1)
    h7 = np.clip(mean[:, 0] + (tmax - t.mean(1))[:, None], 0, 65535)
    s7 = np.clip(tmax - tmin, 1, 65535)

    grayscale = (np.abs(q16[..., 0] - q16[..., 1]).max(1) == 0) \
        & (np.abs(q16[..., 0] - q16[..., 2]).max(1) == 0)

    # candidate configs
    m11_subs = list(range(-1, 8)) if effort >= 1 else [-1]
    m11_ranges = (6, 7, 8) if effort == 1 else \
        ((5, 6, 7, 8) if effort >= 2 else (5, 8))
    m7_subs = range(6) if effort >= 1 else (1, 5)
    m7_ranges = (8,) if effort <= 1 else (7, 8)

    @functools.lru_cache(maxsize=None)
    def _wlev(rng):
        return np.array([ah.dequant_weight(v, rng)
                         for v in range(ah.ise_levels(rng))])

    best_err = np.full(b, np.inf)
    best_cem = np.zeros(b, dtype=np.int64)
    best_sub = np.full(b, -1, dtype=np.int64)
    best_wrange = np.full(b, 5, dtype=np.int64)
    best_codes = np.zeros((b, 6), dtype=np.int64)
    best_w = np.zeros((b, 16), dtype=np.int64)

    def consider(cem, sub, wrange, ep_rng, vbytes, sel=None):
        """Evaluate one packed candidate over the `sel` subset of blocks
        (None = all) and fold improvements into the running best."""
        nonlocal best_err, best_cem, best_sub, best_wrange, best_codes, best_w
        idx = np.arange(b) if sel is None else sel
        codes, unq = HM.requantize(vbytes, ep_rng)
        if cem == 11:
            e0, e1 = HM.decode_mode11(unq)
        else:
            e0, e1 = HM.decode_mode7(unq)
        err, wsel = _eval_hdr_endpoints(e0, e1, _wlev(wrange), tgt_q[idx],
                                        log_bias)
        better = err < best_err[idx]
        if better.any():
            tgt_idx = idx[better]
            best_err[tgt_idx] = err[better]
            best_cem[tgt_idx] = cem
            best_sub[tgt_idx] = sub
            best_wrange[tgt_idx] = wrange
            best_codes[tgt_idx, :codes.shape[1]] = codes[better]
            best_w[tgt_idx] = wsel[better]

    for wrange in m11_ranges:
        ep_rng = 19 if wrange == 8 else 20
        for sub in m11_subs:
            if sub < 0:
                vb = HM.pack_mode11_direct(lo0, hi0)
            else:
                vb = HM.pack_mode11_submode(sub, lo0, hi0)
            consider(11, sub, wrange, ep_rng, vb)
    if effort >= 1 or grayscale.any():
        m7_sel = None if effort >= 1 else np.flatnonzero(grayscale)
        for wrange in m7_ranges:
            for sub in m7_subs:
                vb = HM.pack_mode7_submode(
                    sub, h7 if m7_sel is None else h7[m7_sel],
                    s7 if m7_sel is None else s7[m7_sel], wrange)
                consider(7, sub, wrange, 20, vb, sel=m7_sel)

    # LS refinement rounds: re-fit endpoints to each block's chosen
    # weights, then re-pack only the block's winning config family
    for _ in range(1 + (effort >= 2)):
        u = np.zeros((b, 16), dtype=np.int64)
        for wrange in set(best_wrange.tolist()):
            m = best_wrange == wrange
            u[m] = _wlev(wrange)[best_w[m]]
        lo_r, hi_r = _ls_line_q16(q16f, np.arange(65), u)
        h_r, s_r = _ls_mode7_q16(q16f, np.arange(65), u)
        groups = {}
        for i in range(b):
            groups.setdefault(
                (int(best_cem[i]), int(best_sub[i]), int(best_wrange[i])),
                []).append(i)
        for (cem, sub, wrange), idx_list in groups.items():
            sel = np.asarray(idx_list, dtype=np.int64)
            ep_rng = 19 if (cem == 11 and wrange == 8) else 20
            if cem == 11:
                vb = (HM.pack_mode11_direct(lo_r[sel], hi_r[sel]) if sub < 0
                      else HM.pack_mode11_submode(sub, lo_r[sel], hi_r[sel]))
            else:
                vb = HM.pack_mode7_submode(sub, h_r[sel], s_r[sel], wrange)
            consider(cem, sub, wrange, ep_rng, vb, sel=sel)

    return dict(cem=best_cem, wrange=best_wrange, ep_codes=best_codes,
                weights=best_w, err=best_err, submode=best_sub)


def encode_blocks_hdr(px_half: np.ndarray, effort: int = 1) -> np.ndarray:
    """(B,16,3) uint16 half bits → (B,16) uint8 ASTC HDR blocks via the
    multi-mode CEM 11 submode / CEM 7 trial search."""
    plan = plan_blocks_hdr_4x4(px_half, effort)
    return pack_hdr_plan(plan, px_half)


def pack_hdr_plan(plan: dict, px_half: np.ndarray) -> np.ndarray:
    """Pack a plan_blocks_hdr_4x4 result into physical ASTC blocks."""
    from .hdr6x6_decode import pack_log_block

    b = px_half.shape[0]
    out = np.zeros((b, 16), dtype=np.uint8)
    cem = plan["cem"]
    wrange = plan["wrange"]
    codes = plan["ep_codes"]
    wsel = plan["weights"]
    # vectorized fast path: CEM 11 / wrange 5 / ep 20 uses the direct packer
    m = (cem == 11) & (wrange == 5)
    if m.any():
        out[m] = _pack_cem11_blocks(codes[m], wsel[m])
    rest = np.flatnonzero(~m)
    for i in rest:
        nv = 6 if cem[i] == 11 else 4
        blk = ah.LogBlock(
            grid_width=4, grid_height=4, dual_plane=False,
            weight_ise_range=int(wrange[i]),
            endpoint_ise_range=19 if (cem[i] == 11 and wrange[i] == 8)
            else 20,
            num_partitions=1, cems=(int(cem[i]),),
            endpoints=[int(v) for v in codes[i, :nv]],
            weights=[int(v) for v in wsel[i]])
        out[i] = np.frombuffer(pack_log_block(blk), dtype=np.uint8)
    return out


# --- BC6H (unsigned half) mode-11 real-time encode ---------------------------

BC6H_WEIGHT4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                         60, 64], dtype=np.int64)


def _half_to_bc6h_unq(h: np.ndarray) -> np.ndarray:
    """Inverse of BC6H's unsigned finish: half = (x * 31) >> 6 →
    x ≈ ceil(half * 64 / 31), clamped to the 16-bit unquantized domain."""
    h = np.asarray(h, dtype=np.int64)
    return np.clip((h * 64 + 30) // 31, 0, 0xFFFF)


def _bc6h_unq_to_half(x: np.ndarray) -> np.ndarray:
    return ((np.asarray(x, dtype=np.int64) * 31) >> 6).astype(np.uint16)


def _bc6h_dequant10(q: np.ndarray) -> np.ndarray:
    """bc6h_dequantize(val, 10, unsigned)."""
    q = np.asarray(q, dtype=np.int64)
    return np.where(q == 0, 0,
                    np.where(q == 1023, 0xFFFF, ((q << 16) + 0x8000) >> 10))


def halfs_to_bc6h(px_half: np.ndarray) -> np.ndarray:
    """(B,16,3) uint16 half bits → (B,16) BC6H mode-11 blocks (one region,
    10-bit endpoints, 4-bit indices). Real-time class encoder."""
    b = px_half.shape[0]
    unq = _half_to_bc6h_unq(px_half)                      # (B,16,3) 0..FFFF
    lo = unq.min(axis=1)                                  # (B,3)
    hi = unq.max(axis=1)
    lo_q = lo >> 6                                        # 10-bit
    hi_q = -(-hi >> 6)
    hi_q = np.minimum(hi_q, 1023)
    lo_d = _bc6h_dequant10(lo_q)                          # decode-side values
    hi_d = _bc6h_dequant10(hi_q)
    # reconstruction for all 16 weights: (B,1,3,16)
    rec = (lo_d[:, None, :, None] * (64 - BC6H_WEIGHT4)
           + hi_d[:, None, :, None] * BC6H_WEIGHT4 + 32) >> 6
    rec_h = _bc6h_unq_to_half(rec).astype(np.int64)
    d = rec_h - px_half[..., None].astype(np.int64)
    err = (d * d).sum(axis=2)                             # (B,16,16w)
    idx = np.argmin(err, axis=-1).astype(np.int64)        # (B,16)
    # anchor texel 0 must have index < 8 (MSB implicit): swap ends + invert
    flip = idx[:, 0] >= 8
    idx = np.where(flip[:, None], 15 - idx, idx)
    l2 = np.where(flip[:, None], hi_q, lo_q)
    h2 = np.where(flip[:, None], lo_q, hi_q)

    lanes = np.zeros((b, 2), dtype=np.uint64)

    def wr(ofs, vals, nb):
        v = vals.astype(np.uint64) & np.uint64((1 << nb) - 1)
        if ofs < 64:
            lanes[:, 0] |= v << np.uint64(ofs)
            if ofs + nb > 64:
                lanes[:, 1] |= v >> np.uint64(64 - ofs)
        else:
            lanes[:, 1] |= v << np.uint64(ofs - 64)
        return ofs + nb

    ofs = wr(0, np.full(b, 0b00011), 5)                   # mode 11
    for c in range(3):
        ofs = wr(ofs, l2[:, c], 10)
    for c in range(3):
        ofs = wr(ofs, h2[:, c], 10)
    ofs = wr(ofs, idx[:, 0], 3)                           # anchor: 3 bits
    for i in range(1, 16):
        ofs = wr(ofs, idx[:, i], 4)
    assert ofs == 128
    return lanes.view(np.uint8).reshape(b, 16)


def unpack_bc6h_mode11(blocks) -> np.ndarray:
    """Validation decoder for our mode-11 BC6H blocks → (N,4,4,3) half bits."""
    blk = np.asarray(blocks, dtype=np.uint8).reshape(-1, 16)
    lanes = blk.view(np.uint64).reshape(-1, 2)
    n = blk.shape[0]

    def rd(ofs, nb):
        if ofs + nb <= 64:
            return (lanes[:, 0] >> np.uint64(ofs)) & np.uint64((1 << nb) - 1)
        if ofs >= 64:
            return (lanes[:, 1] >> np.uint64(ofs - 64)) & np.uint64((1 << nb) - 1)
        return ((lanes[:, 0] >> np.uint64(ofs))
                | (lanes[:, 1] << np.uint64(64 - ofs))) & np.uint64((1 << nb) - 1)

    assert (rd(0, 5) == 0b00011).all(), "not mode-11 blocks"
    ofs = 5
    lo = np.zeros((n, 3), dtype=np.int64)
    hi = np.zeros((n, 3), dtype=np.int64)
    for c in range(3):
        lo[:, c] = rd(ofs, 10).astype(np.int64); ofs += 10
    for c in range(3):
        hi[:, c] = rd(ofs, 10).astype(np.int64); ofs += 10
    idx = np.zeros((n, 16), dtype=np.int64)
    idx[:, 0] = rd(ofs, 3).astype(np.int64); ofs += 3
    for i in range(1, 16):
        idx[:, i] = rd(ofs, 4).astype(np.int64); ofs += 4
    lo_d = _bc6h_dequant10(lo)
    hi_d = _bc6h_dequant10(hi)
    w = BC6H_WEIGHT4[idx]                                 # (N,16)
    rec = (lo_d[:, None, :] * (64 - w)[..., None]
           + hi_d[:, None, :] * w[..., None] + 32) >> 6
    return _bc6h_unq_to_half(rec).reshape(n, 4, 4, 3)


def _pack_cem11_blocks(eps: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Pack single-partition CEM-11 blocks: 4x4 grid, 3-bit weights
    (range 5), byte endpoints (inferred ISE range 20)."""
    n = eps.shape[0]
    lanes = np.zeros((n, 2), dtype=np.uint64)

    def wr(ofs, vals, nb):
        v = vals.astype(np.uint64) & np.uint64((1 << nb) - 1)
        if ofs < 64:
            lanes[:, 0] |= v << np.uint64(ofs)
            if ofs + nb > 64:
                lanes[:, 1] |= v >> np.uint64(64 - ofs)
        else:
            lanes[:, 1] |= v << np.uint64(ofs - 64)
        return ofs + nb

    # block mode: grid 4x4, weight range 5 (3-bit plain), single plane.
    # Using decode row 0 (W = 4+w2, H = 2+h2): W=4 -> w2=0, H=4 -> h2=2;
    # range 5 => p=(5-... p-2 => p = (range)+2 when P=0: range 5 <= 5 means
    # P=1? weight_ise_range = (p - 2) + (P ? 6 : 0); range 5 needs P=0,p=7.
    p = 7  # p0..p2 bits
    # row0 layout: p0 at bit4, p1 at bit0, p2 at bit1; W bits 7-8, H bits 5-6
    bm = 0
    bm |= (p & 1) << 4        # p0
    bm |= ((p >> 1) & 1) << 0  # p1
    bm |= ((p >> 2) & 1) << 1  # p2
    # ensure bits[1:0] != 0 to select row family 0..4: p1/p2 at bits 0,1
    bm |= 0 << 9              # P flag
    bm |= 0 << 10             # Dp
    bm |= 0 << 7              # W - 4 = 0
    bm |= 2 << 5              # H - 2 = 2
    ofs = wr(0, np.full(n, bm), 11)
    ofs = wr(ofs, np.zeros(n), 2)             # partitions - 1 = 0
    ofs = wr(ofs, np.full(n, 11), 4)          # CEM 11
    for i in range(6):
        ofs = wr(ofs, eps[:, i], 8)
    # weights: 3-bit plain ISE, reversed bitstream from bit 127 down
    wstream = np.zeros(n, dtype=np.uint64)
    for i in range(16):
        wstream |= (weights[:, i].astype(np.uint64) & np.uint64(7)) << np.uint64(3 * i)
    # reverse the 48-bit stream
    rev = np.zeros(n, dtype=np.uint64)
    tmp = wstream.copy()
    for _ in range(48):
        rev = (rev << np.uint64(1)) | (tmp & np.uint64(1))
        tmp >>= np.uint64(1)
    lanes[:, 1] |= rev << np.uint64(128 - 48 - 64)
    out = lanes.view(np.uint8).reshape(n, 16)
    return out


# --- ASTC HDR 6x6 multi-mode planner -----------------------------------------

# 1-partition rows of the 6x6i block-mode table (hdr6x6_tables.py): the
# shared trial set for BOTH the raw-ASTC 6x6 codec and the intermediate
# stream — every row maps 1:1 onto a valid physical ASTC block (the
# coding ISE ranges equal the decoder-inferred ranges).
_DESC_1PART_CEM11 = tuple(range(0, 11))
_DESC_1PART_CEM7 = tuple(range(11, 18))


def plan_blocks_hdr_6x6(px_half: np.ndarray, effort: int = 1) -> dict:
    """Multi-mode trial search over the 6x6 1-partition block-mode set
    (TPU-batched analog of encoder/basisu_astc_hdr_6x6_enc.cpp's candidate
    sweep; CEM 11 submodes + CEM 7 via codecs/astc/hdr_modes).

    px_half (B,36,3) uint16 half bits. Returns dict(desc (B,) index into
    hdr6x6_tables.BLOCK_MODE_DESCS, submode (B,), ep_codes (B,6) ISE
    symbols at the desc's endpoint range, w_codes (B,36) ISE weight
    symbols at the desc's range, err (B,))."""
    from . import hdr6x6_tables as HT
    from . import hdr_modes as HM

    log_bias = HM.Q_LOG_BIAS_6x6
    b = px_half.shape[0]
    q16 = half_to_qlog16(px_half).astype(np.int64)           # (B,36,3)
    q16f = q16.astype(np.float64)
    tgt_q = HM.half_to_qspace(px_half, log_bias)

    mean = q16f.mean(1, keepdims=True)
    c = q16f - mean
    cov = np.einsum("bif,big->bfg", c, c)
    d = np.ones((b, 3))
    for _ in range(5):
        d = np.einsum("bfg,bg->bf", cov, d)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    proj = np.einsum("bif,bf->bi", c, d)
    lo0 = np.clip(mean[:, 0] + d * proj.min(1, keepdims=True), 0, 65535)
    hi0 = np.clip(mean[:, 0] + d * proj.max(1, keepdims=True), 0, 65535)
    t = q16f.mean(-1)
    h7 = np.clip(mean[:, 0] + (t.max(1) - t.mean(1))[:, None], 0, 65535)
    s7 = np.clip(t.max(1) - t.min(1), 1, 65535)

    descs = list(_DESC_1PART_CEM11) + list(_DESC_1PART_CEM7)
    if effort <= 0:
        descs = [0, 1, 8, 9, 12, 13]
    m11_subs = list(range(-1, 8)) if effort >= 1 else [-1]
    m7_subs = list(range(6)) if effort >= 1 else [1, 5]

    lut = _qlog16_to_half_lut().astype(np.int64)
    W = HM.RGB_ERR_WEIGHTS.astype(np.float32)

    best_err = np.full(b, np.inf)
    best_desc = np.zeros(b, dtype=np.int64)
    best_sub = np.full(b, -1, dtype=np.int64)
    best_ep = np.zeros((b, 6), dtype=np.int64)
    best_w = np.zeros((b, 36), dtype=np.int64)

    @functools.lru_cache(maxsize=None)
    def _wlev(rng):
        return np.array([ah.dequant_weight(v, rng)
                         for v in range(ah.ise_levels(rng))])

    def eval_desc(desc_i, e0, e1, sel, sub_arr, codes_ep):
        """Fit weights + eval error for decoded endpoints over block subset
        sel; fold improvements."""
        nonlocal best_err, best_desc, best_sub, best_ep, best_w
        (_dp, cem, _np_, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
            HT.BLOCK_MODE_DESCS[desc_i]
        m_in, pinv = _infill_matrix(gx, gy, 6, 6)
        levels = _wlev(w_r)
        q = q16f[sel]
        le = (e0.astype(np.int64) << 4)
        he = (e1.astype(np.int64) << 4)
        dd = (he - le).astype(np.float64)
        num = ((q - le[:, None, :]) * dd[:, None, :]).sum(-1)
        den = np.maximum((dd * dd).sum(-1), 1e-9)
        w_tex = np.clip(64.0 * num / den[:, None], 0, 64)    # (S,36)
        grid_f = np.clip(w_tex @ pinv.T, 0, 64)
        codes = np.abs(grid_f[..., None] - levels).argmin(-1)
        up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                      ).astype(np.int64) >> 6, 0, 64)        # (S,36)
        rec = (le[:, None, :] * (64 - up[..., None])
               + he[:, None, :] * up[..., None] + 32) >> 6
        rec_h = lut[np.clip(rec, 0, 65535)]
        rec_h = np.where((rec_h & 0x7C00) == 0x7C00, 0x7BFF, rec_h)
        rec_q = HM.half_to_qspace(rec_h.astype(np.uint16), log_bias)
        dq = (rec_q - tgt_q[sel]).astype(np.float32)
        err = ((dq * dq) @ W).sum(-1, dtype=np.float64)
        bad = (e0 > 3967).any(-1) | (e1 > 3967).any(-1)
        err = np.where(bad, np.inf, err)
        better = err < best_err[sel]
        if better.any():
            tgt_idx = sel[better]
            best_err[tgt_idx] = err[better]
            best_desc[tgt_idx] = desc_i
            best_sub[tgt_idx] = sub_arr[better] if isinstance(
                sub_arr, np.ndarray) else sub_arr
            best_ep[tgt_idx, :codes_ep.shape[1]] = codes_ep[better]
            best_w[tgt_idx, :codes.shape[1]] = codes[better]

    def endpoints_for_desc(desc_i, lo, hi, h7v, s7v):
        """Pick the best submode per block by endpoint fidelity, returning
        (e0, e1, ep ISE codes, submode per block)."""
        (_dp, cem, _np_, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
            HT.BLOCK_MODE_DESCS[desc_i]
        n = lo.shape[0]
        bd = np.full(n, np.inf)
        be0 = np.zeros((n, 3), dtype=np.int64)
        be1 = np.zeros((n, 3), dtype=np.int64)
        bc = np.zeros((n, 6 if cem == 11 else 4), dtype=np.int64)
        bs = np.full(n, -1, dtype=np.int64)
        subs = m11_subs if cem == 11 else m7_subs
        for sub in subs:
            if cem == 11:
                vb = (HM.pack_mode11_direct(lo, hi) if sub < 0
                      else HM.pack_mode11_submode(sub, lo, hi))
                codes, unq = HM.requantize(vb, e_r)
                e0, e1 = HM.decode_mode11(unq)
            else:
                vb = HM.pack_mode7_submode(sub, h7v, s7v, w_r)
                codes, unq = HM.requantize(vb, e_r)
                e0, e1 = HM.decode_mode7(unq)
            if cem == 11:
                dist = (((e0 << 4) - lo) ** 2).sum(-1) \
                    + (((e1 << 4) - hi) ** 2).sum(-1)
            else:
                dist = (((e1 << 4) - h7v) ** 2).sum(-1) \
                    + (((e1 - e0) << 4).mean(-1) - s7v) ** 2
            dist = np.where((e0 > 3967).any(-1) | (e1 > 3967).any(-1),
                            np.inf, dist)
            better = dist < bd
            bd = np.where(better, dist, bd)
            be0[better] = e0[better]
            be1[better] = e1[better]
            bc[better] = codes[better]
            bs[better] = sub
        return be0, be1, bc, bs

    all_sel = np.arange(b)
    for desc_i in descs:
        cem = HT.BLOCK_MODE_DESCS[desc_i][1]
        e0, e1, codes_ep_, subs_ = endpoints_for_desc(desc_i, lo0, hi0,
                                                      h7, s7)
        codes_ep = np.zeros((b, 6), dtype=np.int64)
        codes_ep[:, :codes_ep_.shape[1]] = codes_ep_
        eval_desc(desc_i, e0, e1, all_sel, subs_, codes_ep)

    # LS refinement on the winning desc per block
    for _ in range(1 + (effort >= 2)):
        u = np.zeros((b, 36), dtype=np.int64)
        for desc_i in set(best_desc.tolist()):
            m = best_desc == desc_i
            (_dp, cem, _np_, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
                HT.BLOCK_MODE_DESCS[desc_i]
            m_in, _ = _infill_matrix(gx, gy, 6, 6)
            gq = _wlev(w_r)[best_w[m][:, :gx * gy]]
            u[m] = np.clip((gq @ (m_in.T * 64.0) + 32
                            ).astype(np.int64) >> 6, 0, 64)
        lo_r, hi_r = _ls_line_q16(q16f, np.arange(65), u)
        h_r, s_r = _ls_mode7_q16(q16f, np.arange(65), u)
        for desc_i in set(best_desc.tolist()):
            sel = np.flatnonzero(best_desc == desc_i)
            e0, e1, codes_ep_, subs_ = endpoints_for_desc(
                desc_i, lo_r[sel], hi_r[sel], h_r[sel], s_r[sel])
            codes_ep = np.zeros((sel.shape[0], 6), dtype=np.int64)
            codes_ep[:, :codes_ep_.shape[1]] = codes_ep_
            eval_desc(desc_i, e0, e1, sel, subs_, codes_ep)

    return dict(desc=best_desc, submode=best_sub, ep_codes=best_ep,
                w_codes=best_w, err=best_err)


# --- ASTC HDR 6x6 encode (CEM 11 direct, 5x5 weight grid) --------------------


@functools.lru_cache(maxsize=None)
def _block_mode_table() -> dict:
    """(grid_w, grid_h, weight_range, dual_plane) → lowest 11-bit block
    mode, built from ONE scan of all 2048 modes (our spec decoder is the
    truth source)."""
    table = {}
    for bm in range(2048):
        cfg = ah.decode_block_mode_fields(bm)
        if cfg is not None:
            table.setdefault(cfg, bm)
    return table


def _find_block_mode(grid_w: int, grid_h: int, wrange: int) -> int:
    """11-bit single-plane block mode for a weight grid + range."""
    bm = _block_mode_table().get((grid_w, grid_h, wrange, False))
    if bm is None:
        raise ValueError(f"no block mode for {grid_w}x{grid_h} range {wrange}")
    return bm


@functools.lru_cache(maxsize=None)
def _infill_matrix(grid_w: int, grid_h: int, bw: int, bh: int) -> tuple:
    """(M, pinv(M)): per-texel weights as a linear map of grid weights
    (float model of the spec §18.11 infill)."""
    cols = []
    for j in range(grid_w * grid_h):
        grid = np.zeros(grid_w * grid_h, dtype=np.int64)
        grid[j] = 64
        up = ah.upsample_weights(grid, grid_w, grid_h, bw, bh)
        cols.append(np.asarray(up, dtype=np.float64) / 64.0)
    m = np.stack(cols, axis=1)                              # (bw*bh, gw*gh)
    return m, np.linalg.pinv(m)


def encode_blocks_hdr_6x6(px_half: np.ndarray, effort: int = 1,
                          quality: int = 100, nbx: int = 0) -> np.ndarray:
    """(B,36,3) uint16 half bits → (B,16) uint8 ASTC HDR 6x6 blocks via
    the multi-mode planner.

    quality < 100 enables the RDO substitution pass (the analog of the
    reference's lambda-driven rate control, encoder/
    basisu_astc_hdr_6x6_enc.h:16-121): blocks whose left/up neighbor
    decodes them within the lambda-scaled error budget reuse the
    neighbor's full encoding, turning Zstd into the rate lever. nbx =
    blocks per row (needed for the 'up' candidate; 0 = unknown, left
    only)."""
    from . import hdr6x6_tables as HT
    from .hdr6x6_decode import pack_log_block

    plan = plan_blocks_hdr_6x6(px_half, effort)
    b = px_half.shape[0]
    if quality < 100 and nbx:
        solid = (px_half.max(axis=1) == px_half.min(axis=1)).all(-1)
        _rdo_reuse_6x6i(plan, px_half, quality, nbx, solid, refit=False)
        _rdo_reuse_6x6i(plan, px_half, quality, nbx, solid, refit=True)
    out = np.zeros((b, 16), dtype=np.uint8)
    cache = {}
    for i in range(b):
        desc_i = int(plan["desc"][i])
        (_dp, cem, _np_, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
            HT.BLOCK_MODE_DESCS[desc_i]
        nv = 6 if cem == 11 else 4
        key = (desc_i, plan["ep_codes"][i, :nv].tobytes(),
               plan["w_codes"][i, :gx * gy].tobytes())
        got = cache.get(key)
        if got is None:
            blk = ah.LogBlock(
                grid_width=gx, grid_height=gy, dual_plane=False,
                weight_ise_range=w_r, endpoint_ise_range=e_r,
                num_partitions=1, cems=(cem,),
                endpoints=[int(v) for v in plan["ep_codes"][i, :nv]],
                weights=[int(v) for v in plan["w_codes"][i, :gx * gy]])
            got = cache[key] = np.frombuffer(pack_log_block(blk),
                                             dtype=np.uint8)
        out[i] = got
    return out


def _rdo_reuse_6x6i(plan: dict, px_half: np.ndarray, quality: int,
                    nbx: int, solid: np.ndarray,
                    refit: bool = True) -> None:
    """RDO pass shared by both 6x6 HDR codecs: push blocks onto a cheaper
    encoding within the quality-scaled error budget (the rate side of the
    reference's lambda RDO, encoder/basisu_astc_hdr_6x6_enc.h:16-121).

    refit=False — full copy of the neighbor's encoding (weights included):
    identical raster-consecutive blocks collapse into RUN records (6x6i)
    or Zstd matches (raw ASTC), the cheapest representation.
    refit=True — reuse the neighbor's mode + endpoints but refit this
    block's weights: codes as a 7-bit REUSE record (6x6i) or partial
    byte matches (raw ASTC)."""
    from . import hdr6x6_tables as HT
    from . import hdr_modes as HM

    b = px_half.shape[0]
    q16f = half_to_qlog16(px_half).astype(np.float64)
    tgt_q = HM.half_to_qspace(px_half, HM.Q_LOG_BIAS_6x6)
    lut = _qlog16_to_half_lut().astype(np.int64)
    W = HM.RGB_ERR_WEIGHTS.astype(np.float32)
    lam = ((100 - max(quality, 1)) / 50.0) ** 2 * 2.0
    finite = plan["err"][np.isfinite(plan["err"]) & ~solid]
    base = (np.median(finite) if finite.size else 0.0) + 1.0
    budget = lam * base

    for dj in (-1, -nbx, -nbx - 1):
        if nbx <= 1 and dj != -1:
            continue
        i_idx = np.arange(b)
        j_idx = i_idx + dj
        valid = (j_idx >= 0) & ~solid & ~solid[np.clip(j_idx, 0, b - 1)]
        if dj in (-1, -nbx - 1):
            valid &= (i_idx % nbx) != 0
        cand = np.flatnonzero(valid)
        if not cand.size:
            continue
        # skip blocks already identical to the neighbor
        same = (plan["desc"][cand] == plan["desc"][j_idx[cand]]) \
            & (plan["ep_codes"][cand] == plan["ep_codes"][j_idx[cand]]).all(-1)
        if refit:
            cand = cand[~same]
        else:
            same &= (plan["w_codes"][cand]
                     == plan["w_codes"][j_idx[cand]]).all(-1)
            cand = cand[~same]
        for desc_i in set(plan["desc"][j_idx[cand]].tolist()):
            sel = cand[plan["desc"][j_idx[cand]] == desc_i]
            if not sel.size:
                continue
            j_sel = j_idx[sel]
            (_dp, cem, _np_, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
                HT.BLOCK_MODE_DESCS[desc_i]
            nv = 6 if cem == 11 else 4
            _, unq_tab = HM.quant_tables(e_r)
            vbytes = unq_tab[plan["ep_codes"][j_sel][:, :nv]]
            if cem == 11:
                e0, e1 = HM.decode_mode11(vbytes)
            else:
                e0, e1 = HM.decode_mode7(vbytes)
            m_in, pinv = _infill_matrix(gx, gy, 6, 6)
            levels = np.array([ah.dequant_weight(v, w_r)
                               for v in range(ah.ise_levels(w_r))])
            q = q16f[sel]
            le = e0.astype(np.int64) << 4
            he = e1.astype(np.int64) << 4
            if refit:
                dd = (he - le).astype(np.float64)
                num = ((q - le[:, None, :]) * dd[:, None, :]).sum(-1)
                den = np.maximum((dd * dd).sum(-1), 1e-9)
                w_tex = np.clip(64.0 * num / den[:, None], 0, 64)
                grid_f = np.clip(w_tex @ pinv.T, 0, 64)
                codes = np.abs(grid_f[..., None] - levels).argmin(-1)
            else:
                codes = plan["w_codes"][j_sel][:, :gx * gy]
            up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                          ).astype(np.int64) >> 6, 0, 64)
            rec = (le[:, None, :] * (64 - up[..., None])
                   + he[:, None, :] * up[..., None] + 32) >> 6
            rec_h = lut[np.clip(rec, 0, 65535)]
            rec_h = np.where((rec_h & 0x7C00) == 0x7C00, 0x7BFF, rec_h)
            rec_q = HM.half_to_qspace(rec_h.astype(np.uint16),
                                      HM.Q_LOG_BIAS_6x6)
            dq = (rec_q - tgt_q[sel]).astype(np.float32)
            err = ((dq * dq) @ W).sum(-1, dtype=np.float64)
            accept = err <= plan["err"][sel] + budget
            acc = sel[accept]
            if acc.size:
                plan["desc"][acc] = desc_i
                plan["submode"][acc] = plan["submode"][j_idx[acc]]
                plan["ep_codes"][acc] = plan["ep_codes"][j_idx[acc]]
                plan["w_codes"][acc, :gx * gy] = codes[accept]
                plan["err"][acc] = err[accept]


def _encode_blocks_hdr_6x6_v1(px_half: np.ndarray,
                              effort: int = 1) -> np.ndarray:
    """Previous direct CEM-11 single-config encoder (kept as the effort-0
    fast path)."""
    b = px_half.shape[0]
    q16 = half_to_qlog16(px_half).astype(np.int64)          # (B,36,3)
    q12 = q16 >> 4
    lo12 = q12.min(axis=1)
    hi12 = q12.max(axis=1)
    prec = np.array([4, 4, 5])
    lo_q = lo12 >> prec
    hi_q = np.minimum(-(-hi12 >> prec.astype(np.int64)),
                      np.array([255, 255, 127]))
    le = (lo_q << prec) << 4                                # qlog16 (B,3)
    he = (hi_q << prec) << 4

    # continuous ideal texel weights via per-channel LS projection
    d = (he - le).astype(np.float64)                        # (B,3)
    num = ((q16 - le[:, None, :]) * d[:, None, :]).sum(-1)  # (B,36)
    den = np.maximum((d * d).sum(-1), 1e-9)
    w_tex = np.clip(64.0 * num / den[:, None], 0, 64)

    lut = _qlog16_to_half_lut().astype(np.int64)
    tgt_h = lut[np.clip(q16, 0, 65535)]                     # (B,36,3)

    # candidate weight-grid configs (plain-bit ISE ranges only): the
    # per-block argmin picks the grid whose infilled reconstruction wins
    configs = [(6, 6, 0, 1), (5, 5, 2, 2), (4, 4, 5, 3)]    # (gw,gh,rng,bits)
    if effort >= 2:
        configs.append((3, 3, 5, 3))
    cand_codes, cand_err = [], []
    for (gw, gh, rng, wb) in configs:
        m, pinv = _infill_matrix(gw, gh, 6, 6)
        grid_f = np.clip(w_tex @ pinv.T, 0, 64)             # (B,g)
        levels = np.array([ah.dequant_weight(v, rng)
                           for v in range(1 << wb)])
        codes = np.abs(grid_f[..., None] - levels).argmin(-1)
        # exact §18.11 infill of the dequantized grid, then half-space SSE
        gq = levels[codes]                                   # (B,g)
        up = np.clip((gq @ (m.T * 64.0) + 32).astype(np.int64) >> 6, 0, 64)
        rec = (le[:, None, :] * (64 - up[..., None])
               + he[:, None, :] * up[..., None] + 32) >> 6
        rec_h = lut[np.clip(rec, 0, 65535)]
        cand_err.append(((rec_h - tgt_h) ** 2).sum(axis=(1, 2)))
        cand_codes.append(codes)
    best = np.argmin(np.stack(cand_err, axis=1), axis=1)    # (B,)

    eps = np.zeros((b, 6), dtype=np.int64)
    eps[:, 0] = lo_q[:, 0]
    eps[:, 1] = hi_q[:, 0]
    eps[:, 2] = lo_q[:, 1]
    eps[:, 3] = hi_q[:, 1]
    eps[:, 4] = lo_q[:, 2] | 0x80
    eps[:, 5] = hi_q[:, 2] | 0x80

    out = np.zeros((b, 16), dtype=np.uint8)
    for ci, (gw, gh, rng, wb) in enumerate(configs):
        idx = np.flatnonzero(best == ci)
        if not idx.size:
            continue
        out[idx] = _pack_cem11_generic(
            eps[idx], cand_codes[ci][idx], gw, gh, rng, wb)
    return out


def _pack_cem11_generic(eps, codes, gw, gh, rng, wb):
    """Pack single-partition CEM-11 blocks with an arbitrary plain-bit
    weight grid (inferred endpoint range 20)."""
    n = eps.shape[0]
    lanes = np.zeros((n, 2), dtype=np.uint64)

    def wr(ofs, vals, nb):
        v = vals.astype(np.uint64) & np.uint64((1 << nb) - 1)
        if ofs < 64:
            lanes[:, 0] |= v << np.uint64(ofs)
            if ofs + nb > 64:
                lanes[:, 1] |= v >> np.uint64(64 - ofs)
        else:
            lanes[:, 1] |= v << np.uint64(ofs - 64)
        return ofs + nb

    bm = _find_block_mode(gw, gh, rng)
    ofs = wr(0, np.full(n, bm), 11)
    ofs = wr(ofs, np.zeros(n), 2)
    ofs = wr(ofs, np.full(n, 11), 4)
    for i in range(6):
        ofs = wr(ofs, eps[:, i], 8)
    nw = gw * gh
    nwb = nw * wb
    assert 24 <= nwb <= 96 and ofs + nwb <= 128
    wstream = np.zeros(n, dtype=np.uint64)
    for i in range(nw):
        wstream |= (codes[:, i].astype(np.uint64)
                    & np.uint64((1 << wb) - 1)) << np.uint64(wb * i)
    rev = np.zeros(n, dtype=np.uint64)
    tmp = wstream.copy()
    for _ in range(nwb):
        rev = (rev << np.uint64(1)) | (tmp & np.uint64(1))
        tmp >>= np.uint64(1)
    if nwb <= 64:
        lanes[:, 1] |= rev << np.uint64(128 - nwb - 64)
    else:  # pragma: no cover - all current configs fit in the top lane
        lanes[:, 1] |= rev >> np.uint64(nwb - 64)
        lanes[:, 0] |= rev << np.uint64(128 - nwb)
    return lanes.view(np.uint8).reshape(n, 16)
