"""Copy of `basis_universal_tpu/codecs/bc7/xbc7_encode.py`.

XUBC7 encoder v1: lossless BC7 supercompression.

Behavioral parity with the reference's xbc7 encode path (the encoder side
of transcoder/basisu_xbc7_decoder.h's format): given physical BC7 blocks,
emit the blob container (0xB7 magic, varint directory, per-blob Zstd) that
xbc7_decode reconstructs BYTE-EXACTLY.

v1 writes the lossless subset of the syntax:
  - CMD_REPEAT_LAST / CMD_REPEAT_UPPER when a block's physical bytes equal
    its left/upper neighbor (within the stripe tile),
  - CMD_SOLID_DPCM when the canonical solid encoding reproduces the block,
  - otherwise CMD_NEW_CONFIG + EP_RAW endpoints + absolute raw weights
    (wt_mode 0), which transports the logical block verbatim.

Stripes are the format's parallel-decode axis: blocks are coded per-stripe
with neighbor references clipped to the stripe tile, and a seek table
(byte/bit start offsets per stream) lets the decoder run stripes
concurrently — mirrored from xbc7_decode._decode_stripe.
"""

import dataclasses
import math
import struct

import numpy as np

from . import logical as L
from .xbc7_decode import (
    BLOB_MAGIC_BEGIN, BLOB_MAGIC_END,
    B_HEADER, B_COMMANDS, B_CONFIG, B_PART2, B_PART3, B_PREDICTORS,
    B_DC_SMALL, B_AC, B_SIGNS, B_PBITS,
    B_EP_FINE_R, B_EP_COARSE_R, B_EP_BLOCK_INDEX,
    B_EP_RAW, B_RAW_WEIGHTS, B_SOLID_DELTAS, B_SEEK,
    B_WT_RESID2, B_WT_RESID3, B_WT_RESID4,
    CMD_REPEAT_LAST, CMD_REPEAT_UPPER, CMD_SOLID_DPCM, CMD_NEW_CONFIG,
    CMD_REUSE_LEFT, CMD_REUSE_UPPER, CMD_REUSE_LDIAG, CMD_REUSE_RDIAG,
    EP_RAW, EP_DPCM_LEFT, EP_DPCM_UP, EP_DPCM_LDIAG, EP_DPCM_RDIAG,
    EP_DPCM_BLOCK_INDEX, EP_DPCM_LEFT_S1, EP_DPCM_UP_S1,
    CAND_ABSOLUTE, CAND_LU_BLEND, CAND_GRADIENT, CAND_MED,
    CAND_FIRST_XY_DELTA, TOTAL_CANDIDATES, ONE,
    XY_DELTAS, NUM_XY_DELTAS,
    dct_forward_weights, dct_inverse_weights,
    eval_weight_predictor, _stripe_ranges,
)

# m_ldr_channel_weights default (perceptual), basisu_comp.h:879-882
PERCEPTUAL_WEIGHTS = (9, 11, 1, 11)
UNIFORM_WEIGHTS = (1, 1, 1, 1)

# weight predictor shortlist: absolute + copy-left/up + the structural
# predictors that win most often (full 50-candidate search is the
# reference's encode-side speed/ratio knob; this subset captures the bulk
# of the gain at ~10% of the eval cost)
_WT_CANDS = (CAND_FIRST_XY_DELTA + 0,   # copy left block
             CAND_FIRST_XY_DELTA + 7,   # copy upper block
             CAND_LU_BLEND, CAND_GRADIENT, CAND_MED)


def _resid_cost(r: int, modulus: int) -> float:
    """Approximate entropy-coded size (bits) of a wrapped residual byte."""
    m = min(r, modulus - r)
    return 1.0 + 2.0 * math.log2(1.0 + m)


class _LsbBitWriter:
    """LSB-first bit writer sharing one buffer across stripes (the decoder's
    _LsbBits reads absolute bit offsets, so stripe streams are bit-packed
    back to back with no alignment)."""

    def __init__(self):
        self.bytes = bytearray()
        self.bit = 0

    def put(self, v: int, n: int):
        for i in range(n):
            if self.bit == len(self.bytes) * 8:
                self.bytes.append(0)
            if (v >> i) & 1:
                self.bytes[self.bit >> 3] |= 1 << (self.bit & 7)
            self.bit += 1


# ---------------------------------------------------------------------------
# "Poor man's RDO" pre-passes (parity: encoder/basisu_xbc7_encode.cpp:
# 1640-1935 block_reuse_rdo_pass / endpoint_dpcm_rdo_pass and the
# set_rdo_level(..) knob mapping :665-703). They run on the logical-block
# grid after the BC7 base pack and BEFORE stripe coding; serial per stripe
# (causal: each block predicts from already-finalized neighbors).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RdoOptions:
    """set_rdo_level analog: one [0,100] level fans out into per-pass
    tolerated PSNR drops (encoder/basisu_xbc7_encode.cpp:685-703)."""
    repeat_drop: float = 0.0        # dB a block may drop to become a Repeat
    solid_drop: float = 0.0         # ... to become a solid-color block
    endpoint_drop: float = 0.0      # ... to adopt a neighbor's endpoints
    min_block_psnr: float = 33.0    # shared quality floor (m_rdo_min_block_psnr)
    weights: tuple = PERCEPTUAL_WEIGHTS

    @classmethod
    def from_level(cls, level: int, perceptual: bool = True):
        level = max(0, min(int(level), 100))
        frac = level / 100.0
        w = PERCEPTUAL_WEIGHTS if perceptual else UNIFORM_WEIGHTS
        if not level:
            return cls(weights=w)
        return cls(repeat_drop=4.0 * frac, solid_drop=4.0 * frac,
                   endpoint_drop=10.0 * frac, weights=w)

    @property
    def enabled(self):
        return (self.repeat_drop > 0 or self.solid_drop > 0
                or self.endpoint_drop > 0)


_functools_dq = {}


def _dq_table(nb: int) -> np.ndarray:
    tab = _functools_dq.get(nb)
    if tab is None:
        tab = np.array([L.dequant_weight(w, nb) for w in range(1 << nb)],
                       np.int64)
        _functools_dq[nb] = tab
    return tab


def _block_geometry(blk):
    """(subs[16], eps[S,2,4]) for vectorized decode."""
    subs = np.array([L.texel_subset(blk, i) for i in range(16)], np.int64)
    eps = np.array([L.unpack_endpoints(blk, s)
                    for s in range(blk.num_partitions)], np.int64)
    return subs, eps


def _channel_planes(blk):
    """Storage-plane index driving each PRE-rotation channel (RGB, A)."""
    if blk.num_planes == 1:
        return [0, 0, 0, 0]
    sel = blk.mode4_index_selector
    return [sel, sel, sel, 1 - sel]


def _fast_unpack(blk) -> np.ndarray:
    """(16,4) int64 decoded RGBA — vectorized L.unpack_rgba."""
    subs, eps = _block_geometry(blk)
    planes = _channel_planes(blk)
    num_comps = blk.get_num_comps()
    out = np.empty((16, 4), np.int64)
    for c in range(4):
        if c == 3 and num_comps < 4:
            out[:, 3] = 255
            continue
        p = planes[c]
        wb = blk.weight_bits[p]
        dw = _dq_table(wb)[blk.weights[p]]
        lo, hi = eps[subs, 0, c], eps[subs, 1, c]
        out[:, c] = (lo * (64 - dw) + hi * dw + 32) >> 6
    if blk.dp_rotation_index:
        r = blk.dp_rotation_index - 1
        out[:, [r, 3]] = out[:, [3, r]]
    return out


def _wsse_psnr(src: np.ndarray, dec: np.ndarray, cw) -> float:
    """xbc7_block_wsse_psnr (encoder/basisu_xbc7_encode.cpp:440-450)."""
    d = src.astype(np.int64) - dec.astype(np.int64)
    wsse = int((d * d * np.asarray(cw, np.int64)).sum())
    wmse = wsse / (float(sum(cw)) * 16.0)
    return 10000.0 if wmse <= 1e-5 else \
        20.0 * math.log10(255.0 / math.sqrt(wmse))


def optimize_block_weights(blk, src_px: np.ndarray, cw):
    """Recompute optimal per-texel weights for FIXED config+endpoints
    (optimize_block_weights, encoder/basisu_xbc7_encode.cpp:452-530).
    Sweeps each plane's weight values; per-texel argmin of weighted SSE.
    Returns a new block (input untouched)."""
    out = blk.copy()
    subs, eps = _block_geometry(out)
    planes = _channel_planes(out)
    num_comps = out.get_num_comps()
    cw = np.asarray(cw, np.int64)
    src = src_px.astype(np.int64)
    if out.dp_rotation_index:
        # work in pre-rotation space: un-rotate the source instead
        r = out.dp_rotation_index - 1
        src = src.copy()
        src[:, [r, 3]] = src[:, [3, r]]
        cw = cw.copy()
        cw[[r, 3]] = cw[[3, r]]
    for p in range(out.num_planes):
        wb = out.weight_bits[p]
        nW = 1 << wb
        dwv = _dq_table(wb)                                   # (W,)
        err = np.zeros((nW, 16), np.int64)
        for c in range(4):
            if c == 3 and num_comps < 4:
                continue
            if planes[c] != p:
                continue
            lo, hi = eps[subs, 0, c], eps[subs, 1, c]         # (16,)
            dec = (lo[None] * (64 - dwv[:, None])
                   + hi[None] * dwv[:, None] + 32) >> 6       # (W,16)
            d = dec - src[None, :, c]
            err += d * d * int(cw[c])
        out.weights[p][:] = np.argmin(err, axis=0)
    return out


def _mean_solid_candidate(src_px: np.ndarray, has_alpha: bool):
    s = src_px.astype(np.int64).sum(axis=0)
    mean = [(int(v) + 8) >> 4 for v in s]
    if not has_alpha:
        mean[3] = 255
    return L.create_solid_blk(mean)


def _is_solid_log(blk) -> bool:
    px = _fast_unpack(blk)
    return bool((px == px[0]).all())


def run_rdo_passes(src_blocks: np.ndarray, log_blks, phys, nbx: int,
                   stripes, opts: RdoOptions, has_alpha: bool):
    """Both RDO pre-passes over the logical grid, then re-packs changed
    blocks into phys. src_blocks: (N,16,4) uint8 source pixels."""
    cw = opts.weights
    floor = opts.min_block_psnr
    for first_row, n_rows in stripes:
        for by in range(first_row, first_row + n_rows):
            for bx in range(nbx):
                i = by * nbx + bx
                blk = log_blks[by][bx]
                src = src_blocks[i]
                orig_psnr = _wsse_psnr(src, _fast_unpack(blk), cw)

                # ---- repeat: copy a causal neighbor wholesale ----
                if opts.repeat_drop > 0:
                    best, best_p = None, 0.0
                    for nb_blk in ((log_blks[by][bx - 1] if bx >= 1 else None),
                                   (log_blks[by - 1][bx]
                                    if by > first_row else None)):
                        if nb_blk is None:
                            continue
                        p = _wsse_psnr(src, _fast_unpack(nb_blk), cw)
                        if (p >= floor and p >= orig_psnr - opts.repeat_drop
                                and (best is None or p > best_p)):
                            best, best_p = nb_blk, p
                    if best is not None:
                        pb = L.pack_phys(best)
                        phys[i] = pb
                        log_blks[by][bx] = L.unpack_phys(pb)
                        continue

                # ---- solid: replace with the block's mean color ----
                if opts.solid_drop > 0 and not _is_solid_log(blk):
                    cand = _mean_solid_candidate(src, has_alpha)
                    p = _wsse_psnr(src, _fast_unpack(cand), cw)
                    if p >= floor and p >= orig_psnr - opts.solid_drop:
                        pb = L.pack_phys(cand)
                        phys[i] = pb
                        log_blks[by][bx] = L.unpack_phys(pb)
                        continue

                # ---- endpoints: slam to a causal neighbor's prediction ----
                if opts.endpoint_drop <= 0 or _is_solid_log(blk):
                    continue
                if ((bx >= 1 and phys[i] == phys[i - 1])
                        or (by > first_row and phys[i] == phys[i - nbx])):
                    continue                    # already codes as a Repeat
                best_cand, best_psnr = None, 0.0
                preds = []
                if bx >= 1:
                    preds.append(log_blks[by][bx - 1])
                if by > first_row:
                    preds.append(log_blks[by - 1][bx])
                    if bx >= 1:
                        preds.append(log_blks[by - 1][bx - 1])
                    if bx + 1 < nbx:
                        preds.append(log_blks[by - 1][bx + 1])
                for pred in preds:
                    cand = blk.copy()
                    for s in range(cand.num_partitions):
                        L.endpoint_dpcm_decode(pred, 0, cand, s,
                                               [0] * 8, [0, 0])
                    cand = optimize_block_weights(cand, src, cw)
                    p = _wsse_psnr(src, _fast_unpack(cand), cw)
                    if best_cand is None or p > best_psnr:
                        best_cand, best_psnr = cand, p
                if (best_cand is not None and best_psnr >= floor
                        and best_psnr >= orig_psnr - opts.endpoint_drop):
                    pb = L.pack_phys(best_cand)
                    phys[i] = pb
                    log_blks[by][bx] = L.unpack_phys(pb)


def _unpack_eps_cached(blk, subset):
    """unpack_endpoints memoized on the block instance (the wide predictor
    scan touches the same neighbor blocks repeatedly)."""
    cache = getattr(blk, "_ep_cache", None)
    if cache is None:
        cache = {}
        blk._ep_cache = cache
    r = cache.get(subset)
    if r is None:
        r = L.unpack_endpoints(blk, subset)
        cache[subset] = r
    return r


_pack_ep_memo = {}


def _pack_endpoints_memo(mode, lo, hi):
    """pack_endpoints_int memoized on (mode, 8-bit endpoint tuple): the
    wide XY-delta predictor scan hits the same prediction values often."""
    key = (mode, tuple(lo), tuple(hi))
    r = _pack_ep_memo.get(key)
    if r is None:
        if len(_pack_ep_memo) > 1 << 17:
            _pack_ep_memo.clear()
        r = L.pack_endpoints_int(mode, lo, hi)
        _pack_ep_memo[key] = r
    return r


def _ep_dpcm_residuals(pred_blk, pred_subset, blk, subset, has_alpha):
    """Inverse of L.endpoint_dpcm_decode: residual bytes (+ per-byte cost
    moduli) and pbit residuals that reconstruct blk.endpoints[subset]
    exactly through the decoder."""
    pred = [list(e) for e in _unpack_eps_cached(pred_blk, pred_subset)]
    if pred_blk.is_dual_plane():
        pccs = pred_blk.get_color_component_selector()
        pred[0][pccs], pred[0][3] = pred[0][3], pred[0][pccs]
        pred[1][pccs], pred[1][3] = pred[1][3], pred[1][pccs]
    ccs = blk.get_color_component_selector()
    if blk.is_dual_plane():
        pred[0][ccs], pred[0][3] = pred[0][3], pred[0][ccs]
        pred[1][ccs], pred[1][3] = pred[1][3], pred[1][ccs]

    packed_lo, packed_hi, packed_pbits = _pack_endpoints_memo(
        blk.mode, pred[0], pred[1])
    num_comps = blk.get_num_comps()
    fmt = L.ENDPOINT_FORMATS[blk.mode]
    g_channel, a_channel = 1, 3
    if blk.is_dual_plane():
        a_channel = ccs
        if ccs == 1:
            g_channel = 3

    num_residuals = num_comps * 2
    if (not has_alpha) and blk.mode == 6:
        num_residuals = 6

    delta = [0] * 8
    moduli = [256] * 8
    for c in range(num_residuals >> 1):
        nb = blk.endpoint_bits[c == 3]
        mask = (1 << nb) - 1
        delta[c * 2 + 0] = (int(blk.endpoints[subset][0][c])
                            - packed_lo[c]) & mask
        delta[c * 2 + 1] = (int(blk.endpoints[subset][1][c])
                            - packed_hi[c]) & mask
        if c == g_channel or c == a_channel:
            moduli[c * 2] = moduli[c * 2 + 1] = mask + 1
    res = list(delta)
    for c in range(num_residuals >> 1):
        if c == g_channel or c == a_channel:
            continue
        res[c * 2 + 0] = (delta[c * 2 + 0] - delta[g_channel * 2 + 0]) & 0xFF
        res[c * 2 + 1] = (delta[c * 2 + 1] - delta[g_channel * 2 + 1]) & 0xFF
    rp = [(int(blk.pbits[subset * fmt[2] + p]) - packed_pbits[p]) & 1
          for p in range(fmt[2])]
    return res[:num_residuals], moduli[:num_residuals], rp


def _encode_stripe(stripe, nbx, log_blks, phys, has_alpha, streams, bits,
                   global_q=100, num_ep_deltas=NUM_XY_DELTAS):
    first_row, n_rows = stripe
    end_row = first_row + n_rows
    tile = (0, first_row, nbx - 1, end_row - 1)
    gq_fx = global_q * ONE

    def neighbor(nx, ny):
        if tile[0] <= nx <= tile[2] and tile[1] <= ny <= tile[3]:
            return log_blks[ny][nx]
        return None

    commands = streams[B_COMMANDS]
    configs = streams[B_CONFIG]
    part2 = streams[B_PART2]
    part3 = streams[B_PART3]
    predictors = streams[B_PREDICTORS]
    solid_deltas = streams[B_SOLID_DELTAS]
    dc_coeffs = streams[B_DC_SMALL]
    ac_coeffs = streams[B_AC]
    coeff_signs = bits[B_SIGNS]
    raw_weights = streams[B_RAW_WEIGHTS]
    wt_resid = {2: streams[B_WT_RESID2], 3: streams[B_WT_RESID3],
                4: streams[B_WT_RESID4]}
    ep_fine = [streams[B_EP_FINE_R + c] for c in range(4)]
    ep_coarse = [streams[B_EP_COARSE_R + c] for c in range(4)]
    ep_blk_index = streams[B_EP_BLOCK_INDEX]
    ep_raw = bits[B_EP_RAW]
    pbits_r = bits[B_PBITS]

    for by in range(first_row, end_row):
        for bx in range(nbx):
            i = by * nbx + bx
            pbytes = phys[i]
            left = neighbor(bx - 1, by)
            up = neighbor(bx, by - 1)
            ldiag = neighbor(bx - 1, by - 1)
            rdiag = neighbor(bx + 1, by - 1)

            if left is not None and phys[i - 1] == pbytes:
                commands.append(CMD_REPEAT_LAST)
                log_blks[by][bx] = left.copy()
                continue
            if up is not None and phys[i - nbx] == pbytes:
                commands.append(CMD_REPEAT_UPPER)
                log_blks[by][bx] = up.copy()
                continue

            blk = L.unpack_phys(pbytes)

            # canonical solid: only when the solid encoding reproduces the
            # input bytes (keeps the stream lossless at the BC7-byte level)
            px = L.unpack_rgba(blk)
            if (px == px[0]).all():
                solid = L.create_solid_blk([int(c) for c in px[0]])
                if L.pack_phys(solid) == pbytes:
                    commands.append(CMD_SOLID_DPCM)
                    preds = [0, 0, 0, 0]
                    num = 0
                    if left is not None:
                        lp = L.unpack_rgba(left)
                        for y in range(4):
                            q = lp[3 + y * 4]
                            for c in range(4):
                                preds[c] += int(q[c])
                        num += 4
                    if up is not None:
                        upx = L.unpack_rgba(up)
                        for x in range(4):
                            q = upx[x + 3 * 4]
                            for c in range(4):
                                preds[c] += int(q[c])
                        num += 4
                    if num:
                        preds = [(p + num // 2) // num for p in preds]
                    for c in range(4 if has_alpha else 3):
                        solid_deltas.append((int(px[0][c]) - preds[c]) & 0xFF)
                    log_blks[by][bx] = solid
                    continue

            # ---- config: reuse a matching neighbor's (mode, rot, sel)
            cmd = CMD_NEW_CONFIG
            for rc, nb_blk in ((CMD_REUSE_LEFT, left), (CMD_REUSE_UPPER, up),
                               (CMD_REUSE_LDIAG, ldiag),
                               (CMD_REUSE_RDIAG, rdiag)):
                if (nb_blk is not None and nb_blk.mode == blk.mode
                        and nb_blk.dp_rotation_index == blk.dp_rotation_index
                        and nb_blk.mode4_index_selector
                        == blk.mode4_index_selector):
                    cmd = rc
                    break

            # ---- endpoints: best DPCM predictor vs raw (cost in bits)
            fmt = L.ENDPOINT_FORMATS[blk.mode]
            num_comps = blk.get_num_comps()
            raw_bits = blk.num_partitions * 2 * sum(
                blk.endpoint_bits[c == 3] for c in range(num_comps)) \
                + blk.num_pbits
            best = (EP_RAW, float(raw_bits), None, 0)
            # no-alpha mode-6 DPCM decode forces A endpoints to 127; only
            # lossless when the input block already carries them
            dpcm_ok = not ((not has_alpha) and blk.mode == 6
                           and not (blk.endpoints[0][0][3] == 127
                                    and blk.endpoints[0][1][3] == 127))
            ep_cands = [(EP_DPCM_LEFT, left, 0, 0.0, None),
                        (EP_DPCM_UP, up, 0, 0.0, None),
                        (EP_DPCM_LDIAG, ldiag, 0, 0.0, None),
                        (EP_DPCM_RDIAG, rdiag, 0, 0.0, None)]
            if left is not None and left.num_partitions >= 2:
                ep_cands.append((EP_DPCM_LEFT_S1, left, 1, 0.0, None))
            if up is not None and up.num_partitions >= 2:
                ep_cands.append((EP_DPCM_UP_S1, up, 1, 0.0, None))
            # wide XY-delta scan (ep:blk_index, decoder XY_DELTAS table);
            # the index byte costs ~5 bits entropy-coded. Skip the first 2
            # deltas ((-1,0)/(0,-1)) — identical to the free LEFT/UP modes.
            # Cheap prefilter: rank all available deltas by 8-bit endpoint
            # L1 distance to the target (a monotone proxy of the DPCM
            # residual cost), full-cost only the best few.
            if num_ep_deltas and dpcm_ok:
                tgt = _unpack_eps_cached(blk, 0)
                tflat = tgt[0] + tgt[1]
                scored = []
                for di in range(num_ep_deltas):
                    dx, dy = XY_DELTAS[di]
                    if (dx, dy) in ((-1, 0), (0, -1)):
                        continue
                    nb_blk = neighbor(bx + dx, by + dy)
                    if nb_blk is None:
                        continue
                    pe = _unpack_eps_cached(nb_blk, 0)
                    pflat = pe[0] + pe[1]
                    d = 0
                    for a, b2 in zip(tflat, pflat):
                        d += a - b2 if a >= b2 else b2 - a
                    scored.append((d, di, nb_blk))
                scored.sort(key=lambda s: s[0])
                for d, di, nb_blk in scored[:4]:
                    ep_cands.append((EP_DPCM_BLOCK_INDEX, nb_blk, 0, 5.0, di))
            for em, pred_blk, psub, extra, di in ep_cands:
                if pred_blk is None or not dpcm_ok:
                    continue
                if psub and pred_blk.num_partitions < 2:
                    continue
                cost = extra
                payload = []
                for subset in range(blk.num_partitions):
                    res, mods, rp = _ep_dpcm_residuals(
                        pred_blk, psub, blk, subset, has_alpha)
                    cost += sum(_resid_cost(r, m)
                                for r, m in zip(res, mods)) + len(rp)
                    payload.append((res, rp))
                    if cost >= best[1]:
                        break
                if cost < best[1]:
                    best = (em, cost, payload, di)

            ep_mode = best[0]
            cmd_pos = len(commands)
            commands.append(cmd | (ep_mode << 3))
            if cmd == CMD_NEW_CONFIG:
                cfg = blk.mode
                if blk.num_planes == 2:
                    cfg |= blk.dp_rotation_index << 3
                if blk.mode == 4:
                    cfg |= blk.mode4_index_selector << 5
                configs.append(cfg)
            if blk.num_partitions == 2:
                part2.append(blk.pattern_index)
            elif blk.num_partitions == 3:
                part3.append(blk.pattern_index)

            if ep_mode == EP_RAW:
                for subset in range(blk.num_partitions):
                    for c in range(num_comps):
                        for e in range(2):
                            ep_raw.put(int(blk.endpoints[subset][e][c]),
                                       blk.endpoint_bits[c == 3])
                for pb in range(blk.num_pbits):
                    ep_raw.put(int(blk.pbits[pb]), 1)
            else:
                if ep_mode == EP_DPCM_BLOCK_INDEX:
                    ep_blk_index.append(best[3])
                fine = blk.endpoint_bits[0] >= 6
                for res, rp in best[2]:
                    for k in range(0, len(res), 2):
                        strm = (ep_fine if fine else ep_coarse)[k >> 1]
                        strm.append(res[k])
                        strm.append(res[k + 1])
                    for p in rp:
                        pbits_r.put(p, 1)

            # ---- weights
            planes = blk.num_planes

            # lossless candidate scan (also the q<100 fallback: when the
            # DPCM path is estimated smaller than the DCT path it is
            # Pareto-better — less rate AND zero added distortion)
            wt_best = (CAND_ABSOLUTE, float(sum(
                32 if blk.weight_bits[p] == 2 else 64 for p in range(planes))),
                None)
            for cand in _WT_CANDS:
                cost = 0.0
                plane_preds = []
                ok = True
                for p in range(planes):
                    preds = eval_weight_predictor(cand, 0, bx, by, tile,
                                                  log_blks, p)
                    if preds is None:
                        ok = False
                        break
                    nb = blk.weight_bits[p]
                    mask = (1 << nb) - 1
                    for k in range(16):
                        s = (int(blk.weights[p][k])
                             - L.quant_weight(preds[k], nb)) & mask
                        cost += _resid_cost(s, mask + 1)
                    plane_preds.append(preds)
                if ok and cost < wt_best[1]:
                    wt_best = (cand, cost, plane_preds)

            if global_q < 100:
                # lossy weight-grid DCT (the reference's m_dct_q < 100 path,
                # encoder/basisu_xbc7_encode.h:31): evaluate ABSOLUTE + the
                # predictor shortlist through the EXACT forward quantizer,
                # pick the min coded size (small weight-error tiebreak), and
                # reconstruct closed-loop so downstream predictions chain on
                # decoded state.
                wt_choice = None
                for cand in (CAND_ABSOLUTE,) + _WT_CANDS:
                    plane_preds = []
                    plane_syms = []
                    cost = 0.0
                    ok = True
                    for p in range(planes):
                        preds = None
                        if cand != CAND_ABSOLUTE:
                            preds = eval_weight_predictor(
                                cand, 0, bx, by, tile, log_blks, p)
                            if preds is None:
                                ok = False
                                break
                        dc, ac = dct_forward_weights(gq_fx, p, preds, blk)
                        cost += 8.0 + (1.0 if cand != CAND_ABSOLUTE else 0.0)
                        for _run, c in ac:
                            cost += 8.0 if c == 0x7FFF else 17.0
                        plane_preds.append(preds)
                        plane_syms.append((dc, ac))
                    if not ok:
                        continue
                    trial = blk.copy()
                    err = 0.0
                    for p in range(planes):
                        dc, ac = plane_syms[p]
                        dct_inverse_weights(gq_fx, p, plane_preds[p], dc, ac,
                                            trial)
                        wb = blk.weight_bits[p]
                        for k in range(16):
                            dv = (L.dequant_weight(int(trial.weights[p][k]), wb)
                                  - L.dequant_weight(int(blk.weights[p][k]), wb))
                            err += dv * dv
                    score = cost + 0.02 * err
                    if wt_choice is None or score < wt_choice[0]:
                        wt_choice = (score, cand, plane_preds, plane_syms,
                                     trial, cost)
                if wt_choice is not None and wt_choice[5] < wt_best[1]:
                    _, cand, plane_preds, plane_syms, trial, _ = wt_choice
                    commands[cmd_pos] |= 0x40       # wt_mode = DCT
                    predictors.append(cand)
                    for p in range(planes):
                        dc, ac = plane_syms[p]
                        dc_coeffs.append(abs(dc))
                        if cand != CAND_ABSOLUTE:
                            coeff_signs.put(1 if dc < 0 else 0, 1)
                        for run, c in ac:
                            if c == 0x7FFF:
                                ac_coeffs.append(0xFF)
                            else:
                                ac_coeffs.append(run)
                                ac_coeffs.append(abs(c))
                                coeff_signs.put(1 if c < 0 else 0, 1)
                    log_blks[by][bx] = trial
                    continue
                # fall through to the lossless emission below

            cand = wt_best[0]
            predictors.append(cand)
            for p in range(planes):
                nb = blk.weight_bits[p]
                mask = (1 << nb) - 1
                if cand == CAND_ABSOLUTE:
                    syms = [int(blk.weights[p][k]) for k in range(16)]
                    strm = raw_weights
                else:
                    preds = wt_best[2][p]
                    syms = [(int(blk.weights[p][k])
                             - L.quant_weight(preds[k], nb)) & mask
                            for k in range(16)]
                    strm = wt_resid[nb]
                if nb == 2:
                    for k in range(0, 16, 4):
                        strm.append(syms[k] | (syms[k + 1] << 2)
                                    | (syms[k + 2] << 4) | (syms[k + 3] << 6))
                else:
                    for k in range(0, 16, 2):
                        strm.append(syms[k] | (syms[k + 1] << 4))
            log_blks[by][bx] = blk


def encode_blocks(phys_blocks, width: int, height: int,
                  num_stripes: int = 0, quality: int = 100,
                  src_pixels=None, rdo: "RdoOptions" = None,
                  effort: int = 2) -> bytes:
    """Physical BC7 blocks ((N,16) uint8 / list of 16-byte chunks), row-major
    → XUBC7 blob container. quality 100 (default) is lossless —
    xbc7_decode.decode_bc7 returns the input bytes; 1-99 enables the lossy
    weight-grid DCT (the reference's m_dct_q,
    encoder/basisu_xbc7_encode.h:31) at that quality.

    src_pixels ((N,16,4) uint8 source pixels) + rdo enable the reference's
    repeat/solid/endpoint RDO pre-passes (basisu_xbc7_encode.cpp:1640-1935)
    before stripe coding. effort scales the XY-delta endpoint predictor
    scan width."""
    import zstandard

    quality = int(quality) if 1 <= int(quality) <= 99 else 100
    nbx = (width + 3) // 4
    nby = (height + 3) // 4
    phys = [bytes(bytearray(b)) for b in phys_blocks]
    if len(phys) != nbx * nby:
        raise ValueError("block count mismatch")
    if not num_stripes:
        num_stripes = min(nby, 8)
    num_stripes = max(1, min(num_stripes, nby))
    stripes = _stripe_ranges(nby, num_stripes)

    # has_alpha from decoded content (affects solid-delta channel count)
    has_alpha = False
    for b in phys:
        if (L.unpack_rgba(L.unpack_phys(b))[:, 3] != 255).any():
            has_alpha = True
            break

    if rdo is not None and rdo.enabled and src_pixels is not None:
        grid = [[L.unpack_phys(phys[by * nbx + bx]) for bx in range(nbx)]
                for by in range(nby)]
        run_rdo_passes(np.asarray(src_pixels, np.uint8), grid, phys, nbx,
                       stripes, rdo, has_alpha)

    num_ep_deltas = NUM_XY_DELTAS if effort >= 2 else (8 if effort else 0)

    log_blks = [[None] * nbx for _ in range(nby)]
    bit_ids = (B_SIGNS, B_PBITS, B_EP_RAW)
    streams = {bid: bytearray() for bid in range(1, 26) if bid not in bit_ids}
    bits = {bid: _LsbBitWriter() for bid in bit_ids}

    # start offset of every stripe in every stream (bytes; bits for bit blobs)
    starts = {bid: [] for bid in range(1, 26)}
    for s in range(num_stripes):
        for bid in range(1, 26):
            starts[bid].append(bits[bid].bit if bid in bit_ids
                               else len(streams[bid]))
        _encode_stripe(stripes[s], nbx, log_blks, phys, has_alpha,
                       streams, bits, global_q=quality,
                       num_ep_deltas=num_ep_deltas)

    blobs = {B_HEADER: struct.pack("<HHBBB", width, height, quality,
                                   1 if has_alpha else 0, num_stripes)}
    for bid, buf in streams.items():
        if buf:
            blobs[bid] = bytes(buf)
    for bid in bit_ids:
        if bits[bid].bytes:
            blobs[bid] = bytes(bits[bid].bytes)

    if num_stripes > 1:
        n_streams = 25
        num_entries = num_stripes * n_streams
        deltas = [0] * num_entries
        for bid in range(1, 26):
            prev = 0
            for st in range(num_stripes):
                e = st * n_streams + (bid - 1)
                deltas[e] = starts[bid][st] - prev
                prev = starts[bid][st]
        tbl = bytearray(num_entries * 4)
        for e, d in enumerate(deltas):
            tbl[e] = d & 0xFF
            tbl[num_entries + e] = (d >> 8) & 0xFF
            tbl[2 * num_entries + e] = (d >> 16) & 0xFF
            tbl[3 * num_entries + e] = (d >> 24) & 0xFF
        blobs[B_SEEK] = bytes(tbl)

    cctx = zstandard.ZstdCompressor(level=19)
    out = bytearray([BLOB_MAGIC_BEGIN, len(blobs)])

    def varint(v):
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return

    for bid in sorted(blobs):
        payload = blobs[bid]
        comp = cctx.compress(payload)
        if len(comp) < len(payload):
            out.append(bid | 0x80)
            varint(len(payload))
            varint(len(comp))
            out += comp
        else:
            out.append(bid)
            varint(len(payload))
            out += payload
    out.append(BLOB_MAGIC_END)
    return bytes(out)
