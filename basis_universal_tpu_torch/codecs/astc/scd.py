"""Copy of `basis_universal_tpu/codecs/astc/scd.py`.

SCD — deblocking-aware candidate descent for large-block ASTC/XUASTC.

The reference's "refine_output_for_deblocking" runs checkerboard passes
over the block grid; for every block it re-scores the encoder's candidate
list against the ORIGINAL image after applying the transcode-time deblock
filter to the candidate's 1-px neighborhood, plus a cross-block boundary
delta-mismatch penalty and an optional chroma-preservation penalty
(encoder/basisu_astc_ldr_encode.cpp:14339 pass loop, :13186
deblocking_find_best_candidate, :13070 boundary penalty, :13129 chroma
penalty). Enabled by default on >=10x8 footprints, effort-scaled pass
count (basisu_comp.cpp:1645-1715).

This implementation is batched: each checkerboard pass evaluates EVERY
same-parity block x candidate simultaneously as one (Bp, K, bh+4, bw+4, 4)
array program (same-parity blocks only touch diagonally, so the whole
half-grid commits at once — the reference reaches the same schedule with
per-block thread jobs). Candidate mutation (reference pass >= 4) is not
implemented yet.
"""

import numpy as np

CROSS_BLOCK_PENALTY_WEIGHT = 2.5           # g_astc_refine_cross_block_penalty_weight


def scd_num_passes(effort: int) -> int:
    """Effort -> SCD pass count (basisu_comp.cpp:1688-1715; our effort
    0-3 maps onto the reference's 0-5)."""
    return {0: 0, 1: 0, 2: 2, 3: 8}.get(max(0, min(int(effort), 3)), 0)


def _filter_region(win: np.ndarray, bw: int, bh: int) -> np.ndarray:
    """Deblock the (bh+2, bw+2) region centered on the block inside
    (..., bh+4, bw+4, C) int32 windows (deblock_block_region,
    encoder/basisu_astc_ldr_encode.cpp:127; math identical to
    ops/deblock.deblock_rgba)."""
    c = win[..., 1:bh + 3, 1:bw + 3, :]
    l = win[..., 1:bh + 3, 0:bw + 2, :]
    r = win[..., 1:bh + 3, 2:bw + 4, :]
    u = win[..., 0:bh + 2, 1:bw + 3, :]
    d = win[..., 2:bh + 4, 1:bw + 3, :]

    idx_y = np.arange(bh + 2)
    idx_x = np.arange(bw + 2)
    on_h = (idx_y <= 1) | (idx_y >= bh)
    on_v = (idx_x <= 1) | (idx_x >= bw)
    corner = on_h[:, None] & on_v[None, :]
    v_edge = (~on_h[:, None]) & on_v[None, :]
    h_edge = on_h[:, None] & (~on_v[None, :])

    out = c.copy()
    ve = (l + c + r + 1) // 3
    he = (u + c + d + 1) // 3
    s = (l + 2 * c + r + u + d).astype(np.float32)
    cv = np.floor(s * np.float32(1.0 / 6.0) + np.float32(0.5)).astype(np.int32)
    cv = np.minimum(cv, 255)
    out[..., v_edge, :] = ve[..., v_edge, :]
    out[..., h_edge, :] = he[..., h_edge, :]
    out[..., corner, :] = cv[..., corner, :]
    return out


def _boundary_penalty(stage, orig_win, bw, bh, cw):
    """calc_cross_block_boundary_delta_mismatch (:13070): squared mismatch
    of the across-boundary first differences, orig vs candidate, summed
    over the 4 block edges. stage/orig_win: (..., bh+4, bw+4, 4) int32
    windows (UNfiltered staging); block occupies [2:2+bh, 2:2+bw]."""
    cwf = np.asarray(cw, np.float64)

    def pen(a_in, a_out, b_in, b_out):
        d = (a_in - a_out).astype(np.float64) - (b_in - b_out)
        return ((d * d) * cwf).sum(axis=(-1, -2))

    p = pen(stage[..., 2, 2:2 + bw, :], stage[..., 1, 2:2 + bw, :],
            orig_win[..., 2, 2:2 + bw, :], orig_win[..., 1, 2:2 + bw, :])
    p = p + pen(stage[..., 1 + bh, 2:2 + bw, :], stage[..., 2 + bh, 2:2 + bw, :],
                orig_win[..., 1 + bh, 2:2 + bw, :], orig_win[..., 2 + bh, 2:2 + bw, :])
    p = p + pen(stage[..., 2:2 + bh, 2, :], stage[..., 2:2 + bh, 1, :],
                orig_win[..., 2:2 + bh, 2, :], orig_win[..., 2:2 + bh, 1, :])
    p = p + pen(stage[..., 2:2 + bh, 1 + bw, :], stage[..., 2:2 + bh, 2 + bw, :],
                orig_win[..., 2:2 + bh, 1 + bw, :], orig_win[..., 2:2 + bh, 2 + bw, :])
    return np.round(p * CROSS_BLOCK_PENALTY_WEIGHT).astype(np.int64)


def _chroma_penalty(cand_px, orig_block, nt, cw_g):
    """calc_chroma_loss_penalty (:13129): CbCr drift of the block mean."""
    avg_c = cand_px.reshape(*cand_px.shape[:-3], -1, 4).astype(
        np.float32).mean(axis=-2)
    avg_o = orig_block.reshape(*orig_block.shape[:-3], -1, 4).astype(
        np.float32).mean(axis=-2)

    def ycbcr(v):
        r, g, b = v[..., 0], v[..., 1], v[..., 2]
        cb = r * np.float32(-0.114572) + g * np.float32(-0.385428) \
            + b * np.float32(0.5)
        cr = r * np.float32(0.5) + g * np.float32(-0.454153) \
            + b * np.float32(-0.045847)
        return cb, cr

    cb_c, cr_c = ycbcr(avg_c)
    cb_o, cr_o = ycbcr(avg_o)
    pen = (cb_o - cb_c) ** 2 + (cr_o - cr_c) ** 2
    wt = float(nt) * 0.25 * float(cw_g) * (14.0 * 14.0)
    return np.round(pen.astype(np.float64) * wt).astype(np.int64)


def orchestrate(plan: dict, chosen_px: np.ndarray, px: np.ndarray,
                pad_img: np.ndarray, nbx: int, nby: int, bw: int, bh: int,
                has_alpha: bool, effort: int,
                preserve_chroma: bool = True,
                config_ok=None) -> dict:
    """Build the candidate bank from a plan with want_candidates=True and
    run the SCD passes. chosen_px: (B, bh, bw, 4) decode of the current
    per-block decision; px: (B, bh*bw, 4) source blocks; pad_img: the
    block-padded source image. Returns {block_index: ('cfg', ci) |
    ('solid', rgba4)} for blocks whose decision changed. config_ok:
    optional predicate on plan['configs'][ci] excluding candidates the
    caller cannot emit."""
    num_passes = scd_num_passes(effort)
    if not num_passes:
        return {}
    b = px.shape[0]
    ncfg = len(plan["configs"])
    keep = [ci for ci in range(ncfg)
            if config_ok is None or config_ok(plan["configs"][ci])]
    if not keep:
        return {}

    mean = np.round(px.astype(np.float64).mean(axis=1)).astype(np.int64)
    mean = np.clip(mean, 0, 255)
    if not has_alpha:
        mean[:, 3] = 255
    solid_px = np.broadcast_to(
        mean.astype(np.uint8)[:, None, None, :], (b, bh, bw, 4))

    cand_rec = plan["cand_rec"][:, keep].reshape(b, len(keep), bh, bw, 4)
    cand_px = np.concatenate(
        [chosen_px[:, None], cand_rec, solid_px[:, None]], axis=1)
    k = cand_px.shape[1]
    cand_solid = np.zeros((b, k), bool)
    cand_solid[:, -1] = True

    chosen = refine_for_deblocking(
        pad_img, cand_px, cand_solid, np.zeros(b, np.int64),
        nbx, nby, bw, bh, num_passes=num_passes,
        preserve_chroma=preserve_chroma)

    out = {}
    for i in np.flatnonzero(chosen != 0):
        c = int(chosen[i])
        if c == k - 1:
            out[int(i)] = ("solid", tuple(int(v) for v in mean[i]))
        else:
            out[int(i)] = ("cfg", keep[c - 1])
    return out


def refine_for_deblocking(orig: np.ndarray, cand_px: np.ndarray,
                          cand_solid: np.ndarray, chosen: np.ndarray,
                          nbx: int, nby: int, bw: int, bh: int,
                          num_passes: int = 8, will_postfilter: bool = True,
                          preserve_chroma: bool = True,
                          comp_weights=(1, 1, 1, 1)) -> np.ndarray:
    """Run the SCD passes; returns the refined per-block candidate choice.

    orig: (nby*bh, nbx*bw, 4) uint8 block-padded source image.
    cand_px: (B, K, bh, bw, 4) uint8 candidate reconstructions
             (B row-major over the block grid).
    cand_solid: (B, K) bool — which candidates are solid-color blocks
             (switching TO one needs an 8x win, :13349).
    chosen: (B,) int initial candidate per block.
    """
    num_passes = max(2, min(int(num_passes), 256))
    b, k = cand_px.shape[:2]
    assert b == nbx * nby
    cw = np.asarray(comp_weights, np.int64)
    orig32 = orig.astype(np.int32)
    chosen = chosen.astype(np.int64).copy()

    # committed candidate image
    committed = cand_px[np.arange(b), chosen].reshape(
        nby, nbx, bh, bw, 4).transpose(0, 2, 1, 3, 4).reshape(
        nby * bh, nbx * bw, 4).astype(np.int32)

    orig_pad = np.pad(orig32, ((2, 2), (2, 2), (0, 0)), mode="edge")
    bys, bxs = np.divmod(np.arange(b), nbx)
    parity = (bxs ^ bys) & 1
    wy = np.arange(bh + 4)
    wx = np.arange(bw + 4)

    # per-block orig windows never change: gather once
    rows_all = (bys[:, None] * bh)[..., None] + wy[None, None, :]   # (B,1,bh+4)
    cols_all = (bxs[:, None] * bw)[..., None] + wx[None, None, :]
    orig_win_all = orig_pad[rows_all[:, 0, :, None], cols_all[:, 0, None, :]]
    orig_blk_all = orig_win_all[:, 2:2 + bh, 2:2 + bw, :]

    # plain per-candidate wsse (skip already-perfect blocks, :13204)
    d0 = cand_px.astype(np.int64) - orig_blk_all[:, None].astype(np.int64)
    plain_wsse = ((d0 * d0) * cw).sum(axis=(2, 3, 4))
    perfect = plain_wsse[np.arange(b), chosen] == 0

    if preserve_chroma:
        chroma_all = _chroma_penalty(cand_px, orig_blk_all[:, None],
                                     bw * bh, int(cw[1]))
    if not will_postfilter:
        scale_n = (bw + 2) * (bh + 2)
        scale_d = bw * bh

    for p in range(num_passes):
        sel = np.flatnonzero((parity == (p & 1)) & ~perfect)
        if not sel.size:
            continue
        committed_pad = np.pad(committed, ((2, 2), (2, 2), (0, 0)),
                               mode="edge")
        rows = rows_all[sel, 0]                       # (Bp, bh+4)
        cols = cols_all[sel, 0]
        win = committed_pad[rows[:, :, None], cols[:, None, :]]   # (Bp,bh+4,bw+4,4)
        stage = np.broadcast_to(
            win[:, None], (sel.size, k) + win.shape[1:]).copy()
        stage[:, :, 2:2 + bh, 2:2 + bw, :] = cand_px[sel]
        ow = orig_win_all[sel][:, None].astype(np.int64)          # (Bp,1,...)

        if will_postfilter:
            filt = _filter_region(stage, bw, bh).astype(np.int64)
            dreg = filt - ow[:, :, 1:bh + 3, 1:bw + 3, :]
            wsse = ((dreg * dreg) * cw).sum(axis=(2, 3, 4))
        else:
            wsse = (plain_wsse[sel] * scale_n) // scale_d

        err = wsse + _boundary_penalty(stage.astype(np.int64), ow, bw, bh, cw)
        if preserve_chroma:
            err = err + chroma_all[sel]
        # switching TO a solid candidate needs an 8x win
        cur = chosen[sel]
        not_current = np.arange(k)[None, :] != cur[:, None]
        err = np.where(cand_solid[sel] & not_current, err * 8, err)

        new = np.argmin(err, axis=1)
        changed = np.flatnonzero(new != cur)
        if changed.size:
            gi = sel[changed]
            chosen[gi] = new[changed]
            for j, i in zip(changed, gi):
                by, bx = divmod(int(i), nbx)
                committed[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw] = \
                    cand_px[i, new[j]]
    return chosen
