"""Copy of `basis_universal_tpu/codecs/astc/ldr_encode.py`.

Direct ASTC LDR encoder for arbitrary block sizes (5x4..12x12).

Single-partition path: CEM 8 (RGB) or CEM 12 (RGBA) endpoints from a
principal-axis line fit, per-texel weights projected onto the line, and
several candidate weight grids (full-res down to 3x3) fit by least squares
against the spec §18.11 infill, the winner chosen by reconstructed error.

Two-partition path (effort >= 2): the reference's 2-stage partition
estimation (encoder/basisu_astc_ldr_encode.cpp:4207-4321) — a 2-means
texel split, agreement-ranked ASTC partition seeds (dense matmul over all
1024 patterns), then a full masked line-fit + grid-fit trial of the top-K
seeds; the winner competes with the single-partition candidates on
reconstructed error.

The 4x4 member of the family uses the higher-quality UASTC mode search +
byte-exact repack instead (compressor._compress_astc_ldr).
"""

import functools

import numpy as np

from ..uastc import astc_pack
from ..uastc import tables as T
from . import helpers as ah
from .hdr_encode import _find_block_mode, _infill_matrix


@functools.lru_cache(maxsize=None)
def _grid_configs(bw: int, bh: int) -> tuple:
    """Candidate (grid_w, grid_h, weight_range, weight_bits) per block size
    (plain-bit ISE ranges only; all verified to satisfy the 24..96 weight
    bit constraint and leave room for endpoints)."""
    cands = []
    for gw, gh in {(bw, bh), (5, 5), (4, 4), (4, 3), (3, 3), (6, 5),
                   (6, 6), (8, 5), (5, 4)}:
        if gw > bw or gh > bh:
            continue
        for rng, wb in ((8, 4), (5, 3), (2, 2), (0, 1)):
            nw = gw * gh
            nwb = nw * wb
            if not (24 <= nwb <= 96):
                continue
            # need >= 13 bits/endpoint headroom check at pack time instead
            try:
                _find_block_mode(gw, gh, rng)
            except ValueError:
                continue
            cands.append((gw, gh, rng, wb))
    # prefer denser grids first (better quality), cap candidate count
    cands.sort(key=lambda c: -(c[0] * c[1] * c[3]))
    return tuple(cands[:8])


@functools.lru_cache(maxsize=None)
def _endpoint_range(n_vals: int, weight_bits: int) -> int:
    """The decoder-inferred endpoint ISE range: largest range whose cost
    fits the bits left after config + weights."""
    remaining = 128 - 17 - weight_bits
    best = -1
    for r in range(4, 21):
        if ah.ise_sequence_bits(n_vals, r) <= remaining:
            best = r
    if best < 4:
        raise ValueError("no endpoint range fits")
    return best


@functools.lru_cache(maxsize=None)
def _quant_tables(rng: int):
    unq = np.asarray(T.color_unquant_table(rng), dtype=np.int64)
    inv = np.argmin(np.abs(unq[None, :] - np.arange(256)[:, None]), axis=1)
    return inv.astype(np.int64), unq


@functools.lru_cache(maxsize=None)
def _partition2_patterns(bw: int, bh: int):
    """(seeds, patterns (P, bw*bh) uint8) for all distinct 2-subset ASTC
    patterns of this footprint that use both subsets."""
    small = bw * bh < 31
    seen = {}
    for seed in range(1024):
        pat = tuple(
            T.astc_select_partition(seed, i % bw, i // bw, 0, 2, small)
            for i in range(bw * bh))
        if 0 < sum(pat) < len(pat) and pat not in seen:
            seen[pat] = seed
    pats = np.array(list(seen.keys()), dtype=np.uint8)
    seeds = np.array(list(seen.values()), dtype=np.int32)
    return seeds, pats


_PLAIN_WEIGHT_RANGES = {0: 1, 2: 2, 5: 3, 8: 4}  # range → bits


@functools.lru_cache(maxsize=None)
def _weight_complement(rng: int) -> np.ndarray:
    """LUT c with dequant(c[v]) == 64 - dequant(v): the endpoint-swap weight
    inversion for ANY weight ISE range (trit/quint value orders are
    scrambled, so (nlev-1)-v only works for plain-bit ranges)."""
    n = ah.ise_levels(rng)
    vals = np.array([ah.dequant_weight(x, rng) for x in range(n)])
    comp = np.empty(n, dtype=np.int64)
    for x in range(n):
        m = np.flatnonzero(vals == 64 - vals[x])
        assert m.size, f"range {rng}: no complement for value {x}"
        comp[x] = m[0]
    return comp


@functools.lru_cache(maxsize=None)
def _grid_configs_main(bw: int, bh: int, n_vals: int) -> tuple:
    """Rich single-plane weight-grid enumeration for the MAIN candidate
    search: every grid shape × every weight ISE range (incl. trit/quint —
    the reference's winners routinely use ranges 3/4/6/7), endpoint range
    inferred from the remaining bits. Returns 5-tuples
    (gw, gh, weight_rng, weight_bits_or_-1, ep_rng); wb == -1 marks a
    non-plain range (LogBlock/ISE emission required)."""
    out = []
    for (gw, gh, rng, ep_rng) in _grid_configs_rich(bw, bh, n_vals, False):
        out.append((gw, gh, rng, _PLAIN_WEIGHT_RANGES.get(rng, -1), ep_rng))
    # union with the plain-bit list (its dense full-resolution grids beat
    # the rich ranking on hard 6x6 content)
    seen = {(c[0], c[1], c[2]) for c in out}
    for (gw, gh, rng, wb) in _grid_configs(bw, bh):
        if (gw, gh, rng) not in seen:
            ep_rng = _endpoint_range(n_vals, gw * gh * wb)
            out.append((gw, gh, rng, wb, ep_rng))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _partition3_patterns(bw: int, bh: int):
    """(seeds, patterns (P, bw*bh) uint8 in {0,1,2}) for all distinct
    3-subset ASTC patterns of this footprint that use all three subsets
    (reference estimate_partition3 search space,
    basisu_astc_ldr_encode.cpp:3167)."""
    small = bw * bh < 31
    seen = {}
    for seed in range(1024):
        pat = tuple(
            T.astc_select_partition(seed, i % bw, i // bw, 0, 3, small)
            for i in range(bw * bh))
        if len(set(pat)) == 3 and pat not in seen:
            seen[pat] = seed
    pats = np.array(list(seen.keys()), dtype=np.uint8)
    seeds = np.array(list(seen.values()), dtype=np.int32)
    return seeds, pats


@functools.lru_cache(maxsize=None)
def _grid_configs3(bw: int, bh: int, n_vals3: int) -> tuple:
    """Weight-grid configs for 3-partition blocks (same 29-bit config
    overhead as 2-partition; three subsets' endpoint values)."""
    out = []
    for (gw, gh, rng, wb) in _grid_configs(bw, bh):
        remaining = 128 - 29 - gw * gh * wb
        ep_rng = -1
        for r in range(4, 21):
            if ah.ise_sequence_bits(n_vals3, r) <= remaining:
                ep_rng = r
        if ep_rng >= 4:
            out.append((gw, gh, rng, wb, ep_rng))
    return tuple(out[:3])


@functools.lru_cache(maxsize=None)
def _grid_configs2(bw: int, bh: int, n_vals2: int) -> tuple:
    """Weight-grid configs for 2-partition blocks: config overhead is
    11 (mode) + 2 (parts) + 10 (seed) + 6 (CEM) = 29 bits; endpoints are
    two subsets' worth."""
    out = []
    for (gw, gh, rng, wb) in _grid_configs(bw, bh):
        remaining = 128 - 29 - gw * gh * wb
        ep_rng = -1
        for r in range(4, 21):
            if ah.ise_sequence_bits(n_vals2, r) <= remaining:
                ep_rng = r
        if ep_rng >= 4:
            out.append((gw, gh, rng, wb, ep_rng))
    return tuple(out[:4])


@functools.lru_cache(maxsize=None)
def _rank_tables(rng: int):
    """ISE code ↔ value-rank maps (codes are not value-monotone)."""
    _, unq = _quant_tables(rng)
    order = np.argsort(unq * 256 + np.arange(len(unq)))
    rank_of = np.zeros_like(order)
    rank_of[order] = np.arange(len(order))
    return rank_of, order          # code→rank, rank→code


def _fix_subset_order(lo_q, hi_q, ep_rng):
    """Ensure sum(unq[lo][:3]) <= sum(unq[hi][:3]) (the decoder's CEM 8/12
    blue-contract trigger) by minimal rank bumps; rare — only blocks whose
    quantization flipped a near-equal sum ordering."""
    _, unq = _quant_tables(ep_rng)
    rank_of, code_of = _rank_tables(ep_rng)
    nlev = len(unq)
    lo_q = lo_q.copy()
    hi_q = hi_q.copy()
    for _ in range(3 * nlev):
        s0 = int(unq[lo_q[0]] + unq[lo_q[1]] + unq[lo_q[2]])
        s1 = int(unq[hi_q[0]] + unq[hi_q[1]] + unq[hi_q[2]])
        if s0 <= s1:
            return lo_q, hi_q
        best = None
        for c in range(3):
            r = rank_of[hi_q[c]]
            if r + 1 < nlev:
                dv = int(unq[code_of[r + 1]]) - int(unq[hi_q[c]])
                if best is None or dv < best[0]:
                    best = (dv, "h", c, code_of[r + 1])
            r = rank_of[lo_q[c]]
            if r > 0:
                dv = int(unq[lo_q[c]]) - int(unq[code_of[r - 1]])
                if best is None or dv < best[0]:
                    best = (dv, "l", c, code_of[r - 1])
        if best is None:
            return lo_q, hi_q
        if best[1] == "h":
            hi_q[best[2]] = best[3]
        else:
            lo_q[best[2]] = best[3]
    return lo_q, hi_q


def _ls_endpoints_masked(v, up, m):
    """Least-squares endpoints given per-texel weights up (0..64) under
    mask m: min Σ m_i ||v_i - ((64-u_i) lo + u_i hi)/64||² per channel
    (the reference's compute_least_squares_endpoints analog)."""
    a = (64.0 - up) / 64.0 * m
    bb = up / 64.0 * m
    saa = (a * a).sum(-1)
    sbb = (bb * bb).sum(-1)
    sab = (a * bb).sum(-1)
    sap = np.einsum("bi,bic->bc", a, v)
    sbp = np.einsum("bi,bic->bc", bb, v)
    det = saa * sbb - sab * sab
    safe = np.abs(det) > 1e-6
    det = np.where(safe, det, 1.0)
    lo = (sbb[:, None] * sap - sab[:, None] * sbp) / det[:, None]
    hi = (saa[:, None] * sbp - sab[:, None] * sap) / det[:, None]
    cnt = np.maximum(m.sum(-1), 1.0)
    mean = np.einsum("bi,bic->bc", m, v) / cnt[:, None]
    lo = np.where(safe[:, None], lo, mean)
    hi = np.where(safe[:, None], hi, mean)
    return np.clip(lo, 0.0, 255.0), np.clip(hi, 0.0, 255.0)


def _masked_line_fit(v, m):
    """v (B,nt,C) float, m (B,nt) {0,1} → (lo, hi) clipped endpoints and
    per-texel target weights (valid where m)."""
    cnt = np.maximum(m.sum(1), 1.0)
    mean = (v * m[..., None]).sum(1) / cnt[:, None]
    c = (v - mean[:, None, :]) * m[..., None]
    cov = np.einsum("bif,big->bfg", c, c)
    d = np.ones((v.shape[0], v.shape[2]))
    for _ in range(4):
        d = np.einsum("bfg,bg->bf", cov, d)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    proj = np.einsum("bif,bf->bi", c, d)
    pmin = np.where(m > 0, proj, np.inf).min(1)
    pmax = np.where(m > 0, proj, -np.inf).max(1)
    pmin = np.where(np.isfinite(pmin), pmin, 0.0)
    pmax = np.where(np.isfinite(pmax), pmax, 0.0)
    lo = np.clip(mean + d * pmin[:, None], 0, 255)
    hi = np.clip(mean + d * pmax[:, None], 0, 255)
    dd = hi - lo
    num = ((v - lo[:, None, :]) * dd[:, None, :]).sum(-1)
    den = np.maximum((dd * dd).sum(-1), 1e-9)
    w = np.clip(64.0 * num / den[:, None], 0, 64)
    return lo, hi, w


def _find_block_mode_dp(grid_w: int, grid_h: int, wrange: int) -> int:
    """11-bit block mode for a DUAL-PLANE weight grid + range."""
    from .hdr_encode import _block_mode_table

    bm = _block_mode_table().get((grid_w, grid_h, wrange, True))
    if bm is None:
        raise ValueError(f"no dual-plane mode for {grid_w}x{grid_h} r{wrange}")
    return bm


@functools.lru_cache(maxsize=None)
def _grid_configs_dp(bw: int, bh: int) -> tuple:
    """Dual-plane configs: 2 planes of gw*gh weights (<= 64 total per the
    spec), config = 11 (mode) + 2 (parts) + 4 (CEM) bits + 2 CCS bits
    below the weights; endpoints are the 8 CEM-12 values."""
    out = []
    for gw, gh in ((4, 4), (4, 3), (3, 3), (5, 4), (5, 5), (3, 2)):
        if gw > bw or gh > bh:
            continue
        for rng, wb in ((8, 4), (2, 2), (0, 1), (5, 3)):
            nwb = 2 * gw * gh * wb
            if not (24 <= nwb <= 96) or 2 * gw * gh > 64:
                continue
            try:
                _find_block_mode_dp(gw, gh, rng)
            except ValueError:
                continue
            remaining = 128 - 17 - 2 - nwb
            ep_rng = -1
            for r in range(4, 21):
                if ah.ise_sequence_bits(8, r) <= remaining:
                    ep_rng = r
            if ep_rng >= 4:
                out.append((gw, gh, rng, wb, ep_rng))
    out.sort(key=lambda c: -(c[0] * c[1] * c[3]))
    return tuple(out[:3])


def _dual_plane_candidates(pxf, bw: int, bh: int, effort: int):
    """CEM-12 dual-plane (CCS=3: separate alpha weight plane) trial.
    Returns (err (B,), details per block) — the uncorrelated-alpha case
    single-plane CEM 12 can't represent (reference dual-plane trials,
    basisu_astc_ldr_encode.cpp)."""
    b, nt = pxf.shape[:2]
    configs = _grid_configs_dp(bw, bh)
    if not configs:
        return None, None
    rgb = pxf[..., :3]
    a = pxf[..., 3]
    ones = np.ones((b, nt))

    # RGB principal line + alpha min/max line
    lo3, hi3, w_rgb = _masked_line_fit(rgb, ones)
    a_lo = a.min(1)
    a_hi = a.max(1)
    den = np.maximum(a_hi - a_lo, 1e-9)
    w_a = np.clip(64.0 * (a - a_lo[:, None]) / den[:, None], 0, 64)

    # decode-order fixup: CEM 12 blue-contracts when sum(lo RGB) >
    # sum(hi RGB); flip endpoints AND both planes' weight targets
    fl = lo3.sum(-1) > hi3.sum(-1)
    lo3, hi3 = (np.where(fl[:, None], hi3, lo3),
                np.where(fl[:, None], lo3, hi3))
    a_lo2 = np.where(fl, a_hi, a_lo)
    a_hi2 = np.where(fl, a_lo, a_hi)
    w_rgb = np.where(fl[:, None], 64.0 - w_rgb, w_rgb)
    w_a = np.where(fl[:, None], 64.0 - w_a, w_a)

    best_err = np.full(b, np.inf)
    best = [None] * b
    for (gw, gh, rng, wb, ep_rng) in configs:
        inv, unq = _quant_tables(ep_rng)
        m_in, pinv = _infill_matrix(gw, gh, bw, bh)
        levels = np.array([ah.dequant_weight(x, rng) for x in range(1 << wb)])
        lo_q = inv[np.clip(np.round(lo3), 0, 255).astype(np.int64)]
        hi_q = inv[np.clip(np.round(hi3), 0, 255).astype(np.int64)]
        al_q = inv[np.clip(np.round(a_lo2), 0, 255).astype(np.int64)]
        ah_q = inv[np.clip(np.round(a_hi2), 0, 255).astype(np.int64)]
        lo_u = unq[lo_q].astype(np.float64)
        hi_u = unq[hi_q].astype(np.float64)
        al_u = unq[al_q].astype(np.float64)
        ah_u = unq[ah_q].astype(np.float64)

        def fit_plane(w_tex):
            grid_f = np.clip(w_tex @ pinv.T, 0, 64)
            codes = np.abs(grid_f[..., None] - levels).argmin(-1)
            up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                          ).astype(np.int64) >> 6, 0, 64)
            return codes, up

        c_rgb, up_rgb = fit_plane(w_rgb)
        c_a, up_a = fit_plane(w_a)
        rec_rgb = (lo_u[:, None, :] * (64 - up_rgb[..., None])
                   + hi_u[:, None, :] * up_rgb[..., None] + 32) // 64
        rec_a = (al_u[:, None] * (64 - up_a) + ah_u[:, None] * up_a
                 + 32) // 64
        err = (((rec_rgb - rgb) ** 2).sum(axis=(1, 2))
               + ((rec_a - a) ** 2).sum(-1))
        better = err < best_err
        for i in np.flatnonzero(better):
            lq, hq = _fix_subset_order(
                np.concatenate([lo_q[i], [al_q[i]]]),
                np.concatenate([hi_q[i], [ah_q[i]]]), ep_rng)
            best[i] = (gw, gh, rng, wb, ep_rng, lq, hq, c_rgb[i], c_a[i])
        best_err = np.where(better, err, best_err)
    return best_err, best


@functools.lru_cache(maxsize=None)
def _grid_configs_rich(bw: int, bh: int, n_vals: int, dual: bool) -> tuple:
    """Exhaustive single/dual-plane weight-grid enumeration for a CEM with
    n_vals endpoint values: every grid shape (incl. asymmetric, the
    reference's alpha winners are 3x6/6x5 grids) × every weight ISE range
    (incl. trit/quint), endpoint range inferred. Returns
    [(gw, gh, weight_rng, ep_rng)] ranked by weight resolution × grid
    coverage, capped. Mirrors the reference trial tables' breadth
    (transcoder/basisu_astc_cfgs.inl)."""
    out = []
    for gw in range(2, min(bw, 12) + 1):
        for gh in range(2, min(bh, 12) + 1):
            if gw == bw and gh == bh and bw * bh > 64:
                continue
            for rng in (9, 8, 7, 6, 5, 4, 3, 2, 1, 0):
                nv = gw * gh * (2 if dual else 1)
                if nv > 64:
                    continue
                wbits = ah.ise_sequence_bits(nv, rng)
                if not (24 <= wbits <= 96):
                    continue
                try:
                    if dual:
                        _find_block_mode_dp(gw, gh, rng)
                    else:
                        _find_block_mode(gw, gh, rng)
                except ValueError:
                    continue
                remaining = 128 - 17 - (2 if dual else 0) - wbits
                ep_rng = -1
                for r in range(4, 21):
                    if ah.ise_sequence_bits(n_vals, r) <= remaining:
                        ep_rng = r
                if ep_rng >= 4:
                    levels = ah.ise_levels(rng)
                    score = gw * gh * np.log2(levels) \
                        + 2.0 * np.log2(ah.ise_levels(ep_rng))
                    out.append((score, gw, gh, rng, ep_rng))
    out.sort(key=lambda c: -c[0])
    # diversity over depth: best-scoring config per grid SHAPE (binary
    # content wants exact row/column grids the global score undervalues),
    # plus the global top-8
    per_shape = {}
    for c in out:
        per_shape.setdefault((c[1], c[2]), c)
    top = {c[1:]: None for c in out[:8]}
    for c in per_shape.values():
        top[c[1:]] = None
    return tuple(top.keys())


@functools.lru_cache(maxsize=None)
def _grid_configs_nvals(bw: int, bh: int, n_vals: int) -> tuple:
    """Single-plane weight-grid configs with the endpoint range sized for
    n_vals endpoint values (CEM 0/4 have 2/4 values → more headroom than
    the CEM 8/12 default)."""
    out = []
    for (gw, gh, rng, wb) in _grid_configs(bw, bh):
        remaining = 128 - 17 - gw * gh * wb
        ep_rng = -1
        for r in range(4, 21):
            if ah.ise_sequence_bits(n_vals, r) <= remaining:
                ep_rng = r
        if ep_rng >= 4:
            out.append((gw, gh, rng, wb, ep_rng))
    return tuple(out[:4])


@functools.lru_cache(maxsize=None)
def _grid_configs_dp_nvals(bw: int, bh: int, n_vals: int) -> tuple:
    """Dual-plane configs for a CEM with n_vals endpoint values."""
    out = []
    for gw, gh in ((4, 4), (4, 3), (3, 3), (5, 4), (5, 5), (3, 2), (6, 5)):
        if gw > bw or gh > bh:
            continue
        for rng, wb in ((8, 4), (2, 2), (0, 1), (5, 3)):
            nwb = 2 * gw * gh * wb
            if not (24 <= nwb <= 96) or 2 * gw * gh > 64:
                continue
            try:
                _find_block_mode_dp(gw, gh, rng)
            except ValueError:
                continue
            remaining = 128 - 17 - 2 - nwb
            ep_rng = -1
            for r in range(4, 21):
                if ah.ise_sequence_bits(n_vals, r) <= remaining:
                    ep_rng = r
            if ep_rng >= 4:
                out.append((gw, gh, rng, wb, ep_rng))
    out.sort(key=lambda c: -(c[0] * c[1] * c[3]))
    return tuple(out[:3])


def _la_candidates(pxf, bw: int, bh: int, has_alpha: bool, effort: int):
    """CEM 0 (luminance) / CEM 4 (lum+alpha) single-plane and CEM-4
    dual-plane (CCS=3) trials — grayscale-dominant content on which the
    RGB/RGBA CEMs waste endpoint precision (the reference's trial tables
    span these CEMs, transcoder/basisu_astc_cfgs.inl). Returns
    (err (B,), list of LogBlock per block)."""
    b, nt = pxf.shape[:2]
    rgb = pxf[..., :3]
    a = pxf[..., 3]
    lum = rgb.mean(-1)                                  # LS-optimal gray
    cem = 4 if has_alpha else 0
    n_vals = 4 if has_alpha else 2

    # alpha error of the implicit a=255 for CEM 0
    a_pen = ((a - 255.0) ** 2).sum(-1) if not has_alpha else 0.0

    best_err = np.full(b, np.inf)
    best = [None] * b

    def rec_err_gray(rec_l):
        return ((rec_l[..., None] - rgb) ** 2).sum(axis=(1, 2))

    # --- single-plane: joint (L[,A]) line fit
    v2 = lum[..., None] if not has_alpha else np.stack([lum, a], -1)
    ones = np.ones((b, nt))
    lo2, hi2, w_tex = _masked_line_fit(v2, ones)
    for (gw, gh, rng, ep_rng) in _grid_configs_rich(bw, bh, n_vals, False):
        inv, unq = _quant_tables(ep_rng)
        m_in, pinv = _infill_matrix(gw, gh, bw, bh)
        levels = np.array([ah.dequant_weight(x, rng)
                           for x in range(ah.ise_levels(rng))])
        grid_f = np.clip(w_tex @ pinv.T, 0, 64)
        codes = np.abs(grid_f[..., None] - levels).argmin(-1)
        up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                      ).astype(np.int64) >> 6, 0, 64)
        lo_r, hi_r = _ls_endpoints_masked(v2, up.astype(np.float64), ones)
        lo_q = inv[np.clip(np.round(lo_r), 0, 255).astype(np.int64)]
        hi_q = inv[np.clip(np.round(hi_r), 0, 255).astype(np.int64)]
        lo_u = unq[lo_q].astype(np.float64)
        hi_u = unq[hi_q].astype(np.float64)
        rec = (lo_u[:, None, :] * (64 - up[..., None])
               + hi_u[:, None, :] * up[..., None] + 32) // 64   # (B,nt,C2)
        err = rec_err_gray(rec[..., 0]) + a_pen
        if has_alpha:
            err = err + ((rec[..., 1] - a) ** 2).sum(-1)
        better = err < best_err
        for i in np.flatnonzero(better):
            eps = [int(lo_q[i, 0]), int(hi_q[i, 0])]
            if has_alpha:
                eps += [int(lo_q[i, 1]), int(hi_q[i, 1])]
            best[i] = ah.LogBlock(
                grid_width=gw, grid_height=gh, dual_plane=False,
                weight_ise_range=rng, endpoint_ise_range=ep_rng,
                num_partitions=1, cems=(cem,), endpoints=eps,
                weights=[int(v) for v in codes[i]])
        best_err = np.where(better, err, best_err)

    # --- dual-plane CEM 4 (CCS=3): independent L and A weight planes
    if has_alpha:
        l_lo = lum.min(1)
        l_hi = lum.max(1)
        den = np.maximum(l_hi - l_lo, 1e-9)
        w_l = np.clip(64.0 * (lum - l_lo[:, None]) / den[:, None], 0, 64)
        a_lo = a.min(1)
        a_hi = a.max(1)
        den = np.maximum(a_hi - a_lo, 1e-9)
        w_a = np.clip(64.0 * (a - a_lo[:, None]) / den[:, None], 0, 64)
        for (gw, gh, rng, ep_rng) in _grid_configs_rich(bw, bh, 4, True):
            inv, unq = _quant_tables(ep_rng)
            m_in, pinv = _infill_matrix(gw, gh, bw, bh)
            levels = np.array([ah.dequant_weight(x, rng)
                               for x in range(ah.ise_levels(rng))])

            def fit_plane(w_tex_p, tgt):
                grid_f = np.clip(w_tex_p @ pinv.T, 0, 64)
                codes = np.abs(grid_f[..., None] - levels).argmin(-1)
                up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                              ).astype(np.int64) >> 6, 0, 64)
                lo_r, hi_r = _ls_endpoints_masked(
                    tgt[..., None], up.astype(np.float64),
                    np.ones((b, nt)))
                return codes, up, lo_r[:, 0], hi_r[:, 0]

            c_l, up_l, ll, lh = fit_plane(w_l, lum)
            c_a, up_a, al, ahh = fit_plane(w_a, a)
            ll_q = inv[np.clip(np.round(ll), 0, 255).astype(np.int64)]
            lh_q = inv[np.clip(np.round(lh), 0, 255).astype(np.int64)]
            al_q = inv[np.clip(np.round(al), 0, 255).astype(np.int64)]
            ah_q = inv[np.clip(np.round(ahh), 0, 255).astype(np.int64)]
            rec_l = (unq[ll_q].astype(np.float64)[:, None] * (64 - up_l)
                     + unq[lh_q].astype(np.float64)[:, None] * up_l
                     + 32) // 64
            rec_a = (unq[al_q].astype(np.float64)[:, None] * (64 - up_a)
                     + unq[ah_q].astype(np.float64)[:, None] * up_a
                     + 32) // 64
            err = rec_err_gray(rec_l) + ((rec_a - a) ** 2).sum(-1)
            better = err < best_err
            for i in np.flatnonzero(better):
                wts = [0] * (2 * gw * gh)
                for k in range(gw * gh):
                    wts[2 * k] = int(c_l[i, k])
                    wts[2 * k + 1] = int(c_a[i, k])
                best[i] = ah.LogBlock(
                    grid_width=gw, grid_height=gh, dual_plane=True,
                    weight_ise_range=rng, endpoint_ise_range=ep_rng,
                    num_partitions=1, cems=(4,), ccs=3,
                    endpoints=[int(ll_q[i]), int(lh_q[i]),
                               int(al_q[i]), int(ah_q[i])],
                    weights=wts)
            best_err = np.where(better, err, best_err)
    return best_err, best


def _two_partition_candidates(pxf, v, bw: int, bh: int, cem: int,
                              effort: int):
    """Trial the top-K agreement-ranked 2-subset patterns per block.
    Returns (err (B,), details list per block or None)."""
    b, nt = v.shape[:2]
    comps = v.shape[2]
    n_vals = 6 if cem == 8 else 8
    configs2 = _grid_configs2(bw, bh, n_vals * 2)
    if not configs2:
        return None, None
    seeds_all, pats_all = _partition2_patterns(bw, bh)
    pats_f = pats_all.astype(np.float64)                 # (P,nt)

    # 2-means split on full color distance
    lum = v.mean(-1)
    c0 = v[np.arange(b), lum.argmin(1)][:, None, :]
    c1 = v[np.arange(b), lum.argmax(1)][:, None, :]
    for _ in range(3):
        d0 = ((v - c0) ** 2).sum(-1)
        d1 = ((v - c1) ** 2).sum(-1)
        side = (d1 < d0).astype(np.float64)              # (B,nt)
        n1 = np.maximum(side.sum(1), 1.0)
        n0 = np.maximum((1.0 - side).sum(1), 1.0)
        c1 = ((v * side[..., None]).sum(1) / n1[:, None])[:, None, :]
        c0 = ((v * (1 - side)[..., None]).sum(1) / n0[:, None])[:, None, :]
    agree = side @ pats_f.T + (1.0 - side) @ (1.0 - pats_f).T
    score = np.maximum(agree, nt - agree)                # polarity-free
    topk = min(2 + effort, score.shape[1])
    cand_idx = np.argpartition(-score, topk - 1, axis=1)[:, :topk]  # (B,K)

    best_err = np.full(b, np.inf)
    best = [None] * b
    for (gw, gh, rng, wb, ep_rng) in configs2:
        inv, unq = _quant_tables(ep_rng)
        m_in, pinv = _infill_matrix(gw, gh, bw, bh)
        levels = np.array([ah.dequant_weight(x, rng) for x in range(1 << wb)])
        wmax = (1 << wb) - 1
        for k in range(topk):
            pat = pats_all[cand_idx[:, k]].astype(np.float64)   # (B,nt)
            seeds_k = seeds_all[cand_idx[:, k]]
            w_tex = np.zeros((b, nt))
            los = np.zeros((b, 2, comps))
            his = np.zeros((b, 2, comps))
            flip = np.zeros((b, 2), bool)
            for s in (0, 1):
                mask = pat if s else 1.0 - pat
                lo, hi, w = _masked_line_fit(v, mask)
                # per-subset CEM 8/12 ordering: decode blue-contracts when
                # sum(lo RGB) > sum(hi RGB); flip endpoints + this subset's
                # texel targets instead
                fl = lo[:, :3].sum(-1) > hi[:, :3].sum(-1)
                lo2 = np.where(fl[:, None], hi, lo)
                hi2 = np.where(fl[:, None], lo, hi)
                w = np.where(fl[:, None], 64.0 - w, w)
                los[:, s] = lo2
                his[:, s] = hi2
                flip[:, s] = fl
                w_tex = np.where(mask > 0, w, w_tex)
            grid_f = np.clip(w_tex @ pinv.T, 0, 64)
            codes = np.abs(grid_f[..., None] - levels).argmin(-1)
            gq = levels[codes]
            up = np.clip((gq @ (m_in.T * 64.0) + 32).astype(np.int64) >> 6,
                         0, 64)                                  # (B,nt)
            # one masked-LS endpoint refinement round per subset
            upf = up.astype(np.float64)
            for s in (0, 1):
                mask = pat if s else 1.0 - pat
                lo_r, hi_r = _ls_endpoints_masked(v, upf, mask)
                los[:, s] = lo_r
                his[:, s] = hi_r
            lo_q = inv[np.clip(np.round(los), 0, 255).astype(np.int64)]
            hi_q = inv[np.clip(np.round(his), 0, 255).astype(np.int64)]
            lo_u = unq[lo_q].astype(np.float64)                  # (B,2,C)
            hi_u = unq[hi_q].astype(np.float64)
            pat_i = pat.astype(np.int64)
            lo_t = np.take_along_axis(
                lo_u, pat_i[..., None].repeat(comps, -1), axis=1)
            hi_t = np.take_along_axis(
                hi_u, pat_i[..., None].repeat(comps, -1), axis=1)
            rec = (lo_t * (64 - up[..., None]) + hi_t * up[..., None]
                   + 32) // 64
            err = ((rec - v) ** 2).sum(axis=(1, 2))
            if cem == 8:
                err = err + ((pxf[..., 3] - 255.0) ** 2).sum(-1)
            better = err < best_err
            for i in np.flatnonzero(better):
                lq, hq = lo_q[i].copy(), hi_q[i].copy()
                for s in (0, 1):
                    lq[s, :], hq[s, :] = _fix_subset_order(
                        lq[s], hq[s], ep_rng)
                best[i] = (gw, gh, rng, wb, ep_rng, int(seeds_k[i]),
                           lq, hq, codes[i])
            best_err = np.where(better, err, best_err)
    return best_err, best


def _three_partition_candidates(pxf, v, bw: int, bh: int, cem: int,
                                effort: int):
    """Trial the top-K agreement-ranked 3-subset patterns per block
    (reference estimate_partition3, basisu_astc_ldr_encode.cpp:3167:
    3-means texel labels → confusion-matrix match over the 6 label
    permutations → full fit of the best seeds).
    Returns (err (B,), details list per block or None)."""
    b, nt = v.shape[:2]
    comps = v.shape[2]
    n_vals = 6 if cem == 8 else 8
    configs3 = _grid_configs3(bw, bh, n_vals * 3)
    if not configs3:
        return None, None
    seeds_all, pats_all = _partition3_patterns(bw, bh)
    if not len(seeds_all):
        return None, None

    # 3-means on full color distance, seeded min/mean/max along luma
    lum = v.mean(-1)
    idx = np.stack([lum.argmin(1), np.abs(lum - lum.mean(1, keepdims=True)
                                          ).argmin(1), lum.argmax(1)], 1)
    cc = np.take_along_axis(v, idx[..., None].repeat(comps, -1), 1)  # (B,3,C)
    for _ in range(3):
        d = ((v[:, :, None, :] - cc[:, None, :, :]) ** 2).sum(-1)  # (B,nt,3)
        lab = d.argmin(-1)                                         # (B,nt)
        one = np.eye(3)[lab]                                       # (B,nt,3)
        cnt = np.maximum(one.sum(1), 1.0)
        cc = np.einsum("bik,bic->bkc", one, v) / cnt[..., None]
    ideal = np.eye(3)[lab]                                         # (B,nt,3)

    pat_oh = np.eye(3)[pats_all]                                   # (P,nt,3)
    conf = np.einsum("bik,pij->bpkj", ideal, pat_oh)               # (B,P,3,3)
    perms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
    score = np.stack([conf[..., 0, p[0]] + conf[..., 1, p[1]]
                      + conf[..., 2, p[2]] for p in perms], -1).max(-1)
    topk = min(1 + effort // 2, score.shape[1])
    cand_idx = np.argpartition(-score, topk - 1, axis=1)[:, :topk]

    best_err = np.full(b, np.inf)
    best = [None] * b
    for (gw, gh, rng, wb, ep_rng) in configs3[:2]:
        inv, unq = _quant_tables(ep_rng)
        m_in, pinv = _infill_matrix(gw, gh, bw, bh)
        levels = np.array([ah.dequant_weight(x, rng) for x in range(1 << wb)])
        for k in range(topk):
            pat = pats_all[cand_idx[:, k]].astype(np.int64)        # (B,nt)
            seeds_k = seeds_all[cand_idx[:, k]]
            w_tex = np.zeros((b, nt))
            los = np.zeros((b, 3, comps))
            his = np.zeros((b, 3, comps))
            for s in range(3):
                mask = (pat == s).astype(np.float64)
                lo, hi, w = _masked_line_fit(v, mask)
                fl = lo[:, :3].sum(-1) > hi[:, :3].sum(-1)
                lo2 = np.where(fl[:, None], hi, lo)
                hi2 = np.where(fl[:, None], lo, hi)
                w = np.where(fl[:, None], 64.0 - w, w)
                los[:, s] = lo2
                his[:, s] = hi2
                w_tex = np.where(mask > 0, w, w_tex)
            grid_f = np.clip(w_tex @ pinv.T, 0, 64)
            codes = np.abs(grid_f[..., None] - levels).argmin(-1)
            up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                          ).astype(np.int64) >> 6, 0, 64)          # (B,nt)
            upf = up.astype(np.float64)
            for s in range(3):
                mask = (pat == s).astype(np.float64)
                lo_r, hi_r = _ls_endpoints_masked(v, upf, mask)
                los[:, s] = lo_r
                his[:, s] = hi_r
            lo_q = inv[np.clip(np.round(los), 0, 255).astype(np.int64)]
            hi_q = inv[np.clip(np.round(his), 0, 255).astype(np.int64)]
            lo_u = unq[lo_q].astype(np.float64)                    # (B,3,C)
            hi_u = unq[hi_q].astype(np.float64)
            lo_t = np.take_along_axis(
                lo_u, pat[..., None].repeat(comps, -1), axis=1)
            hi_t = np.take_along_axis(
                hi_u, pat[..., None].repeat(comps, -1), axis=1)
            rec = (lo_t * (64 - up[..., None]) + hi_t * up[..., None]
                   + 32) // 64
            err = ((rec - v) ** 2).sum(axis=(1, 2))
            if cem == 8:
                err = err + ((pxf[..., 3] - 255.0) ** 2).sum(-1)
            better = err < best_err
            for i in np.flatnonzero(better):
                lq, hq = lo_q[i].copy(), hi_q[i].copy()
                for s in range(3):
                    lq[s, :], hq[s, :] = _fix_subset_order(
                        lq[s], hq[s], ep_rng)
                best[i] = (gw, gh, rng, wb, ep_rng, int(seeds_k[i]),
                           lq, hq, codes[i])
            best_err = np.where(better, err, best_err)
    return best_err, best


def _dual_plane_rgb_candidates(pxf, bw: int, bh: int, effort: int):
    """CEM-8 dual-plane trials, CCS in {0,1,2}: the decorrelated-channel
    case (e.g. red text over a green/blue gradient) a single weight plane
    can't represent. Returns (err (B,), details per block)."""
    b, nt = pxf.shape[:2]
    configs = _grid_configs_dp_nvals(bw, bh, 6)
    if not configs:
        return None, None
    rgb = pxf[..., :3]
    ones = np.ones((b, nt))

    best_err = np.full(b, np.inf)
    best = [None] * b
    ccs_list = (0, 1, 2) if effort >= 2 else (2,)
    for ccs in ccs_list:
        others = [c for c in range(3) if c != ccs]
        v0 = rgb[..., others]                                     # (B,nt,2)
        v1 = rgb[..., ccs]                                        # (B,nt)
        lo2, hi2, w0 = _masked_line_fit(v0, ones)
        c_lo = v1.min(1)
        c_hi = v1.max(1)
        den = np.maximum(c_hi - c_lo, 1e-9)
        w1 = np.clip(64.0 * (v1 - c_lo[:, None]) / den[:, None], 0, 64)

        lo3 = np.zeros((b, 3))
        hi3 = np.zeros((b, 3))
        lo3[:, others] = lo2
        hi3[:, others] = hi2
        lo3[:, ccs] = c_lo
        hi3[:, ccs] = c_hi
        # CEM 8 decode order: flip endpoints + BOTH planes on blue-contract
        fl = lo3.sum(-1) > hi3.sum(-1)
        lo3, hi3 = (np.where(fl[:, None], hi3, lo3),
                    np.where(fl[:, None], lo3, hi3))
        w0 = np.where(fl[:, None], 64.0 - w0, w0)
        w1 = np.where(fl[:, None], 64.0 - w1, w1)

        for (gw, gh, rng, wb, ep_rng) in configs:
            inv, unq = _quant_tables(ep_rng)
            m_in, pinv = _infill_matrix(gw, gh, bw, bh)
            levels = np.array([ah.dequant_weight(x, rng)
                               for x in range(1 << wb)])
            lo_q = inv[np.clip(np.round(lo3), 0, 255).astype(np.int64)]
            hi_q = inv[np.clip(np.round(hi3), 0, 255).astype(np.int64)]
            lo_u = unq[lo_q].astype(np.float64)
            hi_u = unq[hi_q].astype(np.float64)

            def fit_plane(w_tex):
                grid_f = np.clip(w_tex @ pinv.T, 0, 64)
                codes = np.abs(grid_f[..., None] - levels).argmin(-1)
                up = np.clip((levels[codes] @ (m_in.T * 64.0) + 32
                              ).astype(np.int64) >> 6, 0, 64)
                return codes, up

            c_p0, up0 = fit_plane(w0)
            c_p1, up1 = fit_plane(w1)
            rec0 = (lo_u[:, None, others] * (64 - up0[..., None])
                    + hi_u[:, None, others] * up0[..., None] + 32) // 64
            rec1 = (lo_u[:, None, ccs] * (64 - up1)
                    + hi_u[:, None, ccs] * up1 + 32) // 64
            err = (((rec0 - rgb[..., others]) ** 2).sum(axis=(1, 2))
                   + ((rec1 - rgb[..., ccs]) ** 2).sum(-1)
                   + ((pxf[..., 3] - 255.0) ** 2).sum(-1))
            better = err < best_err
            for i in np.flatnonzero(better):
                lq, hq = _fix_subset_order(lo_q[i], hi_q[i], ep_rng)
                best[i] = (gw, gh, rng, wb, ep_rng, lq, hq,
                           c_p0[i], c_p1[i], ccs)
            best_err = np.where(better, err, best_err)
    return best_err, best


def encode_blocks_plan(px: np.ndarray, bw: int, bh: int,
                       has_alpha: bool, effort: int = 1,
                       allow_partitions: bool = False,
                       want_candidates: bool = False,
                       config_filter=None) -> dict:
    """Candidate search only: returns the per-block encode decisions
    without packing, shared by the physical-ASTC writer and the XUASTC
    entropy layer. Keys: config (B,) index into configs;
    configs [(gw, gh, weight_rng, weight_bits_or_-1, ep_rng)]; endpoints
    (list of per-block CEM-ordered ISE values, s0<=s1 ordering applied);
    codes (list of per-block weight ISE symbols, inverted on swap);
    two_part {block_index: (gw, gh, rng, wb, ep_rng, seed, lo_q, hi_q,
    codes)} for blocks where a 2-subset encode won (only when
    allow_partitions).

    config_filter: optional predicate over 5-tuples restricting the
    single-partition config bank (the XUASTC layer passes its trial-mode
    table membership so every emitted config is representable).

    want_candidates (truthy; pass the string "srgb" for sRGB decode
    semantics) additionally returns the full single-partition candidate
    bank for the SCD deblocking passes: cand_rec (B, ncfg, nt, 4) uint8
    decode-true reconstructions and cand_pack [(codes, lo_c, hi_c)] per
    config (see codecs/astc/scd.py)."""
    plan = _encode_blocks_core(px, bw, bh, has_alpha, effort,
                               allow_partitions, want_candidates,
                               config_filter)
    return plan


def config_candidate_block(plan: dict, i: int, ci: int):
    """(endpoint ISE values, weight codes) of single-partition candidate
    ci for block i from the plan's candidate bank — the identical s0<=s1
    canonicalization the winner assembly applies."""
    gw, gh, rng, wb, ep_rng = plan["configs"][ci]
    codes, lo_c, hi_c = plan["cand_pack"][ci]
    _, unq = _quant_tables(ep_rng)
    lc, hc, cd = lo_c[i], hi_c[i], codes[i]
    s0 = int(unq[lc[0]] + unq[lc[1]] + unq[lc[2]])
    s1 = int(unq[hc[0]] + unq[hc[1]] + unq[hc[2]])
    if s0 > s1:
        lc, hc = hc, lc
        cd = _weight_complement(rng)[cd]
    vals = []
    for comp in range(3):
        vals += [int(lc[comp]), int(hc[comp])]
    if plan["cem"] == 12:
        vals += [int(lc[3]), int(hc[3])]
    return vals, cd


def _encode_blocks_core(px: np.ndarray, bw: int, bh: int,
                        has_alpha: bool, effort: int = 1,
                        allow_partitions: bool = False,
                        want_candidates: bool = False,
                        config_filter=None) -> dict:
    b = px.shape[0]
    nt = bw * bh
    pxf = px.astype(np.float64)
    cem = 12 if has_alpha else 8
    comps = 4 if has_alpha else 3
    v = pxf[..., :comps]

    # principal-axis endpoints
    mean = v.mean(axis=1, keepdims=True)
    c = v - mean
    cov = np.einsum("bif,big->bfg", c, c)
    d = np.ones((b, comps))
    for _ in range(6):
        d = np.einsum("bfg,bg->bf", cov, d)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    proj = np.einsum("bif,bf->bi", c, d)
    lo = np.clip(mean[:, 0] + d * proj.min(1, keepdims=True), 0, 255)
    hi = np.clip(mean[:, 0] + d * proj.max(1, keepdims=True), 0, 255)

    # continuous ideal texel weights
    dd = hi - lo
    num = ((v - lo[:, None, :]) * dd[:, None, :]).sum(-1)
    den = np.maximum((dd * dd).sum(-1), 1e-9)
    w_tex = np.clip(64.0 * num / den[:, None], 0, 64)       # (B,nt)

    n_vals = 6 if cem == 8 else 8
    configs = _grid_configs_main(bw, bh, n_vals)
    if config_filter is not None:
        kept = tuple(c for c in configs if config_filter(c))
        if kept:
            configs = kept
    ones = np.ones(v.shape[:2])
    refine_iters = 1 + min(max(effort, 0), 3)
    cand = []
    for (gw, gh, rng, wb, ep_rng) in configs:
        inv, unq = _quant_tables(ep_rng)
        m, pinv = _infill_matrix(gw, gh, bw, bh)
        levels = np.array([ah.dequant_weight(x, rng)
                           for x in range(ah.ise_levels(rng))])
        lo_f, hi_f, wt = lo, hi, w_tex
        codes = lo_c = hi_c = None
        for it in range(refine_iters):
            grid_f = np.clip(wt @ pinv.T, 0, 64)
            codes = np.abs(grid_f[..., None] - levels).argmin(-1)
            gq = levels[codes]
            up = np.clip((gq @ (m.T * 64.0) + 32).astype(np.int64) >> 6,
                         0, 64)
            # alternate: LS endpoints given the decoded weights, then
            # re-derive ideal texel weights from the refined line
            lo_f, hi_f = _ls_endpoints_masked(v, up.astype(np.float64),
                                              ones)
            lo_c = inv[np.clip(np.round(lo_f), 0, 255).astype(np.int64)]
            hi_c = inv[np.clip(np.round(hi_f), 0, 255).astype(np.int64)]
            lo_u = unq[lo_c].astype(np.float64)
            hi_u = unq[hi_c].astype(np.float64)
            if it + 1 < refine_iters:
                dd = hi_u - lo_u
                num = ((v - lo_u[:, None, :]) * dd[:, None, :]).sum(-1)
                den = np.maximum((dd * dd).sum(-1), 1e-9)
                wt = np.clip(64.0 * num / den[:, None], 0, 64)
        gq = levels[codes]
        up = np.clip((gq @ (m.T * 64.0) + 32).astype(np.int64) >> 6, 0, 64)
        rec = (lo_u[:, None, :] * (64 - up[..., None])
               + hi_u[:, None, :] * up[..., None] + 32) // 64
        err = ((rec - v) ** 2).sum(axis=(1, 2))
        if not has_alpha:
            err = err + ((pxf[..., 3] - 255.0) ** 2).sum(-1)
        rec_u8 = None
        if want_candidates:
            # decode-true reconstruction for the SCD candidate bank:
            # 16-bit endpoint expansion (v<<8)|(srgb?0x80:v), interp,
            # top byte (basisu_astc_helpers.h:3601-3612) — the 8-bit
            # `rec` above is a search-time approximation
            lo_i = unq[lo_c].astype(np.int64)
            hi_i = unq[hi_c].astype(np.int64)
            ext = 0x80 if want_candidates == "srgb" else 0
            l16 = (lo_i << 8) | (ext if ext else lo_i)
            h16 = (hi_i << 8) | (ext if ext else hi_i)
            rec_t = (((l16[:, None, :] * (64 - up[..., None])
                       + h16[:, None, :] * up[..., None] + 32) >> 6) >> 8)
            rec_u8 = np.full((b, nt, 4), 255, np.uint8)
            rec_u8[..., :comps] = np.clip(rec_t, 0, 255).astype(np.uint8)
        cand.append((err, codes, lo_c, hi_c, ep_rng, rec_u8))
    err_mat = np.stack([cc[0] for cc in cand], 1)
    best = np.argmin(err_mat, axis=1)
    best_err1 = err_mat[np.arange(b), best]

    # running per-block winner error; later candidate families must beat it
    cur_err = best_err1.copy()

    two_part = {}
    if allow_partitions and effort >= 2 and nt > 16:
        err2, details = _two_partition_candidates(pxf, v, bw, bh, cem,
                                                  effort)
        if err2 is not None:
            for i in np.flatnonzero(err2 < cur_err):
                if details[i] is not None:
                    two_part[int(i)] = details[i]
                    cur_err[i] = err2[i]

    three_part = {}
    if allow_partitions and effort >= 2 and nt > 16:
        err3, details3 = _three_partition_candidates(pxf, v, bw, bh, cem,
                                                     effort)
        if err3 is not None:
            for i in np.flatnonzero(err3 < cur_err):
                if details3[i] is not None:
                    three_part[int(i)] = details3[i]
                    two_part.pop(int(i), None)
                    cur_err[i] = err3[i]

    dual_plane = {}
    if allow_partitions and has_alpha and effort >= 1:
        err_dp, details_dp = _dual_plane_candidates(pxf, bw, bh, effort)
        if err_dp is not None:
            for i in np.flatnonzero(err_dp < cur_err):
                if details_dp[i] is not None:
                    dual_plane[int(i)] = details_dp[i]
                    two_part.pop(int(i), None)
                    three_part.pop(int(i), None)
                    cur_err[i] = err_dp[i]

    dual_plane_rgb = {}
    if allow_partitions and not has_alpha and effort >= 1 and nt > 16:
        err_dpr, details_dpr = _dual_plane_rgb_candidates(pxf, bw, bh,
                                                          effort)
        if err_dpr is not None:
            for i in np.flatnonzero(err_dpr < cur_err):
                if details_dpr[i] is not None:
                    dual_plane_rgb[int(i)] = details_dpr[i]
                    two_part.pop(int(i), None)
                    three_part.pop(int(i), None)
                    cur_err[i] = err_dpr[i]

    log_override = {}
    if allow_partitions:
        err_la, la_blocks = _la_candidates(pxf, bw, bh, has_alpha, effort)
        for i in np.flatnonzero(err_la < cur_err):
            if la_blocks[i] is not None:
                log_override[int(i)] = la_blocks[i]
                two_part.pop(int(i), None)
                three_part.pop(int(i), None)
                dual_plane.pop(int(i), None)
                dual_plane_rgb.pop(int(i), None)

    endpoints = [None] * b
    out_codes = [None] * b
    cfg_list = []
    for ci, (gw, gh, rng, wb, ep_rng) in enumerate(configs):
        err, codes, lo_c, hi_c, _ep_rng, _rec = cand[ci]
        cfg_list.append((gw, gh, rng, wb, ep_rng))
        idx = np.flatnonzero(best == ci)
        if not idx.size:
            continue
        _, unq = _quant_tables(ep_rng)
        comp_lut = _weight_complement(rng)
        for i in idx:
            lc, hc, cd = lo_c[i], hi_c[i], codes[i]
            s0 = int(unq[lc[0]] + unq[lc[1]] + unq[lc[2]])
            s1 = int(unq[hc[0]] + unq[hc[1]] + unq[hc[2]])
            if s0 > s1:
                lc, hc = hc, lc
                cd = comp_lut[cd]
            vals = []
            for comp in range(3):
                vals += [int(lc[comp]), int(hc[comp])]
            if cem == 12:
                vals += [int(lc[3]), int(hc[3])]
            endpoints[i] = vals
            out_codes[i] = cd
    plan = dict(config=best, configs=cfg_list, endpoints=endpoints,
                codes=out_codes, cem=cem, two_part=two_part,
                three_part=three_part, dual_plane=dual_plane,
                dual_plane_rgb=dual_plane_rgb, log_override=log_override)
    if want_candidates:
        plan["cand_rec"] = np.stack([cc[5] for cc in cand], axis=1)
        plan["cand_err"] = err_mat
        plan["cand_pack"] = [(cc[1], cc[2], cc[3]) for cc in cand]
    return plan


def encode_blocks_ldr(px: np.ndarray, bw: int, bh: int,
                      has_alpha: bool, effort: int = 1,
                      scd_grid=None, srgb: bool = False) -> np.ndarray:
    """(B, bh*bw, 4) uint8 RGBA → (B, 16) ASTC LDR blocks.

    scd_grid=(nbx, nby): run the SCD deblocking-aware candidate descent
    (codecs/astc/scd.py) when the footprint deblocks at transcode."""
    from ...ops import deblock as deblock_ops
    from . import scd as scd_mod

    run_scd = (scd_grid is not None and scd_mod.scd_num_passes(effort) > 0
               and deblock_ops.default_deblock(bw, bh))
    plan = _encode_blocks_core(px, bw, bh, has_alpha, effort,
                               allow_partitions=True,
                               want_candidates=(("srgb" if srgb else True)
                                                if run_scd else False))
    from .hdr6x6_decode import pack_log_block

    b = px.shape[0]
    out = np.zeros((b, 16), dtype=np.uint8)
    for i in range(b):
        ov = plan["log_override"].get(i)
        if ov is not None:
            out[i] = np.frombuffer(pack_log_block(ov), dtype=np.uint8)
            continue
        dp = plan["dual_plane"].get(i)
        if dp is not None:
            out[i] = _pack_ldr_block_dp(*dp)
            continue
        dpr = plan["dual_plane_rgb"].get(i)
        if dpr is not None:
            out[i] = _pack_ldr_block_dp_rgb(*dpr)
            continue
        tp3 = plan["three_part"].get(i)
        if tp3 is not None:
            gw, gh, rng, wb, ep_rng, seed, lo_q, hi_q, codes = tp3
            out[i] = _pack_ldr_block_multi(plan["cem"], 3, gw, gh, rng, wb,
                                           ep_rng, seed, lo_q, hi_q, codes)
            continue
        tp = plan["two_part"].get(i)
        if tp is not None:
            gw, gh, rng, wb, ep_rng, seed, lo_q, hi_q, codes = tp
            out[i] = _pack_ldr_block2(plan["cem"], gw, gh, rng, wb, ep_rng,
                                      seed, lo_q, hi_q, codes)
            continue
        gw, gh, rng, wb, ep_rng = plan["configs"][plan["config"][i]]
        out[i] = _pack_ldr_block(
            plan["cem"], gw, gh, rng, wb, ep_rng,
            plan["endpoints"][i], plan["codes"][i])

    if run_scd and "cand_rec" in plan:
        nbx, nby = scd_grid
        chosen_px = ah.decode_blocks_rgba8(out, srgb=srgb, bw=bw, bh=bh)
        pad_img = px.reshape(nby, nbx, bh, bw, 4).transpose(
            0, 2, 1, 3, 4).reshape(nby * bh, nbx * bw, 4)
        changes = scd_mod.orchestrate(
            plan, chosen_px, px, pad_img, nbx, nby, bw, bh,
            has_alpha, effort, preserve_chroma=srgb)
        for i, action in changes.items():
            if action[0] == "solid":
                r, g, bl, a = action[1]
                blk = ah.LogBlock(solid_ldr=True,
                                  solid_color=(r | (r << 8), g | (g << 8),
                                               bl | (bl << 8), a | (a << 8)))
                out[i] = np.frombuffer(pack_log_block(blk), dtype=np.uint8)
                continue
            ci = action[1]
            gw, gh, rng, wb, ep_rng = plan["configs"][ci]
            vals, cd = config_candidate_block(plan, i, ci)
            out[i] = _pack_ldr_block(plan["cem"], gw, gh, rng, wb, ep_rng,
                                     vals, cd)
    return out


def _pack_ldr_block_dp(gw, gh, rng, wb, ep_rng, lo_q, hi_q, c_rgb, c_a):
    """CEM-12 dual-plane single-partition block, CCS=3 (alpha plane)."""
    wmax = (1 << wb) - 1
    w = astc_pack._BlockWriter()
    w.put(_find_block_mode_dp(gw, gh, rng), 11)
    w.put(0, 2)
    w.put(12, 4)
    vals = []
    for c in range(4):
        vals += [int(lo_q[c]), int(hi_q[c])]
    astc_pack._ise_encode(w, vals, ep_rng)
    # weights: two planes interleaved per grid sample, reversed from 127
    nw = gw * gh
    wbits = 0
    for i in range(nw):
        wbits |= (int(c_rgb[i]) & wmax) << (wb * (2 * i))
        wbits |= (int(c_a[i]) & wmax) << (wb * (2 * i + 1))
    nwb = 2 * nw * wb
    rev = astc_pack._reverse_bits64(wbits, nwb)
    w.put_at(rev, nwb, 128 - nwb)
    w.put_at(3, 2, 128 - nwb - 2)          # CCS = 3 (alpha)
    return np.frombuffer(w.to_bytes(), dtype=np.uint8)


def _pack_ldr_block_dp_rgb(gw, gh, rng, wb, ep_rng, lo_q, hi_q, c_p0, c_p1,
                           ccs: int):
    """CEM-8 dual-plane single-partition block, CCS in {0,1,2}: plane 1
    carries the selected RGB channel."""
    wmax = (1 << wb) - 1
    w = astc_pack._BlockWriter()
    w.put(_find_block_mode_dp(gw, gh, rng), 11)
    w.put(0, 2)
    w.put(8, 4)
    vals = []
    for c in range(3):
        vals += [int(lo_q[c]), int(hi_q[c])]
    astc_pack._ise_encode(w, vals, ep_rng)
    nw = gw * gh
    wbits = 0
    for i in range(nw):
        wbits |= (int(c_p0[i]) & wmax) << (wb * (2 * i))
        wbits |= (int(c_p1[i]) & wmax) << (wb * (2 * i + 1))
    nwb = 2 * nw * wb
    rev = astc_pack._reverse_bits64(wbits, nwb)
    w.put_at(rev, nwb, 128 - nwb)
    w.put_at(ccs, 2, 128 - nwb - 2)
    return np.frombuffer(w.to_bytes(), dtype=np.uint8)


def _pack_ldr_block_multi(cem, nparts, gw, gh, rng, wb, ep_rng, seed,
                          lo_q, hi_q, codes):
    """One CEM 8/12 block with 2..4 partitions sharing the CEM."""
    wmax = (1 << wb) - 1
    comps = 3 if cem == 8 else 4
    w = astc_pack._BlockWriter()
    w.put(_find_block_mode(gw, gh, rng), 11)
    w.put(nparts - 1, 2)
    w.put(int(seed), 10)
    w.put(cem << 2, 6)
    vals = []
    for s in range(nparts):
        for c in range(comps):
            vals += [int(lo_q[s][c]), int(hi_q[s][c])]
    astc_pack._ise_encode(w, vals, ep_rng)
    wbits = 0
    nwb = gw * gh * wb
    for i, cval in enumerate(codes):
        wbits |= (int(cval) & wmax) << (wb * i)
    rev = astc_pack._reverse_bits64(wbits, nwb)
    w.put_at(rev, nwb, 128 - nwb)
    return np.frombuffer(w.to_bytes(), dtype=np.uint8)


def _pack_ldr_block2(cem, gw, gh, rng, wb, ep_rng, seed, lo_q, hi_q, codes):
    """One CEM 8/12 two-partition block: 11-bit mode, '01' partition
    count, 10-bit seed, 6-bit all-same CEM, per-subset endpoint pairs."""
    wmax = (1 << wb) - 1
    comps = 3 if cem == 8 else 4
    w = astc_pack._BlockWriter()
    w.put(_find_block_mode(gw, gh, rng), 11)
    w.put(1, 2)                             # 2 partitions
    w.put(int(seed), 10)
    w.put(cem << 2, 6)                      # all partitions share the CEM
    vals = []
    for s in range(2):
        for c in range(comps):
            vals += [int(lo_q[s][c]), int(hi_q[s][c])]
    astc_pack._ise_encode(w, vals, ep_rng)
    wbits = 0
    nwb = gw * gh * wb
    for i, cval in enumerate(codes):
        wbits |= (int(cval) & wmax) << (wb * i)
    rev = astc_pack._reverse_bits64(wbits, nwb)
    w.put_at(rev, nwb, 128 - nwb)
    return np.frombuffer(w.to_bytes(), dtype=np.uint8)


def _pack_ldr_block(cem, gw, gh, rng, wb, ep_rng, vals, codes):
    """One CEM 8/12 single-partition block (endpoint ordering already
    applied by the plan so the decoder's blue-contract path stays off).
    Trit/quint weight ranges (wb == -1) go through the generic LogBlock
    packer, which ISE-encodes the reversed weight stream."""
    if wb < 0:
        from .hdr6x6_decode import pack_log_block

        blk = ah.LogBlock(
            grid_width=gw, grid_height=gh, dual_plane=False,
            weight_ise_range=rng, endpoint_ise_range=ep_rng,
            num_partitions=1, cems=(cem,),
            endpoints=[int(x) for x in vals],
            weights=[int(x) for x in codes])
        return np.frombuffer(pack_log_block(blk), dtype=np.uint8)
    wmax = (1 << wb) - 1

    w = astc_pack._BlockWriter()
    w.put(_find_block_mode(gw, gh, rng), 11)
    w.put(0, 2)
    w.put(cem, 4)
    astc_pack._ise_encode(w, vals, ep_rng)
    # weights reversed from bit 127
    wbits = 0
    nwb = gw * gh * wb
    for i, cval in enumerate(codes):
        wbits |= (int(cval) & wmax) << (wb * i)
    rev = astc_pack._reverse_bits64(wbits, nwb)
    w.put_at(rev, nwb, 128 - nwb)
    return np.frombuffer(w.to_bytes(), dtype=np.uint8)
