"""Copy of `basis_universal_tpu/codecs/astc/xuastc_encode.py`.

XUASTC LDR full-zstd encoder.

Produces the supercompressed "JPEG for ASTC" stream decoded by
xuastc_ldr.decode_log_blocks (spec: xuastc_ldr_decompress_image_full_zstd,
transcoder/basisu_transcoder.cpp:27633).

Block sources:
  - 4x4: the UASTC 19-mode search + byte-exact ASTC repack (the repo's
    strongest 4x4 ASTC encoder), unpacked back to logical blocks — the
    TPU analog of the reference's trial-mode tables spanning many CEMs
    and subsets (encoder/basisu_astc_ldr_encode.cpp:4207-4321).
  - other footprints: the direct LDR candidate search with 2-partition
    and dual-plane trials enabled (ldr_encode.encode_blocks_plan).
Weights are then re-picked under the true ASTC decode semantics
(codecs/astc/refine.py) before entropy coding.

Entropy layer (emission mirrors the decoder xuastc_ldr.decode_log_blocks
state machine exactly):
  - RAW blocks with trial-mode coding (tm hash / truncated binary),
    IS_BASE_OFS CEM promotion, canonical-unique partition patterns
    (part hash / truncated binary), any CEM/partition/dual-plane config
    present in the trial-mode table
  - config reuse from the left/up/diag neighbor (cfg_reuse < 3) and full
    config+endpoint REUSE modes — the stream's cheap-block vocabulary
  - BISE endpoint emission into the raw-bits stream
  - rank-space weight DPCM into the per-width side streams (per plane)
  - optional weight-grid DCT (quality 1-100, per plane) with the
    reference's fallback gates (compress_image_full_zstd,
    encoder/basisu_astc_ldr_encode.cpp:12671-12748)
  - SOLID blocks (DPCM vs the previous block's midpoint predictor)
  - RUN coding of repeated blocks
  - the 21-length full-zstd container (Zstd side streams)
"""

import functools

import numpy as np

from ..uastc import tables as T
from ..uastc.tables import BISE_RANGE_TABLE
from . import helpers as ah
from . import ldr_encode
from . import refine as refine_mod
from . import xuastc_cems as XC
from . import xuastc_dct as XD
from . import xuastc_tables as XT

_MODE_BYTE_IS_BASE_OFS = 1 << 3
_MODE_BYTE_PART_HASH_HIT = 1 << 4
_MODE_BYTE_TM_HASH_HIT = 1 << 6
_MODE_BYTE_USE_DCT = 1 << 7


class _LsbWriter:
    """bitwise_coder analog (LSB-first across bytes)."""

    def __init__(self):
        self.buf = bytearray()
        self.bit = 0
        self.acc = 0

    def put(self, value: int, nbits: int):
        self.acc |= (value & ((1 << nbits) - 1)) << self.bit
        self.bit += nbits
        while self.bit >= 8:
            self.buf.append(self.acc & 0xFF)
            self.acc >>= 8
            self.bit -= 8

    def put_truncated_binary(self, value: int, n: int):
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if value < u:
            self.put(value, k)
        else:
            v = value + u
            self.put(v >> 1, k)
            self.put(v & 1, 1)

    def to_bytes(self) -> bytes:
        out = bytes(self.buf)
        if self.bit:
            out += bytes([self.acc & 0xFF])
        return out


class _SimpleWriter:
    """simplified_bitwise_decoder's encode side: LSB-first within a byte,
    fields never cross byte boundaries (all users write uniform widths that
    divide 8)."""

    def __init__(self):
        self.buf = bytearray()
        self.bit = 8  # force new byte on first put

    def put(self, value: int, nbits: int):
        if self.bit + nbits > 8:
            self.buf.append(0)
            self.bit = 0
        self.buf[-1] |= (value & ((1 << nbits) - 1)) << self.bit
        self.bit += nbits

    def to_bytes(self) -> bytes:
        return bytes(self.buf)


def encode_values(w: _LsbWriter, vals, ise_range: int):
    """Inverse of decode_values (basisu_transcoder.cpp:23287): all
    trit/quint bundles first, then the per-value low bits."""
    bits, trits, quints = BISE_RANGE_TABLE[ise_range]
    n = len(vals)
    if trits or quints:
        bundle = 5 if trits else 3
        mul = 3 if trits else 5
        total_tqs = (n + bundle - 1) // bundle
        for i in range(total_tqs):
            nb = 8 if trits else 7
            if i == total_tqs - 1:
                rem = n - (total_tqs - 1) * bundle
                if trits:
                    nb = {1: 2, 2: 4, 3: 5, 4: 7}.get(rem, nb)
                else:
                    nb = {1: 3, 2: 5}.get(rem, nb)
            accum = 0
            for j in reversed(range(bundle)):
                idx = i * bundle + j
                t = (vals[idx] >> bits) if idx < n else 0
                accum = accum * mul + t
            w.put(accum, nb)
    mask = (1 << bits) - 1
    for v in vals:
        w.put(v & mask, bits)


@functools.lru_cache(maxsize=None)
def _tm_lookup(block_size_index: int):
    tms = XT.encoder_trial_modes(block_size_index)
    return {(t.grid_width, t.grid_height, t.cem, t.ccs_index,
             t.endpoint_ise_range, t.weight_ise_range, t.num_parts): i
            for i, t in enumerate(tms)}, len(tms)


@functools.lru_cache(maxsize=None)
def _canon_partition_map(bsi: int, num_parts: int):
    """canonical-pattern tuple → (unique_pat_index, canonical_seed,
    canonical-seed raw pattern)."""
    bw, bh = XT.ASTC_BLOCK_SIZES[bsi]
    small = bw * bh < 31
    out = {}
    for upi, seed in enumerate(XT.unique_partitions(bsi, num_parts)):
        pat = tuple(T.astc_select_partition(seed, x, y, 0, num_parts, small)
                    for y in range(bh) for x in range(bw))
        m = {}
        canon = []
        for v in pat:
            if v not in m:
                m[v] = len(m)
            canon.append(m[v])
        out[tuple(canon)] = (upi, seed, pat)
    return out


def _canonicalize_partition(blk, bsi: int):
    """Rewrite blk.partition_id to the stream's canonical seed for its
    pattern, permuting per-subset endpoints to match. Returns the
    unique_pat_index, or None if the pattern is not representable
    (doesn't use all subsets)."""
    bw, bh = XT.ASTC_BLOCK_SIZES[bsi]
    small = bw * bh < 31
    np_ = blk.num_partitions
    pat = tuple(T.astc_select_partition(blk.partition_id, x, y, 0, np_, small)
                for y in range(bh) for x in range(bw))
    if len(set(pat)) != np_:
        return None
    m = {}
    canon = []
    for v in pat:
        if v not in m:
            m[v] = len(m)
        canon.append(m[v])
    entry = _canon_partition_map(bsi, np_).get(tuple(canon))
    if entry is None:
        return None
    upi, seed, cpat = entry
    if seed != blk.partition_id:
        # label permutation: canonical subset cpat[i] holds the endpoints
        # of our subset pat[i]
        sigma = {}
        for i in range(len(pat)):
            sigma[pat[i]] = cpat[i]
        nv = XT.cem_num_values(blk.cems[0])
        new_eps = [0] * (np_ * nv)
        for s in range(np_):
            d = sigma[s]
            new_eps[d * nv:(d + 1) * nv] = blk.endpoints[s * nv:(s + 1) * nv]
        blk.endpoints = new_eps
        blk.partition_id = seed
    return upi


def _blk_key(blk):
    if blk.solid_ldr:
        return ("s",) + tuple(blk.solid_color)
    return (blk.cems, blk.num_partitions, blk.partition_id, blk.dual_plane,
            blk.ccs, blk.grid_width, blk.grid_height, blk.weight_ise_range,
            blk.endpoint_ise_range, tuple(blk.endpoints), tuple(blk.weights))


def _cfg_key(blk):
    return (blk.cems, blk.num_partitions, blk.partition_id, blk.dual_plane,
            blk.ccs, blk.grid_width, blk.grid_height, blk.weight_ise_range,
            blk.endpoint_ise_range)


def _solid_log_block(rgba, has_alpha: bool):
    r, g, b, a = (int(v) for v in rgba)
    if not has_alpha:
        a = 255
    return ah.LogBlock(solid_ldr=True,
                       solid_color=(r | (r << 8), g | (g << 8),
                                    b | (b << 8), a | (a << 8)))


def _plan_4x4(px: np.ndarray, has_alpha: bool, effort: int,
              device="cuda"):
    """UASTC 19-mode search (on `device`) → byte-exact ASTC repack →
    LogBlocks."""
    from ..uastc import astc_pack
    from ..uastc import encode as uastc_encode

    ub = uastc_encode.encode_blocks(px.astype(np.float32),
                                    effort=min(max(effort, 0), 4),
                                    has_alpha=has_alpha, device=device)
    astc = astc_pack.uastc_blocks_to_astc(ub)
    out = []
    for i in range(astc.shape[0]):
        blk = ah.unpack_block(astc[i].tobytes(), 4, 4)
        if blk is None:
            raise ValueError("repacked ASTC block failed to unpack")
        out.append(blk)
    return out


def _plan_direct(px: np.ndarray, bw: int, bh: int, has_alpha: bool,
                 effort: int, want_candidates: bool = False):
    """Direct LDR candidate search (with partition/dual-plane trials) →
    (LogBlocks, plan). Partition/dual-plane winners whose config has no
    trial-mode entry fall back to the block's single-partition candidate."""
    bsi = XT.ASTC_BLOCK_SIZES.index((bw, bh))
    lookup, _ = _tm_lookup(bsi)
    cem0 = 12 if has_alpha else 8
    plan = ldr_encode.encode_blocks_plan(
        px, bw, bh, has_alpha, effort=effort, allow_partitions=True,
        want_candidates=want_candidates,
        config_filter=lambda c: (c[0], c[1], cem0, -1, c[4], c[2], 1)
        in lookup)
    cem = plan["cem"]
    out = []
    for i in range(px.shape[0]):
        ov = plan["log_override"].get(i)
        if ov is not None:
            base = ov.cems[0] - 1 if ov.cems[0] in (9, 13) else ov.cems[0]
            key = (ov.grid_width, ov.grid_height, base,
                   ov.ccs if ov.dual_plane else -1,
                   ov.endpoint_ise_range, ov.weight_ise_range,
                   ov.num_partitions)
            if key in lookup:
                out.append(ov)
                continue
        dp = plan["dual_plane"].get(i)
        if dp is not None and (dp[0], dp[1], 12, 3, dp[4], dp[2], 1) \
                not in lookup:
            dp = None
        dpr = plan["dual_plane_rgb"].get(i)
        if dpr is not None and (dpr[0], dpr[1], 8, dpr[9], dpr[4], dpr[2], 1) \
                not in lookup:
            dpr = None
        tp3 = plan["three_part"].get(i)
        if tp3 is not None and (tp3[0], tp3[1], cem, -1, tp3[4], tp3[2], 3) \
                not in lookup:
            tp3 = None
        tp = plan["two_part"].get(i)
        if tp is not None and (tp[0], tp[1], cem, -1, tp[4], tp[2], 2) \
                not in lookup:
            tp = None
        if dpr is not None:
            gw, gh, rng, wb, ep_rng, lo_q, hi_q, c_p0, c_p1, ccs = dpr
            wts = [0] * (2 * gw * gh)
            for k in range(gw * gh):
                wts[2 * k] = int(c_p0[k])
                wts[2 * k + 1] = int(c_p1[k])
            eps = []
            for c in range(3):
                eps += [int(lo_q[c]), int(hi_q[c])]
            out.append(ah.LogBlock(
                grid_width=gw, grid_height=gh, dual_plane=True,
                weight_ise_range=rng, endpoint_ise_range=ep_rng,
                num_partitions=1, cems=(8,), ccs=int(ccs),
                endpoints=eps, weights=wts))
            continue
        if tp3 is not None:
            gw, gh, rng, wb, ep_rng, seed, lo_q, hi_q, codes = tp3
            comps = 3 if cem == 8 else 4
            eps = []
            for s in range(3):
                for c in range(comps):
                    eps += [int(lo_q[s][c]), int(hi_q[s][c])]
            out.append(ah.LogBlock(
                grid_width=gw, grid_height=gh, dual_plane=False,
                weight_ise_range=rng, endpoint_ise_range=ep_rng,
                num_partitions=3, partition_id=int(seed),
                cems=(cem, cem, cem), endpoints=eps,
                weights=[int(v) for v in codes]))
            continue
        if dp is not None:
            gw, gh, rng, wb, ep_rng, lo_q, hi_q, c_rgb, c_a = dp
            wts = [0] * (2 * gw * gh)
            for k in range(gw * gh):
                wts[2 * k] = int(c_rgb[k])
                wts[2 * k + 1] = int(c_a[k])
            eps = []
            for c in range(4):
                eps += [int(lo_q[c]), int(hi_q[c])]
            out.append(ah.LogBlock(
                grid_width=gw, grid_height=gh, dual_plane=True,
                weight_ise_range=rng, endpoint_ise_range=ep_rng,
                num_partitions=1, cems=(12,), ccs=3,
                endpoints=eps, weights=wts))
            continue
        if tp is not None:
            gw, gh, rng, wb, ep_rng, seed, lo_q, hi_q, codes = tp
            comps = 3 if cem == 8 else 4
            eps = []
            for s in range(2):
                for c in range(comps):
                    eps += [int(lo_q[s][c]), int(hi_q[s][c])]
            out.append(ah.LogBlock(
                grid_width=gw, grid_height=gh, dual_plane=False,
                weight_ise_range=rng, endpoint_ise_range=ep_rng,
                num_partitions=2, partition_id=int(seed),
                cems=(cem, cem), endpoints=eps,
                weights=[int(v) for v in codes]))
            continue
        gw, gh, rng, wb, ep_rng = plan["configs"][plan["config"][i]]
        out.append(ah.LogBlock(
            grid_width=gw, grid_height=gh, dual_plane=False,
            weight_ise_range=rng, endpoint_ise_range=ep_rng,
            num_partitions=1, cems=(cem,),
            endpoints=[int(v) for v in plan["endpoints"][i]],
            weights=[int(v) for v in plan["codes"][i]]))
    return out, plan


def _solid_rdo(blocks, info, px: np.ndarray, bw: int, bh: int,
               has_alpha: bool, srgb: bool, q: float) -> None:
    """Lossy-mode solid substitution (the dominant rate move in the
    reference's bounded RDO: at q25 the reference emits ~48% solid blocks,
    measured on kodim23; windowed RDO at
    encoder/basisu_astc_ldr_encode.cpp:11843). A block becomes a solid
    color whenever the solid's error does not exceed the DCT-coded
    block's actual decode error by more than the quality-scaled budget —
    at low q the weight-grid DCT often mangles smooth blocks worse than
    a flat fill that costs ~4 bytes."""
    from . import helpers as ah

    n = len(blocks)
    nt = bw * bh
    srcf = px.astype(np.int64)
    mean = np.round(px.astype(np.float64).mean(axis=1)).astype(np.int64)
    if not has_alpha:
        mean[:, 3] = 255
    err_solid = ((srcf - mean[:, None, :]) ** 2).sum(axis=(1, 2))

    # budget: fraction of the per-texel variance scale, growing as q drops
    lam = max(0.0, (100.0 - float(q)) / 100.0)
    budget = lam * lam * 8.0 * nt

    for i in range(n):
        blk = blocks[i]
        if blk.solid_ldr:
            continue
        dec = np.asarray(ah.decode_block(blk, bw, bh, srgb=srgb),
                         dtype=np.int64).reshape(nt, 4)
        err_coded = ((dec - srcf[i]) ** 2).sum()
        if err_solid[i] <= err_coded + budget:
            blocks[i] = _solid_log_block(mean[i], has_alpha)
            info[i] = None


def encode_image(rgba: np.ndarray, block_w: int, block_h: int,
                 has_alpha: bool, srgb: bool, effort: int = 1,
                 dct_quality=None, rdo_quality=None,
                 syntax: str = "full_zstd", device="cuda") -> bytes:
    """(H, W, 4) uint8 → XUASTC LDR stream.

    dct_quality: None = lossless entropy layer; 1-100 = weight-grid DCT
    quantization at that JPEG-style quality (the reference's m_dct_quality,
    encoder/basisu_astc_ldr_encode.h:46; stream contract decoded by
    xuastc_ldr.decode_log_blocks and the reference transcoder).

    syntax: entropy syntax — 'full_zstd' (default), 'hybrid'
    (HybridArithZstd), 'arith' (FullArith), or 'auto' which emits all three
    and returns the smallest, mirroring the reference's per-image syntax
    pick (transcoder ids basisu_transcoder_internal.h:2177-2184)."""
    h, w = rgba.shape[:2]
    nbx = -(-w // block_w)
    nby = -(-h // block_h)
    pad = np.pad(rgba, ((0, nby * block_h - h), (0, nbx * block_w - w),
                        (0, 0)), mode="edge")
    px = pad.reshape(nby, block_h, nbx, block_w, 4).transpose(
        0, 2, 1, 3, 4).reshape(nby * nbx, block_h * block_w, 4)

    bsi = XT.ASTC_BLOCK_SIZES.index((block_w, block_h))
    lookup, n_tms = _tm_lookup(bsi)
    trial_modes = XT.encoder_trial_modes(bsi)
    n_blocks = nbx * nby

    solid = np.all(px == px[:, :1, :], axis=(1, 2))

    use_dct = dct_quality is not None and 0.0 < float(dct_quality) <= 100.0
    q = float(dct_quality) if use_dct else 0.0

    # SCD deblocking-aware descent: default on >=10x8 footprints, effort
    # >= 2, incompatible with lossy supercompression (the reference
    # disables DCT when SCD is on, basisu_comp.cpp:1655-1666,
    # basisu_astc_ldr_encode.cpp:14887)
    from ...ops import deblock as deblock_ops
    from . import scd
    run_scd = (not use_dct and scd.scd_num_passes(effort) > 0
               and deblock_ops.default_deblock(block_w, block_h))

    # --- per-block logical plan
    direct_plan = None
    if (block_w, block_h) == (4, 4):
        planned = _plan_4x4(px, has_alpha, effort, device)
    else:
        planned, direct_plan = _plan_direct(
            px, block_w, block_h, has_alpha, effort,
            want_candidates=(("srgb" if srgb else True)
                             if run_scd else False))
    run_scd = run_scd and direct_plan is not None \
        and "cand_rec" in direct_plan

    # --- resolve emission info per block; canonicalize partitions, find
    # trial modes, apply the decode-true weight refinement, run the DCT
    blocks = [None] * n_blocks          # final LogBlock per position
    info = [None] * n_blocks            # (tm_index, base_ofs, upi, dct)
    coeff_thresh_cache = {}
    for i in range(n_blocks):
        if solid[i]:
            blocks[i] = _solid_log_block(px[i, 0], has_alpha)
            continue
        blk = planned[i]
        if blk.solid_ldr:
            blocks[i] = blk
            continue
        upi = None
        if blk.num_partitions > 1:
            upi = _canonicalize_partition(blk, bsi)
            if upi is None:
                # pattern not canonical-representable (doesn't use every
                # subset); re-plan this block single-partition
                cem0 = 12 if has_alpha else 8
                p1 = ldr_encode.encode_blocks_plan(
                    px[i:i + 1], block_w, block_h, has_alpha,
                    effort=effort, allow_partitions=False,
                    config_filter=lambda c: (c[0], c[1], cem0, -1, c[4],
                                             c[2], 1) in lookup)
                gw, gh, rng, wb, ep_rng = p1["configs"][p1["config"][0]]
                blk = ah.LogBlock(
                    grid_width=gw, grid_height=gh, dual_plane=False,
                    weight_ise_range=rng, endpoint_ise_range=ep_rng,
                    num_partitions=1, cems=(p1["cem"],),
                    endpoints=[int(v) for v in p1["endpoints"][0]],
                    weights=[int(v) for v in p1["codes"][0]])
        cem = blk.cems[0]
        base_cem = cem - 1 if cem in (9, 13) else cem
        ccs = blk.ccs if blk.dual_plane else -1
        key = (blk.grid_width, blk.grid_height, base_cem, ccs,
               blk.endpoint_ise_range, blk.weight_ise_range,
               blk.num_partitions)
        tm_index = lookup.get(key)
        if tm_index is None:
            raise ValueError(f"no trial mode for config {key}")

        refine_mod.refine_log_block_weights(blk, px[i], block_w, block_h,
                                            srgb)

        dct = None
        if use_dct:
            spans = XD.get_max_span_len(blk, XC)
            total_planes = 2 if blk.dual_plane else 1
            thresh = coeff_thresh_cache.setdefault(
                (blk.grid_width, blk.grid_height),
                (blk.grid_width * blk.grid_height * 45 + 64) >> 7)
            plane_syms = []
            ok = True
            for plane in range(total_planes):
                dc_sym, ndc, coeffs, max_mag = XD.code_block_weights(
                    q, plane, blk, block_w, block_h, spans[plane])
                ncoded = sum(1 for _, c in coeffs if c is not None)
                if not (coeffs and max_mag <= 255 and ncoded <= thresh):
                    ok = False
                plane_syms.append((dc_sym, ndc, tuple(coeffs)))
            if ok:
                dct = tuple(plane_syms)
            # replace weights with the post-quant reconstruction (the
            # reference does this before emission even when the block
            # falls back to DPCM)
            for plane in range(total_planes):
                dc_sym, ndc, coeffs = plane_syms[plane]
                XD.decode_block_weights_from_syms(
                    q, plane, blk, block_w, block_h, dc_sym,
                    [c for c in coeffs if c[1] is not None], spans[plane])

        blocks[i] = blk
        info[i] = (tm_index, cem in (9, 13), upi, dct)

    if use_dct:
        _solid_rdo(blocks, info, px, block_w, block_h, has_alpha, srgb,
                   q if rdo_quality is None else float(rdo_quality))

    if run_scd:
        # SCD: re-pick per-block candidates under the deblock filter the
        # transcoder will apply (codecs/astc/scd.py)
        chosen_px = np.zeros((n_blocks, block_h, block_w, 4), np.uint8)
        for i in range(n_blocks):
            chosen_px[i] = np.asarray(
                ah.decode_block(blocks[i], block_w, block_h, srgb=srgb))
        cem = direct_plan["cem"]

        def _cfg_ok(cfg):
            gw, gh, rng, wb, ep_rng = cfg
            return (gw, gh, cem, -1, ep_rng, rng, 1) in lookup

        changes = scd.orchestrate(
            direct_plan, chosen_px, px, pad, nbx, nby, block_w, block_h,
            has_alpha, effort, preserve_chroma=srgb, config_ok=_cfg_ok)
        for i, action in changes.items():
            if action[0] == "solid":
                blocks[i] = _solid_log_block(
                    np.array(action[1], np.uint8), has_alpha)
                info[i] = None
                continue
            ci = action[1]
            gw, gh, rng, wb, ep_rng = direct_plan["configs"][ci]
            vals, cd = ldr_encode.config_candidate_block(direct_plan, i, ci)
            blk = ah.LogBlock(
                grid_width=gw, grid_height=gh, dual_plane=False,
                weight_ise_range=rng, endpoint_ise_range=ep_rng,
                num_partitions=1, cems=(cem,), endpoints=vals,
                weights=[int(v) for v in cd])
            refine_mod.refine_log_block_weights(blk, px[i], block_w,
                                                block_h, srgb)
            blocks[i] = blk
            info[i] = (lookup[(gw, gh, cem, -1, ep_rng, rng, 1)],
                       False, None, None)

    # --- emission
    arith_out = None
    if syntax in ("arith", "hybrid", "auto"):
        from . import xuastc_arith_encode as XA

        cand = [XA.emit_arith(
            blocks, info, bsi=bsi, width=w, height=h, has_alpha=has_alpha,
            srgb=srgb, use_dct=use_dct, q=q, nbx=nbx, nby=nby,
            hybrid=hyb) for hyb in
            ((False,) if syntax == "arith" else
             (True,) if syntax == "hybrid" else (False, True))]
        arith_out = min(cand, key=len)
        if syntax != "auto":
            return arith_out

    import zstandard    # the FullArith syntax above needs none

    # full-zstd syntax, mirroring the decoder's ring/hash state
    raw = _LsbWriter()
    mode_w = _SimpleWriter()
    solid_w = _SimpleWriter()
    w2 = _SimpleWriter()
    w3 = _SimpleWriter()
    w4 = _SimpleWriter()
    w8 = _SimpleWriter()
    mean0_w = _SimpleWriter()
    mean1_w = _SimpleWriter()
    run_w = _SimpleWriter()
    coeff_w = _SimpleWriter()
    sign_w = _SimpleWriter()

    raw.put(0x01, 5)                      # FULL_ZSTD_HEADER_MARKER
    raw.put(bsi, 4)
    raw.put(1 if srgb else 0, 1)
    raw.put(w, 16)
    raw.put(h, 16)
    raw.put(1 if has_alpha else 0, 1)
    raw.put(1 if use_dct else 0, 1)
    if use_dct:
        raw.put(int(round(q * 2.0)), 8)   # dct_q stored in half-steps

    tm_hash = [-1] * XT.TM_HASH_SIZE
    part2_hash = [-1] * XT.PART_HASH_SIZE
    part3_hash = [-1] * XT.PART_HASH_SIZE
    log_ring = [[None] * nbx for _ in range(8)]
    tm_ring = [[-1] * nbx for _ in range(2)]
    keys = [_blk_key(b) for b in blocks]

    def emit_weights_dpcm(blk):
        wtab = XT.weight_tab(blk.weight_ise_range)
        n_levels = int(wtab.ise_to_val.shape[0])
        if n_levels <= 4:
            wr, nb = w2, 2
        elif n_levels <= 8:
            wr, nb = w3, 4
        elif n_levels <= 16:
            wr, nb = w4, 4
        else:
            wr, nb = w8, 8
        total_planes = 2 if blk.dual_plane else 1
        nw = blk.grid_width * blk.grid_height
        for plane in range(total_planes):
            prev_w = n_levels // 2
            for k in range(nw):
                cur = int(wtab.ise_to_rank[
                    blk.weights[k * total_planes + plane]])
                wr.put((cur - prev_w) % n_levels, nb)
                prev_w = cur

    def emit_weights_dct(blk, dct):
        for plane in range(2 if blk.dual_plane else 1):
            dc_sym, ndc, coeffs = dct[plane]
            if ndc == XD.DCT_MEAN_LEVELS1:
                mean1_w.put(dc_sym, 8)
            else:
                mean0_w.put(dc_sym, 4)
            for num_zeros, coeff in coeffs:
                if coeff is None:             # EOB
                    run_w.put(XD.DCT_RUN_LEN_EOB_SYM_INDEX, 8)
                else:
                    run_w.put(num_zeros, 8)
                    sign_w.put(1 if coeff < 0 else 0, 1)
                    coeff_w.put(abs(coeff) - 1, 8)

    i = 0
    while i < n_blocks:
        bx = i % nbx
        by = i // nbx
        blk = blocks[i]
        left_tm = tm_ring[by & 1][bx - 1] if bx else -1
        up_tm = tm_ring[(by - 1) & 1][bx] if by else -1
        diag_tm = tm_ring[(by - 1) & 1][bx - 1] if (bx and by) else -1

        # RUN: repeat of left (or, at a row start, the block above)
        prev_blk = (log_ring[by & 7][bx - 1] if bx
                    else (log_ring[(by - 1) & 7][bx] if by else None))
        if prev_blk is not None and keys[i] == _blk_key(prev_blk):
            run_len = 1
            max_run = min(64, nbx - bx)
            while (run_len < max_run and i + run_len < n_blocks
                   and keys[i + run_len] == keys[i]):
                run_len += 1
            mode_w.put(0b01 | ((run_len - 1) << 2), 8)
            for j in range(run_len):
                cx = bx + j
                log_ring[by & 7][cx] = prev_blk
                tm_ring[by & 1][cx] = (tm_ring[by & 1][cx - 1] if cx
                                       else up_tm)
            i += run_len
            continue

        if blk.solid_ldr:
            prev_c = [0, 0, 0, 0]
            if prev_blk is not None:
                if prev_blk.solid_ldr:
                    prev_c = [v >> 8 for v in prev_blk.solid_color]
                else:
                    pl, ph = XC.decode_endpoints(
                        prev_blk.cems[0], prev_blk.endpoints,
                        prev_blk.endpoint_ise_range)
                    prev_c = [(pl[k] + ph[k] + 1) >> 1 for k in range(4)]
            col = [v >> 8 for v in blk.solid_color]
            mode_w.put(0b0011, 8)
            solid_w.put((col[0] - prev_c[0]) & 0xFF, 8)
            solid_w.put((col[1] - prev_c[1]) & 0xFF, 8)
            solid_w.put((col[2] - prev_c[2]) & 0xFF, 8)
            if has_alpha:
                solid_w.put((col[3] - prev_c[3]) & 0xFF, 8)
            log_ring[by & 7][bx] = blk
            tm_ring[by & 1][bx] = -1
            i += 1
            continue

        tm_index, base_ofs, upi, dct = info[i]
        dct_flag = _MODE_BYTE_USE_DCT if dct is not None else 0

        # full config+endpoint REUSE from a neighbor
        neigh = ((0, log_ring[by & 7][bx - 1] if bx else None, left_tm),
                 (1, log_ring[(by - 1) & 7][bx] if by else None, up_tm),
                 (2, log_ring[(by - 1) & 7][bx - 1] if (bx and by) else None,
                  diag_tm))
        reuse_idx = -1
        cfg_idx = -1
        my_cfg = _cfg_key(blk)
        for idx, nb_blk, nb_tm in neigh:
            if nb_blk is None or nb_blk.solid_ldr or nb_tm < 0:
                continue
            if _cfg_key(nb_blk) != my_cfg or nb_tm != tm_index:
                continue
            if cfg_idx < 0:
                cfg_idx = idx
            if (reuse_idx < 0
                    and list(nb_blk.endpoints) == list(blk.endpoints)):
                reuse_idx = idx
        if reuse_idx >= 0:
            mode_w.put(((reuse_idx + 1) << 2) | 0b11 | dct_flag, 8)
        elif cfg_idx >= 0:
            mode_w.put((cfg_idx << 1) | dct_flag, 8)
            encode_values(raw, list(blk.endpoints), blk.endpoint_ise_range)
        else:
            mode_byte = 0b110 | dct_flag
            hit = tm_hash[XT.tm_hash_index(tm_index)] == tm_index
            if hit:
                mode_byte |= _MODE_BYTE_TM_HASH_HIT
            if base_ofs:
                mode_byte |= _MODE_BYTE_IS_BASE_OFS
            phash = None
            phit = False
            if blk.num_partitions > 1:
                phash = part2_hash if blk.num_partitions == 2 else part3_hash
                phit = phash[XT.part_hash_index(upi)] == upi
                if phit:
                    mode_byte |= _MODE_BYTE_PART_HASH_HIT
            mode_w.put(mode_byte, 8)
            if hit:
                raw.put(XT.tm_hash_index(tm_index), XT.TM_HASH_BITS)
            else:
                raw.put_truncated_binary(tm_index, n_tms)
                tm_hash[XT.tm_hash_index(tm_index)] = tm_index
            if blk.num_partitions > 1:
                if phit:
                    raw.put(XT.part_hash_index(upi), XT.PART_HASH_BITS)
                else:
                    raw.put_truncated_binary(
                        upi, XT.get_total_unique_patterns(
                            bsi, blk.num_partitions))
                    phash[XT.part_hash_index(upi)] = upi
            encode_values(raw, list(blk.endpoints), blk.endpoint_ise_range)

        if dct is not None:
            emit_weights_dct(blk, dct)
        else:
            emit_weights_dpcm(blk)
        log_ring[by & 7][bx] = blk
        tm_ring[by & 1][bx] = tm_index
        i += 1

    raw.put(0xAF, 8)                      # FINAL_SYNC_MARKER

    cctx = zstandard.ZstdCompressor(level=19)
    raw_bytes = raw.to_bytes()
    streams = {name: b"" for name in [
        "mode_bytes", "solid_dpcm_bytes", "endpoint_dpcm_reuse_indices",
        "use_bc_bits", "endpoint_dpcm_3bit", "endpoint_dpcm_4bit",
        "endpoint_dpcm_5bit", "endpoint_dpcm_6bit", "endpoint_dpcm_7bit",
        "endpoint_dpcm_8bit", "mean0_bits", "mean1_bytes", "run_bytes",
        "coeff_bytes", "sign_bits", "weight2_bits", "weight3_bits",
        "weight4_bits", "weight8_bytes"]}
    streams["mode_bytes"] = mode_w.to_bytes()
    streams["solid_dpcm_bytes"] = solid_w.to_bytes()
    streams["weight2_bits"] = w2.to_bytes()
    streams["weight3_bits"] = w3.to_bytes()
    streams["weight4_bits"] = w4.to_bytes()
    streams["weight8_bytes"] = w8.to_bytes()
    streams["mean0_bits"] = mean0_w.to_bytes()
    streams["mean1_bytes"] = mean1_w.to_bytes()
    streams["run_bytes"] = run_w.to_bytes()
    streams["coeff_bytes"] = coeff_w.to_bytes()
    streams["sign_bits"] = sign_w.to_bytes()

    import struct

    comp = {}
    for name, data in streams.items():
        if name == "sign_bits":
            comp[name] = data                     # stored raw
        else:
            comp[name] = cctx.compress(data) if data else b""

    order = ["mode_bytes", "solid_dpcm_bytes", "endpoint_dpcm_reuse_indices",
             "use_bc_bits", "endpoint_dpcm_3bit", "endpoint_dpcm_4bit",
             "endpoint_dpcm_5bit", "endpoint_dpcm_6bit",
             "endpoint_dpcm_7bit", "endpoint_dpcm_8bit", "mean0_bits",
             "mean1_bytes", "run_bytes", "coeff_bytes", "sign_bits",
             "weight2_bits", "weight3_bits", "weight4_bits",
             "weight8_bytes"]
    lens = [len(raw_bytes)] + [len(comp[n]) for n in order] + [0]
    out = bytearray()
    out.append(2)                                 # SYNTAX_FULL_ZSTD
    out += struct.pack("<21I", *lens)
    out += raw_bytes
    for n in order:
        out += comp[n]
    if arith_out is not None and len(arith_out) < len(out):
        return arith_out
    return bytes(out)
