"""Copy of `basis_universal_tpu/codecs/uastc/decode.py`.

UASTC LDR 4x4 block unpacking and RGBA decode.

Behavioral contract: unpack_uastc / unpack_uastc_block
(transcoder/basisu_transcoder.cpp:15293+; block layout written by pack_uastc,
encoder/basisu_uastc_enc.cpp:110-360). Blocks are grouped by (mode,
common_pattern) so all bit offsets are static per group and field extraction
vectorizes over the group with uint64 lane arithmetic.
"""

import numpy as np

from . import tables as T


def _split_words(blocks):
    """(N,16) uint8 → (lo, hi) uint64 lanes."""
    b = np.ascontiguousarray(blocks, dtype=np.uint8)
    w = b.view("<u8").reshape(-1, 2)
    return w[:, 0].copy(), w[:, 1].copy()


def _rd(lo, hi, ofs: int, n: int):
    """Read n bits at static offset ofs from the 128-bit little-endian block."""
    if n == 0:
        return np.zeros(lo.shape, dtype=np.uint64)
    mask = np.uint64((1 << n) - 1)
    if ofs + n <= 64:
        return (lo >> np.uint64(ofs)) & mask
    if ofs >= 64:
        return (hi >> np.uint64(ofs - 64)) & mask
    return ((lo >> np.uint64(ofs)) | (hi << np.uint64(64 - ofs))) & mask


class UnpackedBlocks:
    """Struct-of-arrays for N unpacked UASTC blocks."""

    def __init__(self, n):
        self.mode = np.zeros(n, dtype=np.int32)
        self.solid_rgba = np.zeros((n, 4), dtype=np.uint8)
        self.endpoints = np.zeros((n, 18), dtype=np.int32)  # quantized values
        self.weights = np.zeros((n, 32), dtype=np.int32)    # plain values
        self.common_pattern = np.zeros(n, dtype=np.int32)
        self.ccs = np.full(n, -1, dtype=np.int32)
        self.etc1_bias = np.zeros(n, dtype=np.int32)
        self.etc1_hints = np.zeros((n, 6), dtype=np.int32)  # flip,diff,i0,i1,sel,rgb555
        self.etc2_hints = np.zeros(n, dtype=np.int32)
        self.bc1_hints = np.zeros((n, 2), dtype=np.int32)


def unpack_blocks(blocks) -> UnpackedBlocks:
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, 16)
    n = blocks.shape[0]
    lo, hi = _split_words(blocks)
    out = UnpackedBlocks(n)
    modes = T.MODE_LUT[(lo & np.uint64(127)).astype(np.int64)]
    if (modes == 255).any():
        raise ValueError("invalid UASTC mode code")
    out.mode[:] = modes

    for mode in np.unique(modes):
        idx = np.flatnonzero(modes == mode)
        mlo, mhi = lo[idx], hi[idx]
        ofs = T.MODE_HUFF_CODES[mode][1]
        if mode == T.MODE_SOLID:
            for c in range(4):
                out.solid_rgba[idx, c] = _rd(mlo, mhi, ofs, 8).astype(np.uint8)
                ofs += 8
            continue

        # hints
        if T.MODE_HAS_BC1_HINT0[mode]:
            out.bc1_hints[idx, 0] = _rd(mlo, mhi, ofs, 1); ofs += 1
        if T.MODE_HAS_BC1_HINT1[mode]:
            out.bc1_hints[idx, 1] = _rd(mlo, mhi, ofs, 1); ofs += 1
        out.etc1_hints[idx, 0] = _rd(mlo, mhi, ofs, 1); ofs += 1   # flip
        out.etc1_hints[idx, 1] = _rd(mlo, mhi, ofs, 1); ofs += 1   # diff
        out.etc1_hints[idx, 2] = _rd(mlo, mhi, ofs, 3); ofs += 3   # inten0
        out.etc1_hints[idx, 3] = _rd(mlo, mhi, ofs, 3); ofs += 3   # inten1
        if T.MODE_HAS_ETC1_BIAS[mode]:
            out.etc1_bias[idx] = _rd(mlo, mhi, ofs, 5); ofs += 5
        if T.MODE_HAS_ALPHA[mode]:
            out.etc2_hints[idx] = _rd(mlo, mhi, ofs, 8); ofs += 8

        # partitions
        if mode in T.MODES_WITH_PATTERN5:
            out.common_pattern[idx] = _rd(mlo, mhi, ofs, 5); ofs += 5
        elif mode == T.MODE_WITH_PATTERN4:
            out.common_pattern[idx] = _rd(mlo, mhi, ofs, 4); ofs += 4

        # dual plane component selector
        if mode in (6, 11, 13):
            out.ccs[idx] = _rd(mlo, mhi, ofs, 2); ofs += 2
        elif mode == 17:
            out.ccs[idx] = 3

        subsets = int(T.MODE_SUBSETS[mode])
        planes = int(T.MODE_PLANES[mode])
        comps = int(T.MODE_COMPS[mode])
        total_values = comps * 2 * subsets
        ep_range = int(T.MODE_ENDPOINT_RANGES[mode])
        ep_bits, ep_trits, ep_quints = T.BISE_RANGE_TABLE[ep_range]

        # trit/quint bundles first (last bundle truncated)
        tq_vals = []
        if ep_trits or ep_quints:
            bundle = 5 if ep_trits else 3
            total_tqs = -(-total_values // bundle)
            for i in range(total_tqs):
                nb = 8 if ep_trits else 7
                if i == total_tqs - 1:
                    rem = total_values - (total_tqs - 1) * bundle
                    if ep_trits:
                        nb = {1: 2, 2: 4, 3: 5, 4: 7, 5: 8}[rem]
                    else:
                        nb = {1: 3, 2: 5, 3: 7}[rem]
                tq_vals.append(_rd(mlo, mhi, ofs, nb).astype(np.int64))
                ofs += nb
        # raw endpoint bits
        mul = 3 if ep_trits else 5
        accum = None
        rem_in_bundle = 0
        tq_i = 0
        for i in range(total_values):
            v = _rd(mlo, mhi, ofs, ep_bits).astype(np.int64)
            ofs += ep_bits
            if ep_trits or ep_quints:
                if rem_in_bundle == 0:
                    accum = tq_vals[tq_i].copy()
                    tq_i += 1
                    rem_in_bundle = 5 if ep_trits else 3
                d = accum % mul
                accum //= mul
                rem_in_bundle -= 1
                v |= d << ep_bits
            out.endpoints[idx, i] = v

        # weights: anchor positions depend on the partition pattern
        wb = int(T.MODE_WEIGHT_BITS[mode])
        if subsets == 1:
            anchors_groups = {0: idx}
        else:
            anchors_groups = {}
            for cp in np.unique(out.common_pattern[idx]):
                anchors_groups[int(cp)] = idx[out.common_pattern[idx] == cp]
        for cp, gidx in anchors_groups.items():
            glo, ghi = lo[gidx], hi[gidx]
            seed = T.mode_pattern_seed(mode, cp)
            anchors = T.pattern_anchors(seed, subsets) if subsets > 1 else (0,)
            o2 = ofs
            plane_shift = 1 if planes == 2 else 0
            for i in range(16 * planes):
                nb = wb - (1 if ((i >> plane_shift) in anchors) else 0)
                out.weights[gidx, i] = _rd(glo, ghi, o2, nb)
                o2 += nb
    return out


def decode_rgba(blocks, srgb: bool = False) -> np.ndarray:
    """UASTC blocks (N,16) → (N,4,4,4) RGBA8."""
    u = unpack_blocks(blocks)
    n = u.mode.shape[0]
    out = np.zeros((n, 16, 4), dtype=np.uint8)
    out[..., 3] = 255

    for mode in np.unique(u.mode):
        idx = np.flatnonzero(u.mode == mode)
        if mode == T.MODE_SOLID:
            out[idx] = u.solid_rgba[idx][:, None, :]
            continue
        subsets = int(T.MODE_SUBSETS[mode])
        planes = int(T.MODE_PLANES[mode])
        comps = int(T.MODE_COMPS[mode])
        cem = int(T.MODE_CEM[mode])
        ep_range = int(T.MODE_ENDPOINT_RANGES[mode])
        unq = T.color_unquant_table(ep_range)
        wunq = T.weight_unquant_table(int(T.MODE_WEIGHT_BITS[mode]))

        eps = unq[u.endpoints[idx, :comps * 2 * subsets]].astype(np.int64)
        eps = eps.reshape(len(idx), subsets, comps, 2)        # lo/hi per comp

        # expand per-mode component layout to RGBA lo/hi
        lo8 = np.zeros((len(idx), subsets, 4), dtype=np.int64)
        hi8 = np.zeros((len(idx), subsets, 4), dtype=np.int64)
        if cem == 8:    # RGB direct
            lo8[..., :3] = eps[..., :3, 0]
            hi8[..., :3] = eps[..., :3, 1]
            lo8[..., 3] = 255
            hi8[..., 3] = 255
        elif cem == 12:  # RGBA direct
            lo8[..., :] = eps[..., :4, 0]
            hi8[..., :] = eps[..., :4, 1]
        elif cem == 4:   # LA
            lo8[..., 0] = lo8[..., 1] = lo8[..., 2] = eps[..., 0, 0]
            hi8[..., 0] = hi8[..., 1] = hi8[..., 2] = eps[..., 0, 1]
            lo8[..., 3] = eps[..., 1, 0]
            hi8[..., 3] = eps[..., 1, 1]

        # per-texel subset index
        if subsets == 1:
            pat = np.zeros((len(idx), 16), dtype=np.int64)
        else:
            pat = np.zeros((len(idx), 16), dtype=np.int64)
            for k, cp in enumerate(u.common_pattern[idx]):
                seed = T.mode_pattern_seed(mode, int(cp))
                pat[k] = T.partition_pattern(seed, subsets)

        w = wunq[u.weights[idx]]                               # (G,32) factors
        rows = np.arange(len(idx))[:, None]
        texel_lo = lo8[rows, pat]                              # (G,16,4)
        texel_hi = hi8[rows, pat]
        if planes == 1:
            wt = w[:, :16, None]                               # same for all ch
            px = T.astc_interpolate(texel_lo, texel_hi, np.broadcast_to(
                wt, texel_lo.shape), srgb)
        else:
            ccs = u.ccs[idx]
            w0 = w[:, 0::2]                                    # plane 0
            w1 = w[:, 1::2]                                    # plane 1
            if comps == 2:   # LA dual plane (mode 17): L=plane0, A=plane1
                wt = np.stack([w0, w0, w0, w1], axis=-1)
            else:
                wt = np.repeat(w0[:, :, None], 4, axis=2)
                for c in range(4):
                    sel = ccs == c
                    wt[sel, :, c] = w1[sel]
            px = T.astc_interpolate(texel_lo, texel_hi, wt, srgb)
        if cem == 8:
            px[..., 3] = 255
        out[idx] = px
    return out.reshape(n, 4, 4, 4)
