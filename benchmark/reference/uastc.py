"""UASTC LDR 4x4 block decoding in NumPy: (N, 16) blocks to RGBA8 texels.

A frozen copy of the port's host decoder (`codecs/uastc/decode.py` with the
tables of `codecs/uastc/tables.py` it reads), which follows the reference
transcoder's unpack_uastc (`basisu_transcoder.cpp`) and the Khronos ASTC
specification for partitions, BISE and unquantisation. The partition
pattern of each block is looked up from a table instead of a loop over
blocks.
"""

import functools

import numpy as np

MODE_SOLID = 8
MODE_WEIGHT_BITS = np.array([4, 2, 3, 2, 2, 3, 2, 2, 0, 2, 4, 2, 3, 1, 2, 4,
                             2, 2, 5])
MODE_ENDPOINT_RANGES = np.array([19, 20, 8, 7, 12, 20, 18, 12, 0, 8, 13, 13,
                                 19, 20, 20, 20, 20, 20, 11])
MODE_SUBSETS = np.array([1, 1, 2, 3, 2, 1, 1, 2, 0, 2, 1, 1, 1, 1, 1, 1, 2,
                         1, 1])
MODE_PLANES = np.array([1, 1, 1, 1, 1, 1, 2, 1, 0, 1, 1, 2, 1, 2, 1, 1, 1, 2,
                        1])
MODE_COMPS = np.array([3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 2, 2, 2,
                       3])
MODE_HAS_ETC1_BIAS = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1,
                               1, 1, 1])
MODE_HAS_BC1_HINT0 = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1])
MODE_HAS_BC1_HINT1 = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1,
                               1, 1, 1])
MODE_CEM = np.array([8, 8, 8, 8, 8, 8, 8, 8, 0, 12, 12, 12, 12, 12, 12, 4, 4,
                     4, 8])
MODE_HAS_ALPHA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                           1, 0])
MODE_HUFF_CODES = [
    (0x1, 4), (0x35, 6), (0x1D, 5), (0x3, 5), (0x13, 5), (0xB, 5), (0x1B, 5),
    (0x7, 5), (0x17, 5), (0xF, 5), (0x2, 3), (0x0, 2), (0x6, 3), (0x1F, 5),
    (0xD, 5), (0x5, 7), (0x15, 6), (0x25, 6), (0x9, 4), (0x45, 7)]
MODES_WITH_PATTERN5 = (2, 4, 7, 9, 16)
MODE_WITH_PATTERN4 = 3
# ASTC partition seeds of the common patterns (second column of the
# reference's (bc7, astc_seed, invert/perm) interop tables)
SEEDS2 = [28, 20, 16, 29, 91, 9, 107, 72, 149, 204, 50, 114, 496, 17, 78, 39,
          252, 828, 43, 156, 116, 210, 476, 273, 684, 359, 246, 195, 694, 524]
SEEDS_MODE7 = [36, 48, 61, 137, 161, 183, 226, 281, 302, 307, 479, 495, 593,
               594, 605, 799, 812, 988, 993]
SEEDS3 = [260, 74, 32, 156, 183, 15, 745, 0, 335, 902, 254]
# ASTC BISE ranges: (bits, trits, quints) per range index
BISE_RANGE_TABLE = [
    (1, 0, 0), (0, 1, 0), (2, 0, 0), (0, 0, 1), (1, 1, 0), (3, 0, 0),
    (1, 0, 1), (2, 1, 0), (4, 0, 0), (2, 0, 1), (3, 1, 0), (5, 0, 0),
    (3, 0, 1), (4, 1, 0), (6, 0, 0), (4, 0, 1), (5, 1, 0), (7, 0, 0),
    (5, 0, 1), (6, 1, 0), (8, 0, 0)]


def _mode_lut():
    lut = np.full(128, 255, np.uint8)
    for mode, (code, size) in enumerate(MODE_HUFF_CODES):
        for i in range(1 << (7 - size)):
            lut[code | (i << size)] = mode
    return lut


MODE_LUT = _mode_lut()


def _hash52(p: int) -> int:
    p &= 0xFFFFFFFF
    p ^= p >> 15
    p = (p - (p << 17)) & 0xFFFFFFFF
    p = (p + (p << 7)) & 0xFFFFFFFF
    p = (p + (p << 4)) & 0xFFFFFFFF
    p ^= p >> 5
    p = (p + (p << 16)) & 0xFFFFFFFF
    p ^= p >> 7
    p ^= p >> 3
    p ^= (p << 6) & 0xFFFFFFFF
    p ^= p >> 17
    return p & 0xFFFFFFFF


def _select_partition(seed: int, x: int, y: int, count: int) -> int:
    """ASTC select_partition for a small (4x4) block, z = 0."""
    x <<= 1
    y <<= 1
    seed += (count - 1) * 1024
    rnum = _hash52(seed)
    s = [(rnum >> (4 * i)) & 0xF for i in range(8)]
    s += [(rnum >> 18) & 0xF, (rnum >> 22) & 0xF, (rnum >> 26) & 0xF,
          (rnum >> 30) & 0xF]
    s = [v * v for v in s]
    if seed & 1:
        sh1 = 4 if seed & 2 else 5
        sh2 = 6 if count == 3 else 5
    else:
        sh1 = 6 if count == 3 else 5
        sh2 = 4 if seed & 2 else 5
    sh3 = sh1 if seed & 0x10 else sh2
    for i in range(8):
        s[i] >>= sh1 if i % 2 == 0 else sh2
    for i in range(8, 12):
        s[i] >>= sh3
    a = (s[0] * x + s[1] * y + (rnum >> 14)) & 0x3F
    b = (s[2] * x + s[3] * y + (rnum >> 10)) & 0x3F
    c = (s[4] * x + s[5] * y + (rnum >> 6)) & 0x3F if count > 2 else 0
    d = 0
    if a >= b and a >= c and a >= d:
        return 0
    if b >= c and b >= d:
        return 1
    return 2 if c >= d else 3


@functools.lru_cache(maxsize=None)
def _pattern(seed: int, subsets: int) -> tuple:
    return tuple(_select_partition(seed, i & 3, i >> 2, subsets)
                 for i in range(16))


def _pattern_seeds(mode: int):
    if mode == 3:
        return SEEDS3
    if mode == 7:
        return SEEDS_MODE7
    return SEEDS2


def _replicate(v: int, src_bits: int, dst_bits: int = 8) -> int:
    out = 0
    shift = dst_bits - src_bits
    while shift > -src_bits:
        out |= (v << shift) if shift >= 0 else (v >> -shift)
        shift -= src_bits
    return out & ((1 << dst_bits) - 1)


def _tq_b(m: int, bits: int, trit: bool) -> int:
    """The 9-bit B term of ASTC endpoint unquantisation (spec 18.13)."""
    x = [(m >> i) & 1 for i in range(8)]
    b, c, d, e, f = x[1], x[2], x[3], x[4], x[5]
    if bits == 1:
        return 0
    if trit:
        return {2: (b << 8) | (b << 4) | (b << 2) | (b << 1),
                3: (c << 8) | (b << 7) | (c << 3) | (b << 2) | (c << 1) | b,
                4: (d << 8) | (c << 7) | (b << 6) | (d << 2) | (c << 1) | b,
                5: (e << 8) | (d << 7) | (c << 6) | (b << 5) | (e << 1) | d,
                6: (f << 8) | (e << 7) | (d << 6) | (c << 5) | (b << 4) | f,
                }[bits]
    return {2: (b << 8) | (b << 3) | (b << 2),
            3: (c << 8) | (b << 7) | (c << 2) | (b << 1) | c,
            4: (d << 8) | (c << 7) | (b << 6) | (d << 1) | c,
            5: (e << 8) | (d << 7) | (c << 6) | (b << 5) | e}[bits]


@functools.lru_cache(maxsize=None)
def color_unquant_table(range_index: int) -> np.ndarray:
    """Quantised endpoint value (bits | trit or quint << bits) -> 0..255."""
    bits, trits, quints = BISE_RANGE_TABLE[range_index]
    n_tq = 3 if trits else (5 if quints else 1)
    out = np.zeros(n_tq << bits, np.uint8)
    for tq in range(n_tq):
        for m in range(1 << bits):
            if not trits and not quints:
                v = _replicate(m, bits)
            else:
                a = 0x1FF if m & 1 else 0
                c = ({1: 204, 2: 93, 3: 44, 4: 22, 5: 11, 6: 5} if trits
                     else {1: 113, 2: 54, 3: 26, 4: 13, 5: 6})[bits]
                t = (tq * c + _tq_b(m, bits, bool(trits))) ^ a
                v = (a & 0x80) | (t >> 2)
            out[(tq << bits) | m] = v
    return out


@functools.lru_cache(maxsize=None)
def weight_unquant_table(weight_bits: int) -> np.ndarray:
    out = np.zeros(1 << weight_bits, np.int32)
    for v in range(1 << weight_bits):
        w = v * 63 if weight_bits == 1 else _replicate(v, weight_bits, 6)
        out[v] = w + 1 if w > 32 else w
    return out


def _rd(lo, hi, ofs: int, n: int):
    """n bits at offset ofs of the 128-bit little-endian blocks."""
    if n == 0:
        return np.zeros(lo.shape, np.uint64)
    mask = np.uint64((1 << n) - 1)
    if ofs + n <= 64:
        return (lo >> np.uint64(ofs)) & mask
    if ofs >= 64:
        return (hi >> np.uint64(ofs - 64)) & mask
    return ((lo >> np.uint64(ofs)) | (hi << np.uint64(64 - ofs))) & mask


class DecodeError(ValueError):
    """A block that is not a UASTC LDR 4x4 block."""


def modes(blocks) -> np.ndarray:
    """(N, 16) uint8 UASTC blocks -> (N,) each block's mode, 0-18 (8 the
    solid colour)."""
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    lo = blocks.view("<u8").reshape(-1, 2)[:, 0]
    out = MODE_LUT[(lo & np.uint64(127)).astype(np.int64)]
    if (out > 18).any():
        raise DecodeError("invalid UASTC mode code")
    return out


def decode_rgba(blocks) -> np.ndarray:
    """(N, 16) uint8 UASTC blocks -> (N, 16, 4) uint8 RGBA texels (index y
    * 4 + x), interpolated as 8-bit LDR (not sRGB)."""
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    n = blocks.shape[0]
    w64 = blocks.view("<u8").reshape(-1, 2)
    lo, hi = w64[:, 0].copy(), w64[:, 1].copy()
    block_modes = modes(blocks)
    out = np.zeros((n, 16, 4), np.uint8)
    for mode in np.unique(block_modes):
        mode = int(mode)
        idx = np.flatnonzero(block_modes == mode)
        ml, mh = lo[idx], hi[idx]
        ofs = MODE_HUFF_CODES[mode][1]
        if mode == MODE_SOLID:
            for c in range(4):
                out[idx, :, c] = _rd(ml, mh, ofs + 8 * c, 8).astype(
                    np.uint8)[:, None]
            continue
        ofs += int(MODE_HAS_BC1_HINT0[mode]) + int(MODE_HAS_BC1_HINT1[mode])
        ofs += 8                                   # ETC1 flip, diff, tables
        ofs += (5 * int(MODE_HAS_ETC1_BIAS[mode])
                + 8 * int(MODE_HAS_ALPHA[mode]))
        pattern = np.zeros(len(idx), np.int64)
        if mode in MODES_WITH_PATTERN5:
            pattern = _rd(ml, mh, ofs, 5).astype(np.int64)
            ofs += 5
        elif mode == MODE_WITH_PATTERN4:
            pattern = _rd(ml, mh, ofs, 4).astype(np.int64)
            ofs += 4
        ccs = None
        if mode in (6, 11, 13):
            ccs = _rd(ml, mh, ofs, 2).astype(np.int64)
            ofs += 2
        subsets = int(MODE_SUBSETS[mode])
        planes = int(MODE_PLANES[mode])
        comps = int(MODE_COMPS[mode])
        n_values = comps * 2 * subsets
        ep_bits, trits, quints = BISE_RANGE_TABLE[int(
            MODE_ENDPOINT_RANGES[mode])]

        # endpoints: the trit / quint bundles first, then the raw bits
        bundles = []
        if trits or quints:
            size = 5 if trits else 3
            n_bundles = -(-n_values // size)
            for i in range(n_bundles):
                nb = 8 if trits else 7
                if i == n_bundles - 1:
                    rem = n_values - (n_bundles - 1) * size
                    nb = ({1: 2, 2: 4, 3: 5, 4: 7, 5: 8} if trits
                          else {1: 3, 2: 5, 3: 7})[rem]
                bundles.append(_rd(ml, mh, ofs, nb).astype(np.int64))
                ofs += nb
        eps = np.zeros((len(idx), n_values), np.int64)
        mul = 3 if trits else 5
        accum, left, bi = None, 0, 0
        for i in range(n_values):
            v = _rd(ml, mh, ofs, ep_bits).astype(np.int64)
            ofs += ep_bits
            if trits or quints:
                if left == 0:
                    accum = bundles[bi].copy()
                    bi += 1
                    left = 5 if trits else 3
                v |= (accum % mul) << ep_bits
                accum //= mul
                left -= 1
            eps[:, i] = v

        # weights: an anchor texel of each subset drops its top bit
        seeds = _pattern_seeds(mode)
        n_pat = len(seeds) if subsets > 1 else 1
        if (pattern >= n_pat).any():
            raise DecodeError("common pattern index past its list")
        pats = np.array([_pattern(seeds[p], subsets) if subsets > 1
                         else (0,) * 16 for p in range(n_pat)], np.int64)
        wb = int(MODE_WEIGHT_BITS[mode])
        weights = np.zeros((len(idx), 16 * planes), np.int64)
        for p in np.unique(pattern):
            sel = np.flatnonzero(pattern == p)
            anchors = {list(pats[p]).index(s) for s in range(subsets)}
            o2 = ofs
            for i in range(16 * planes):
                nb = wb - (1 if (i >> (planes - 1)) in anchors else 0)
                weights[sel, i] = _rd(ml[sel], mh[sel], o2, nb).astype(
                    np.int64)
                o2 += nb

        unq = color_unquant_table(int(MODE_ENDPOINT_RANGES[mode]))
        e8 = unq[eps].astype(np.int64).reshape(len(idx), subsets, comps, 2)
        lo8 = np.zeros((len(idx), subsets, 4), np.int64)
        hi8 = np.zeros((len(idx), subsets, 4), np.int64)
        cem = int(MODE_CEM[mode])
        if cem == 8:
            lo8[..., :3], hi8[..., :3] = e8[..., :3, 0], e8[..., :3, 1]
            lo8[..., 3] = hi8[..., 3] = 255
        elif cem == 12:
            lo8[...], hi8[...] = e8[..., :4, 0], e8[..., :4, 1]
        else:                                      # LA
            lo8[..., :3] = e8[..., 0:1, 0]
            hi8[..., :3] = e8[..., 0:1, 1]
            lo8[..., 3], hi8[..., 3] = e8[..., 1, 0], e8[..., 1, 1]
        texel_subset = pats[pattern]                          # (G, 16)
        rows = np.arange(len(idx))[:, None]
        t_lo, t_hi = lo8[rows, texel_subset], hi8[rows, texel_subset]
        w = weight_unquant_table(wb)[weights]
        if planes == 1:
            wt = np.repeat(w[:, :, None], 4, axis=2)
        elif comps == 2:                           # mode 17: L and A planes
            wt = np.stack([w[:, 0::2]] * 3 + [w[:, 1::2]], axis=-1)
        else:
            wt = np.repeat(w[:, 0::2, None], 4, axis=2)
            for c in range(4):
                on = ccs == c
                wt[on, :, c] = w[on, 1::2]
        l16, h16 = (t_lo << 8) | t_lo, (t_hi << 8) | t_hi
        px = ((l16 * (64 - wt) + h16 * wt + 32) >> 6) >> 8
        if cem == 8:
            px[..., 3] = 255
        out[idx] = px.astype(np.uint8)
    return out
