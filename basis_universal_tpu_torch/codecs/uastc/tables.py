"""Copy of `basis_universal_tpu/codecs/uastc/tables.py`.

UASTC LDR 4x4 mode system tables and ASTC math helpers.

The 19-mode system is fully described by parallel per-mode tables
(transcoder/basisu_transcoder_uastc.h:20-75 and the values in
basisu_transcoder.cpp:14380-14427); the partition-seed interop tables list
which ASTC partition seeds coincide with BC7 partition patterns. The ASTC
partition-select hash and BISE/unquantization math follow the public Khronos
ASTC specification (§18.12/18.13/18.19).
"""

import functools

import numpy as np

TOTAL_UASTC_MODES = 19
MODE_SOLID = 8

# per-mode tables (basisu_transcoder.cpp:14415-14427)
MODE_WEIGHT_BITS = np.array([4, 2, 3, 2, 2, 3, 2, 2, 0, 2, 4, 2, 3, 1, 2, 4, 2, 2, 5])
MODE_WEIGHT_RANGES = np.array([8, 2, 5, 2, 2, 5, 2, 2, 0, 2, 8, 2, 5, 0, 2, 8, 2, 2, 11])
MODE_ENDPOINT_RANGES = np.array([19, 20, 8, 7, 12, 20, 18, 12, 0, 8, 13, 13, 19, 20, 20, 20, 20, 20, 11])
MODE_SUBSETS = np.array([1, 1, 2, 3, 2, 1, 1, 2, 0, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1])
MODE_PLANES = np.array([1, 1, 1, 1, 1, 1, 2, 1, 0, 1, 1, 2, 1, 2, 1, 1, 1, 2, 1])
MODE_COMPS = np.array([3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 2, 2, 2, 3])
MODE_HAS_ETC1_BIAS = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1])
MODE_HAS_BC1_HINT0 = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1])
MODE_HAS_BC1_HINT1 = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1])
MODE_CEM = np.array([8, 8, 8, 8, 8, 8, 8, 8, 0, 12, 12, 12, 12, 12, 12, 4, 4, 4, 8])
MODE_HAS_ALPHA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0])
MODE_IS_LA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0])
MODE_TOTAL_HINT_BITS = np.array([15, 15, 15, 15, 15, 15, 15, 15, 0, 23, 17, 17, 17, 23, 23, 23, 23, 23, 15])

# (code, codesize) per mode; read LSB-first (basisu_transcoder.cpp:14380)
MODE_HUFF_CODES = [
    (0x1, 4), (0x35, 6), (0x1D, 5), (0x3, 5),
    (0x13, 5), (0xB, 5), (0x1B, 5), (0x7, 5),
    (0x17, 5), (0xF, 5), (0x2, 3), (0x0, 2),
    (0x6, 3), (0x1F, 5), (0xD, 5), (0x5, 7),
    (0x15, 6), (0x25, 6), (0x9, 4), (0x45, 7),
]


def _build_mode_lut():
    lut = np.full(128, 255, dtype=np.uint8)
    for mode, (code, size) in enumerate(MODE_HUFF_CODES):
        for i in range(1 << (7 - size)):
            lut[code | (i << size)] = mode
    return lut


MODE_LUT = _build_mode_lut()  # byte0 & 127 → mode (19 = reserved)

# 2-subset modes read a 5-bit common pattern; mode 3 reads 4 bits
MODES_WITH_PATTERN5 = (2, 4, 7, 9, 16)
MODE_WITH_PATTERN4 = 3

# interop tables: which ASTC partition seeds coincide with BC7 patterns
# (basisu_transcoder.cpp; (bc7, astc_seed, invert) / (bc7, astc_seed, perm))
ASTC_BC7_COMMON_PARTITIONS2 = [
    (0, 28, False), (1, 20, False), (2, 16, True), (3, 29, False),
    (4, 91, True), (5, 9, False), (6, 107, True), (7, 72, True),
    (8, 149, False), (9, 204, True), (10, 50, False), (11, 114, True),
    (12, 496, True), (13, 17, True), (14, 78, False), (15, 39, True),
    (17, 252, True), (18, 828, True), (19, 43, False), (20, 156, False),
    (21, 116, False), (22, 210, True), (23, 476, True), (24, 273, False),
    (25, 684, True), (26, 359, False), (29, 246, True), (32, 195, True),
    (33, 694, True), (52, 524, True),
]
BC7_3_ASTC2_COMMON_PARTITIONS = [
    (10, 36, 4), (11, 48, 4), (0, 61, 3), (2, 137, 4),
    (8, 161, 5), (13, 183, 4), (1, 226, 2), (33, 281, 2),
    (40, 302, 3), (20, 307, 4), (21, 479, 0), (58, 495, 3),
    (3, 593, 0), (32, 594, 2), (59, 605, 1), (34, 799, 3),
    (20, 812, 1), (14, 988, 4), (31, 993, 3),
]
ASTC_BC7_COMMON_PARTITIONS3 = [
    (4, 260, 0), (8, 74, 5), (9, 32, 5), (10, 156, 2),
    (11, 183, 2), (12, 15, 0), (13, 745, 4), (20, 0, 1),
    (35, 335, 1), (36, 902, 5), (57, 254, 0),
]

# ASTC BISE ranges (spec table 81): (bits, trits, quints) per range index
BISE_RANGE_TABLE = [
    (1, 0, 0), (0, 1, 0), (2, 0, 0), (0, 0, 1), (1, 1, 0), (3, 0, 0),
    (1, 0, 1), (2, 1, 0), (4, 0, 0), (2, 0, 1), (3, 1, 0), (5, 0, 0),
    (3, 0, 1), (4, 1, 0), (6, 0, 0), (4, 0, 1), (5, 1, 0), (7, 0, 0),
    (5, 0, 1), (6, 1, 0), (8, 0, 0),
]


def bise_levels(range_index: int) -> int:
    b, t, q = BISE_RANGE_TABLE[range_index]
    return (1 << b) * (3 ** t) * (5 ** q)


def astc_hash52(p: int) -> int:
    p = p & 0xFFFFFFFF
    p ^= p >> 15; p &= 0xFFFFFFFF
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


def astc_select_partition(seed: int, x: int, y: int, z: int,
                          partition_count: int, small_block: bool) -> int:
    """ASTC spec partition selection (§23 select_partition)."""
    if small_block:
        x <<= 1; y <<= 1; z <<= 1
    seed += (partition_count - 1) * 1024
    rnum = astc_hash52(seed)
    s = [(rnum >> (4 * i)) & 0xF for i in range(8)]
    s += [(rnum >> 18) & 0xF, (rnum >> 22) & 0xF, (rnum >> 26) & 0xF, (rnum >> 30) & 0xF]
    s = [v * v for v in s]
    if seed & 1:
        sh1 = 4 if (seed & 2) else 5
        sh2 = 6 if partition_count == 3 else 5
    else:
        sh1 = 6 if partition_count == 3 else 5
        sh2 = 4 if (seed & 2) else 5
    sh3 = sh1 if (seed & 0x10) else sh2
    s[0] >>= sh1; s[1] >>= sh2; s[2] >>= sh1; s[3] >>= sh2
    s[4] >>= sh1; s[5] >>= sh2; s[6] >>= sh1; s[7] >>= sh2
    s[8] >>= sh3; s[9] >>= sh3; s[10] >>= sh3; s[11] >>= sh3
    a = (s[0] * x + s[1] * y + s[10] * z + (rnum >> 14)) & 0x3F
    b = (s[2] * x + s[3] * y + s[11] * z + (rnum >> 10)) & 0x3F
    c = (s[4] * x + s[5] * y + s[8] * z + (rnum >> 6)) & 0x3F
    d = (s[6] * x + s[7] * y + s[9] * z + (rnum >> 2)) & 0x3F
    if partition_count <= 3:
        d = 0
    if partition_count <= 2:
        c = 0
    if a >= b and a >= c and a >= d:
        return 0
    if b >= c and b >= d:
        return 1
    if c >= d:
        return 2
    return 3


@functools.lru_cache(maxsize=None)
def partition_pattern(seed: int, subsets: int) -> tuple:
    """16-texel partition pattern for a 4x4 block (small-block rules)."""
    return tuple(
        astc_select_partition(seed, i & 3, i >> 2, 0, subsets, True)
        for i in range(16))


@functools.lru_cache(maxsize=None)
def pattern_anchors(seed: int, subsets: int) -> tuple:
    """First texel index of each subset (the ASTC weight anchor)."""
    pat = partition_pattern(seed, subsets)
    return tuple(pat.index(s) for s in range(subsets))


def mode_pattern_seed(mode: int, common_pattern: int) -> int:
    if mode in (2, 4, 9, 16):
        return ASTC_BC7_COMMON_PARTITIONS2[common_pattern][1]
    if mode == 3:
        return ASTC_BC7_COMMON_PARTITIONS3[common_pattern][1]
    if mode == 7:
        return BC7_3_ASTC2_COMMON_PARTITIONS[common_pattern][1]
    return 0


# --- unquantization (ASTC spec §18.13 endpoints, §18.12 weights) ------------

@functools.lru_cache(maxsize=None)
def color_unquant_table(range_index: int) -> np.ndarray:
    """Map quantized endpoint value (trit/quint-combined index layout used by
    UASTC: value = bits | (tq << ep_bits)) → unquantized 0..255."""
    bits, trits, quints = BISE_RANGE_TABLE[range_index]
    n_tq = 3 if trits else (5 if quints else 1)
    out = np.zeros((n_tq << bits), dtype=np.uint8)
    for tq in range(n_tq):
        for m in range(1 << bits):
            out[(tq << bits) | m] = _color_unquant(m, tq, bits, trits, quints)
    return out


def _replicate(v: int, src_bits: int, dst_bits: int = 8) -> int:
    if src_bits == 0:
        return 0
    out = 0
    shift = dst_bits - src_bits
    while shift > -src_bits:
        out |= (v << shift) if shift >= 0 else (v >> -shift)
        shift -= src_bits
    return out & ((1 << dst_bits) - 1)


def _color_unquant(m: int, d: int, bits: int, trits: int, quints: int) -> int:
    if not trits and not quints:
        return _replicate(m, bits)
    a = 0x1FF if (m & 1) else 0
    if trits:
        c_tab = {1: 204, 2: 93, 3: 44, 4: 22, 5: 11, 6: 5}
        c = c_tab[bits]
        b = _trit_quint_b(m, bits, True)
    else:
        c_tab = {1: 113, 2: 54, 3: 26, 4: 13, 5: 6}
        c = c_tab[bits]
        b = _trit_quint_b(m, bits, False)
    t = d * c + b
    t ^= a
    return (a & 0x80) | (t >> 2)


def _trit_quint_b(m: int, bits: int, trit: bool) -> int:
    """The 9-bit B pattern from spec tables (18.13)."""
    x = [0] * 8
    for i in range(bits):
        x[i] = (m >> i) & 1
    b_, c_, d_, e_, f_ = x[1], x[2], x[3], x[4], x[5]
    if trit:
        if bits == 1:
            return 0
        if bits == 2:
            return (b_ << 8) | (b_ << 4) | (b_ << 2) | (b_ << 1)
        if bits == 3:
            return (c_ << 8) | (b_ << 7) | (c_ << 3) | (b_ << 2) | (c_ << 1) | b_
        if bits == 4:
            return (d_ << 8) | (c_ << 7) | (b_ << 6) | (d_ << 2) | (c_ << 1) | b_
        if bits == 5:
            return (e_ << 8) | (d_ << 7) | (c_ << 6) | (b_ << 5) | (e_ << 1) | d_
        if bits == 6:
            return (f_ << 8) | (e_ << 7) | (d_ << 6) | (c_ << 5) | (b_ << 4) | f_
    else:
        if bits == 1:
            return 0
        if bits == 2:
            return (b_ << 8) | (b_ << 3) | (b_ << 2)
        if bits == 3:
            return (c_ << 8) | (b_ << 7) | (c_ << 2) | (b_ << 1) | c_
        if bits == 4:
            return (d_ << 8) | (c_ << 7) | (b_ << 6) | (d_ << 1) | c_
        if bits == 5:
            return (e_ << 8) | (d_ << 7) | (c_ << 6) | (b_ << 5) | e_
    raise ValueError((bits, trit))


@functools.lru_cache(maxsize=None)
def weight_unquant_table(weight_bits: int) -> np.ndarray:
    """Plain-bits UASTC weight value → 0..64 interpolation factor
    (ASTC spec §18.12 bit-replication to 6 bits, then >32 gets +1)."""
    n = 1 << weight_bits
    out = np.zeros(n, dtype=np.int32)
    for v in range(n):
        if weight_bits == 1:
            w = v * 63
        else:
            w = _replicate(v, weight_bits, 6)
        if w > 32:
            w += 1
        out[v] = w
    return out


def astc_interpolate(lo, hi, w, srgb=False):
    """ASTC LDR endpoint interpolation (basisu_transcoder_uastc.h:79-97)."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    w = np.asarray(w, dtype=np.int64)
    if srgb:
        l16 = (lo << 8) | 0x80
        h16 = (hi << 8) | 0x80
    else:
        l16 = (lo << 8) | lo
        h16 = (hi << 8) | hi
    k = (l16 * (64 - w) + h16 * w + 32) >> 6
    return (k >> 8).astype(np.uint8)
