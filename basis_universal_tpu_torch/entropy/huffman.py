"""Copy of `basis_universal_tpu/entropy/huffman.py`.

Canonical Huffman coding matching the .basis entropy contract.

Behavioral spec (studied from the reference, re-implemented from scratch):
  - Canonical code assignment in symbol-index order with per-length
    next_code counters; codes are bit-reversed for the LSB-first stream
    (huffman_decoding_table::init, transcoder/basisu_transcoder_internal.h:293+).
  - Code lengths limited to 16 bits (cHuffmanMaxSupportedCodeSize,
    transcoder/basisu.h:489).
  - Table serialization: 14-bit symbol count, 5-bit count of 3-bit
    code-length-code sizes in the fixed sorted order, then the code sizes
    RLE-compressed with zero-run (17/18) and repeat (19/20) codes
    (bitwise_decoder::read_huffman_table; constants basisu.h:494-509).

Length computation uses the package-merge algorithm (public-domain technique)
so any frequency distribution yields a complete, depth-limited prefix code.
"""

import numpy as np

from .bitio import BitReader, BitWriter

MAX_CODE_SIZE = 16
MAX_SYMS_LOG2 = 14
MAX_SYMS = 1 << MAX_SYMS_LOG2

SMALL_ZERO_RUN_MIN, SMALL_ZERO_RUN_MAX, SMALL_ZERO_RUN_EXTRA = 3, 10, 3
BIG_ZERO_RUN_MIN, BIG_ZERO_RUN_MAX, BIG_ZERO_RUN_EXTRA = 11, 138, 7
SMALL_REPEAT_MIN, SMALL_REPEAT_MAX, SMALL_REPEAT_EXTRA = 3, 6, 2
BIG_REPEAT_MIN, BIG_REPEAT_MAX, BIG_REPEAT_EXTRA = 7, 134, 7
TOTAL_CODELENGTH_CODES = 21
SMALL_ZERO_RUN_CODE, BIG_ZERO_RUN_CODE = 17, 18
SMALL_REPEAT_CODE, BIG_REPEAT_CODE = 19, 20

# Order in which code-length-code sizes are transmitted (basisu.h:508).
SORTED_CODELENGTH_CODES = [
    SMALL_ZERO_RUN_CODE, BIG_ZERO_RUN_CODE, SMALL_REPEAT_CODE, BIG_REPEAT_CODE,
    0, 8, 7, 9, 6, 0xA, 5, 0xB, 4, 0xC, 3, 0xD, 2, 0xE, 1, 0xF, 0x10,
]


def _moffat_depths(sorted_freqs):
    """In-place Huffman code-length computation (Moffat–Katajainen).

    Input: ascending-sorted positive frequencies (n >= 2).
    Output: code depths, in the same (ascending-frequency) order.
    """
    a = [int(x) for x in sorted_freqs]
    n = len(a)
    leaf = 0
    root = 0
    for nxt in range(n - 1):
        for _child in range(2):
            if leaf >= n or (root < nxt and a[root] < a[leaf]):
                val = a[root]
                a[root] = nxt
                root += 1
            else:
                val = a[leaf]
                leaf += 1
            if _child == 0:
                a[nxt] = val
            else:
                a[nxt] += val
    a[n - 2] = 0
    for nxt in range(n - 3, -1, -1):
        a[nxt] = a[a[nxt]] + 1
    avail, used, depth = 1, 0, 0
    nxt, root = n - 1, n - 2
    while avail > 0:
        while root >= 0 and a[root] == depth:
            used += 1
            root -= 1
        while avail > used:
            a[nxt] = depth
            nxt -= 1
            avail -= 1
        avail = 2 * used
        depth += 1
        used = 0
    return np.asarray(a, dtype=np.int64)


def compute_code_lengths(freqs, max_len=MAX_CODE_SIZE):
    """Depth-limited prefix code lengths (complete Kraft sum).

    Moffat in-place Huffman, then zlib-style overflow redistribution when the
    depth limit is exceeded. Returns uint8 per-symbol lengths (0 = unused).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    n = freqs.size
    lengths = np.zeros(n, dtype=np.uint8)
    used = np.flatnonzero(freqs > 0)
    if used.size == 0:
        return lengths
    if used.size == 1:
        lengths[used[0]] = 1
        return lengths
    if (1 << max_len) < used.size:
        raise ValueError("alphabet too large for depth limit")

    f = freqs[used]
    order = np.argsort(f, kind="stable")
    sf = f[order]
    depths = _moffat_depths(sf)  # ascending freq → descending depth
    shift = 0
    while depths[0] > max_len:
        # Depth limit exceeded: shrink the frequency dynamic range and
        # recompute. Moffat output is always a complete code, so no Kraft
        # fixup is needed; with all-equal freqs depth = ceil(log2 n) <= 14,
        # so this terminates. (Marginally suboptimal vs package-merge; the
        # table is retransmitted per file so the loss is bounded and tiny.)
        shift += 2
        depths = _moffat_depths(np.maximum(sf >> shift, 1))
    out = np.zeros(used.size, dtype=np.uint8)
    out[order] = depths.astype(np.uint8)
    lengths[used] = out
    kraft = np.sum(1.0 / (2.0 ** lengths[lengths > 0].astype(np.float64)))
    assert abs(kraft - 1.0) < 1e-9, kraft
    return lengths


def assign_canonical_codes(lengths):
    """Assign canonical codes exactly as the reference decoder expects.

    Returns (codes uint32 array, already bit-reversed for LSB-first writing).
    """
    lengths = np.asarray(lengths, dtype=np.uint8)
    max_l = int(lengths.max()) if lengths.size else 0
    counts = np.bincount(lengths, minlength=max_l + 2)
    next_code = np.zeros(max_l + 2, dtype=np.uint32)
    total = 0
    for i in range(1, max_l + 1):
        total = (total + int(counts[i])) << 1
        next_code[i + 1] = total
    codes = np.zeros(lengths.size, dtype=np.uint32)
    nc = next_code.copy()
    for sym in range(lengths.size):
        l = lengths[sym]
        if l == 0:
            continue
        c = int(nc[l])
        nc[l] += 1
        # bit-reverse to LSB-first
        rc = 0
        for _ in range(l):
            rc = (rc << 1) | (c & 1)
            c >>= 1
        codes[sym] = rc
    return codes


def _native_lib():
    try:
        from .. import native

        return native.get_lib()
    except Exception:
        return None


class HuffmanEncoder:
    """Encode-side canonical Huffman table + vectorized symbol emission.

    Uses the native C++ builder (native/slice_codec.cpp huffman_build) when
    available; the Python implementation below is the bit-identical fallback
    and the differential-test reference."""

    def __init__(self, freqs, max_len=MAX_CODE_SIZE):
        freqs = np.ascontiguousarray(freqs, dtype=np.int64)
        self.num_syms = freqs.size
        self._table_bits = None  # (bytes, nbits) when built natively
        lib = _native_lib()
        if lib is not None:
            import ctypes

            lengths = np.zeros(self.num_syms, dtype=np.uint8)
            codes = np.zeros(self.num_syms, dtype=np.uint32)
            cap = 4 * self.num_syms + 64
            table = np.zeros(cap, dtype=np.uint8)
            nbits = lib.huffman_build(
                freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.num_syms, max_len,
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                cap)
            if nbits >= 0:
                self.lengths = lengths
                self.codes = codes
                self._table_bits = (table[: (nbits + 7) // 8].copy(), int(nbits))
                return
        self.lengths = compute_code_lengths(freqs, max_len)
        self.codes = assign_canonical_codes(self.lengths)

    def put_syms(self, writer: BitWriter, syms):
        syms = np.asarray(syms, dtype=np.int64).ravel()
        if syms.size == 0:
            return
        writer.put_bits_array(self.codes[syms], self.lengths[syms])

    def cost_bits(self, syms) -> int:
        syms = np.asarray(syms, dtype=np.int64).ravel()
        return int(self.lengths[syms].astype(np.int64).sum())

    def write_table(self, writer: BitWriter):
        """Serialize in the format read by read_huffman_table."""
        if self._table_bits is not None:
            data, nbits = self._table_bits
            full, rem = divmod(nbits, 8)
            if full:
                writer.put_bits_array(data[:full].astype(np.uint64),
                                      np.full(full, 8, dtype=np.uint8))
            if rem:
                writer.put_bits(int(data[full]) & ((1 << rem) - 1), rem)
            return
        lengths = self.lengths
        total_used = int(np.flatnonzero(lengths).max() + 1) if lengths.any() else 0
        writer.put_bits(total_used, MAX_SYMS_LOG2)
        if total_used == 0:
            return
        # RLE-compress the code sizes
        rle = []  # (code, extra_value, extra_bits)
        i = 0
        sizes = lengths[:total_used]
        while i < total_used:
            v = int(sizes[i])
            run = 1
            while i + run < total_used and int(sizes[i + run]) == v:
                run += 1
            if v == 0:
                r = run
                while r >= SMALL_ZERO_RUN_MIN:
                    if r >= BIG_ZERO_RUN_MIN:
                        take = min(r, BIG_ZERO_RUN_MAX)
                        rle.append((BIG_ZERO_RUN_CODE, take - BIG_ZERO_RUN_MIN, BIG_ZERO_RUN_EXTRA))
                    else:
                        take = min(r, SMALL_ZERO_RUN_MAX)
                        rle.append((SMALL_ZERO_RUN_CODE, take - SMALL_ZERO_RUN_MIN, SMALL_ZERO_RUN_EXTRA))
                    r -= take
                rle.extend((0, 0, 0) for _ in range(r))
            else:
                rle.append((v, 0, 0))
                r = run - 1
                while r >= SMALL_REPEAT_MIN:
                    if r >= BIG_REPEAT_MIN:
                        take = min(r, BIG_REPEAT_MAX)
                        rle.append((BIG_REPEAT_CODE, take - BIG_REPEAT_MIN, BIG_REPEAT_EXTRA))
                    else:
                        take = min(r, SMALL_REPEAT_MAX)
                        rle.append((SMALL_REPEAT_CODE, take - SMALL_REPEAT_MIN, SMALL_REPEAT_EXTRA))
                    r -= take
                rle.extend((v, 0, 0) for _ in range(r))
            i += run
        # Huffman-code the RLE codes (depth limit 7: sizes sent in 3 bits)
        clc_freq = np.zeros(TOTAL_CODELENGTH_CODES, dtype=np.int64)
        for c, _, _ in rle:
            clc_freq[c] += 1
        clc = HuffmanEncoder(clc_freq, max_len=7)
        # number of transmitted code-length-code sizes (trim trailing zeros
        # in the fixed sorted order, min 1)
        num_clc = TOTAL_CODELENGTH_CODES
        while num_clc > 1 and clc.lengths[SORTED_CODELENGTH_CODES[num_clc - 1]] == 0:
            num_clc -= 1
        writer.put_bits(num_clc, 5)
        for k in range(num_clc):
            writer.put_bits(int(clc.lengths[SORTED_CODELENGTH_CODES[k]]), 3)
        for c, extra, extra_bits in rle:
            writer.put_bits(int(clc.codes[c]), int(clc.lengths[c]))
            if extra_bits:
                writer.put_bits(extra, extra_bits)


class HuffmanDecoder:
    """Decode-side table: flat 2^maxlen lookup built with numpy."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, dtype=np.uint8)
        self.lengths = lengths
        self.num_syms = lengths.size
        codes = assign_canonical_codes(lengths)
        max_l = int(lengths.max()) if lengths.any() else 0
        self.max_len = max_l
        if max_l == 0:
            self.table_sym = np.zeros(1, dtype=np.int32)
            self.table_len = np.ones(1, dtype=np.uint8)
            return
        size = 1 << max_l
        self.table_sym = np.full(size, -1, dtype=np.int32)
        self.table_len = np.zeros(size, dtype=np.uint8)
        for sym in range(lengths.size):
            l = int(lengths[sym])
            if l == 0:
                continue
            rc = int(codes[sym])
            step = 1 << l
            idx = np.arange(rc, size, step)
            self.table_sym[idx] = sym
            self.table_len[idx] = l

    def is_valid(self):
        return bool(self.lengths.any())

    def decode(self, reader: BitReader) -> int:
        peek = reader.get_bits(0)  # no-op keeps interface uniform
        p = reader._pos
        byte0 = p >> 3
        window = int.from_bytes(
            reader._data[byte0:byte0 + 4].tobytes().ljust(4, b"\0"), "little")
        bits = (window >> (p & 7)) & ((1 << self.max_len) - 1)
        sym = int(self.table_sym[bits])
        if sym < 0:
            raise ValueError("invalid Huffman code")
        reader._pos = p + int(self.table_len[bits])
        return sym


def read_huffman_table(reader: BitReader) -> HuffmanDecoder:
    """Parse a serialized Huffman table (read_huffman_table semantics)."""
    total_used = reader.get_bits(MAX_SYMS_LOG2)
    if total_used == 0:
        return HuffmanDecoder(np.zeros(0, dtype=np.uint8))
    if total_used > MAX_SYMS:
        raise ValueError("too many symbols")
    num_clc = reader.get_bits(5)
    if not (1 <= num_clc <= TOTAL_CODELENGTH_CODES):
        raise ValueError("bad codelength code count")
    clc_sizes = np.zeros(TOTAL_CODELENGTH_CODES, dtype=np.uint8)
    for i in range(num_clc):
        clc_sizes[SORTED_CODELENGTH_CODES[i]] = reader.get_bits(3)
    clc = HuffmanDecoder(clc_sizes)
    sizes = np.zeros(total_used, dtype=np.uint8)
    cur = 0
    while cur < total_used:
        c = clc.decode(reader)
        if c <= 16:
            sizes[cur] = c
            cur += 1
        elif c == SMALL_ZERO_RUN_CODE:
            cur += reader.get_bits(SMALL_ZERO_RUN_EXTRA) + SMALL_ZERO_RUN_MIN
        elif c == BIG_ZERO_RUN_CODE:
            cur += reader.get_bits(BIG_ZERO_RUN_EXTRA) + BIG_ZERO_RUN_MIN
        else:
            if cur == 0:
                raise ValueError("repeat with no previous size")
            if c == SMALL_REPEAT_CODE:
                l = reader.get_bits(SMALL_REPEAT_EXTRA) + SMALL_REPEAT_MIN
            else:
                l = reader.get_bits(BIG_REPEAT_EXTRA) + BIG_REPEAT_MIN
            prev = sizes[cur - 1]
            if prev == 0:
                raise ValueError("repeat of zero size")
            sizes[cur:cur + l] = prev
            cur += l
    if cur != total_used:
        raise ValueError("code size overrun")
    return HuffmanDecoder(sizes)
