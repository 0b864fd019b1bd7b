"""ETC1S decoding in plain Python and NumPy: the palettes, the Huffman
tables and each slice's symbol stream of a .basis file, the physical ETC1
blocks the slice CRC-16 covers, and the texels.

A frozen copy of the port's host decoders (`codecs/etc1s/stream.py`,
`entropy/huffman.py`, `ops/etc1.py`), which follow the reference
transcoder (`basisu_transcoder.cpp` decode_palettes, decode_tables,
transcode_slice), rewritten with a byte-refilled bit window so that a
2048x2048 slice decodes in about a second.
"""

import numpy as np

ETC1_INTEN_TABLES = np.array(
    [[-8, -2, 2, 8], [-17, -5, 5, 17], [-29, -9, 9, 29], [-42, -13, 13, 42],
     [-60, -18, 18, 60], [-80, -24, 24, 80], [-106, -33, 33, 106],
     [-183, -47, 47, 183]], dtype=np.int32)
# logical selector (palette index, 0 = lowest) -> the ETC1 2-bit value
SELECTOR_INDEX_TO_ETC1 = np.array([3, 2, 0, 1], dtype=np.uint32)

MAX_SYMS_LOG2 = 14
TOTAL_CODELENGTH_CODES = 21
SORTED_CODELENGTH_CODES = [17, 18, 19, 20, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12,
                           3, 13, 2, 14, 1, 15, 16]

ENDPOINT_PRED_REPEAT_LAST_SYMBOL = 4 * 4 * 4 * 4
ENDPOINT_PRED_MIN_REPEAT_COUNT = 3
ENDPOINT_PRED_COUNT_VLC_BITS = 4
SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH = 3
SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL = 64


class DecodeError(ValueError):
    """A stream that breaks the ETC1S bitstream's rules."""


class BitReader:
    """LSB-first bit reader over a window refilled 8 bytes at a time; past
    the end it reads zeros."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0            # next byte to load
        self.buf = 0
        self.nbits = 0

    def _refill(self):
        chunk = self.data[self.pos:self.pos + 8]
        self.pos += 8
        self.buf |= int.from_bytes(chunk.ljust(8, b"\0"), "little") \
            << self.nbits
        self.nbits += 64

    def bits(self, n: int) -> int:
        if self.nbits < n:
            self._refill()
        v = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.nbits -= n
        return v

    def vlc(self, chunk_bits: int) -> int:
        mask = (1 << chunk_bits) - 1
        v = ofs = 0
        while True:
            s = self.bits(chunk_bits + 1)
            v |= (s & mask) << ofs
            ofs += chunk_bits
            if not s & (1 << chunk_bits):
                return v
            if ofs >= 32:
                raise DecodeError("VLC too long")


class Huffman:
    """A canonical Huffman decoding table (huffman_decoding_table::init):
    codes in symbol order per length, read LSB first."""

    def __init__(self, lengths):
        lengths = [int(v) for v in lengths]
        self.valid = any(lengths)
        self.max_len = max(lengths, default=0)
        if self.max_len == 0:
            # the port's decoder reads symbol 0 from one bit of an empty table
            self.sym, self.len = [0], [1]
            return
        size = 1 << self.max_len
        self.sym = [-1] * size
        self.len = [0] * size
        counts = [0] * (self.max_len + 2)
        for l in lengths:
            counts[l] += 1
        next_code = [0] * (self.max_len + 2)
        total = 0
        for i in range(1, self.max_len + 1):
            total = (total + counts[i]) << 1
            next_code[i + 1] = total
        for s, l in enumerate(lengths):
            if not l:
                continue
            c = next_code[l]
            next_code[l] += 1
            rc = int(f"{c:0{l}b}"[::-1], 2)
            for idx in range(rc, size, 1 << l):
                self.sym[idx] = s
                self.len[idx] = l

    def decode(self, r: BitReader) -> int:
        if r.nbits < self.max_len:
            r._refill()
        idx = r.buf & ((1 << self.max_len) - 1)
        s = self.sym[idx]
        if s < 0:
            raise DecodeError("invalid Huffman code")
        n = self.len[idx]
        r.buf >>= n
        r.nbits -= n
        return s


def read_huffman_table(r: BitReader) -> Huffman:
    """bitwise_decoder::read_huffman_table."""
    total = r.bits(MAX_SYMS_LOG2)
    if total == 0:
        return Huffman([])
    num_clc = r.bits(5)
    if not 1 <= num_clc <= TOTAL_CODELENGTH_CODES:
        raise DecodeError("bad code-length code count")
    clc = [0] * TOTAL_CODELENGTH_CODES
    for i in range(num_clc):
        clc[SORTED_CODELENGTH_CODES[i]] = r.bits(3)
    clc = Huffman(clc)
    sizes = [0] * total
    cur = 0
    while cur < total:
        c = clc.decode(r)
        if c <= 16:
            sizes[cur] = c
            cur += 1
        elif c == 17:
            cur += r.bits(3) + 3
        elif c == 18:
            cur += r.bits(7) + 11
        else:
            if cur == 0 or sizes[cur - 1] == 0:
                raise DecodeError("repeat without a previous size")
            n = r.bits(2) + 3 if c == 19 else r.bits(7) + 7
            if cur + n > total:
                raise DecodeError("code size overrun")
            sizes[cur:cur + n] = [sizes[cur - 1]] * n
            cur += n
    if cur != total:
        raise DecodeError("code size overrun")
    return Huffman(sizes)


def _delta_model(prev: int) -> int:
    return 0 if prev <= 9 else (1 if prev <= 21 else 2)


def decode_palettes(num_endpoints: int, endpoints: bytes,
                    num_selectors: int, selectors: bytes):
    """(color5 (E, 3), inten (E,), patterns (S, 16) with index y * 4 + x),
    as uint8 arrays."""
    r = BitReader(endpoints)
    models = [read_huffman_table(r) for _ in range(3)]
    inten_model = read_huffman_table(r)
    grayscale = r.bits(1)
    color5 = np.zeros((num_endpoints, 3), np.uint8)
    inten = np.zeros(num_endpoints, np.uint8)
    prev = [16, 16, 16]
    prev_inten = 0
    for i in range(num_endpoints):
        prev_inten = (inten_model.decode(r) + prev_inten) & 7
        inten[i] = prev_inten
        for c in range(1 if grayscale else 3):
            prev[c] = (prev[c] + models[_delta_model(prev[c])].decode(r)) & 31
            color5[i, c] = prev[c]
        if grayscale:
            color5[i, 1:] = color5[i, 0]

    r = BitReader(selectors)
    if r.bits(1) or r.bits(1):
        raise DecodeError("global or hybrid selector codebook")
    raw = r.bits(1)
    words = np.zeros((num_selectors, 4), np.uint32)
    if raw:
        for i in range(num_selectors):
            for j in range(4):
                words[i, j] = r.bits(8)
    else:
        model = read_huffman_table(r)
        prev_bytes = [0, 0, 0, 0]
        for i in range(num_selectors):
            for j in range(4):
                byte = r.bits(8) if i == 0 else model.decode(r) ^ prev_bytes[j]
                prev_bytes[j] = byte
                words[i, j] = byte
    shifts = np.arange(4, dtype=np.uint32) * 2
    patterns = ((words[:, :, None] >> shifts) & 3).reshape(num_selectors, 16)
    return color5, inten, patterns.astype(np.uint8)


def decode_tables(data: bytes):
    """(endpoint_pred, delta_endpoint, selector, selector_rle) Huffman
    tables and the selector history buffer's size."""
    r = BitReader(data)
    tables = [read_huffman_table(r) for _ in range(4)]
    if not all(t.valid for t in tables):
        raise DecodeError("empty slice Huffman table")
    hist = r.bits(13)
    if not hist:
        raise DecodeError("selector history buffer of size 0")
    return tables, hist


def decode_slice(data: bytes, nbx: int, nby: int, tables, hist_size: int,
                 num_endpoints: int, num_selectors: int):
    """One slice's (endpoint index, selector index) per block, each
    (nby, nbx) int32 (transcode_slice, not a video frame)."""
    pred_t, delta_t, sel_t, rle_t = tables
    r = BitReader(data)
    e_out = np.zeros(nby * nbx, np.int32)
    s_out = np.zeros(nby * nbx, np.int32)
    hist = [0] * hist_size
    rover = hist_size // 2
    pred_row = [0] * nbx
    up = [[0] * nbx, [0] * nbx]
    rle_sym = hist_size + num_selectors
    sel_rle = cur_pred = prev_pred_sym = pred_repeat = prev_e = 0
    n_blocks = nbx * nby
    for by in range(nby):
        row = by & 1
        cur_up, prev_up = up[row], up[row ^ 1]
        base = by * nbx
        for bx in range(nbx):
            if not bx & 1:
                if not row:
                    if pred_repeat:
                        pred_repeat -= 1
                        cur_pred = prev_pred_sym
                    else:
                        cur_pred = pred_t.decode(r)
                        if cur_pred == ENDPOINT_PRED_REPEAT_LAST_SYMBOL:
                            pred_repeat = (r.vlc(ENDPOINT_PRED_COUNT_VLC_BITS)
                                           + ENDPOINT_PRED_MIN_REPEAT_COUNT
                                           - 1)
                            cur_pred = prev_pred_sym
                        else:
                            prev_pred_sym = cur_pred
                    pred_row[bx] = cur_pred >> 4
                else:
                    cur_pred = pred_row[bx]
            pred = cur_pred & 3
            cur_pred >>= 2
            if pred == 0:
                if bx == 0:
                    raise DecodeError("left prediction at x = 0")
                e = prev_e
            elif pred == 1:
                if by == 0:
                    raise DecodeError("upper prediction at y = 0")
                e = prev_up[bx]
            elif pred == 2:
                if bx == 0 or by == 0:
                    raise DecodeError("upper-left prediction at an edge")
                e = prev_up[bx - 1]
            else:
                e = delta_t.decode(r) + prev_e
                if e >= num_endpoints:
                    e -= num_endpoints
            cur_up[bx] = e
            prev_e = e

            if sel_rle > 0:
                sel_rle -= 1
                sym = num_selectors
            else:
                sym = sel_t.decode(r)
                if sym == rle_sym:
                    run = rle_t.decode(r)
                    if run == SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL - 1:
                        sel_rle = (r.vlc(7)
                                   + SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH)
                    else:
                        sel_rle = run + SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH
                    if sel_rle > n_blocks:
                        raise DecodeError("selector run past the slice")
                    sym = num_selectors
                    sel_rle -= 1
            if sym >= num_selectors:
                h = sym - num_selectors
                if h >= hist_size:
                    raise DecodeError("selector history index")
                s = hist[h]
                if h:
                    hist[h // 2], hist[h] = hist[h], hist[h // 2]
            else:
                s = sym
                hist[rover] = s
                rover += 1
                if rover == hist_size:
                    rover = hist_size // 2
            if e >= num_endpoints or s >= num_selectors:
                raise DecodeError("index past its codebook")
            e_out[base + bx] = e
            s_out[base + bx] = s
    return e_out.reshape(nby, nbx), s_out.reshape(nby, nbx)


def physical_blocks(e_idx, s_idx, color5, inten, patterns) -> np.ndarray:
    """The (BY, BX, 8) physical ETC1 blocks of an ETC1S slice: differential
    mode, delta 0, flip 0, one table for both subblocks; the slice CRC-16
    covers these bytes."""
    c5 = color5[e_idx].astype(np.uint8)
    it = inten[e_idx].astype(np.uint8)
    by, bx = e_idx.shape
    out = np.zeros((by, bx, 8), np.uint8)
    out[..., :3] = c5 << 3
    out[..., 3] = (it << 5) | (it << 2) | 2
    val = SELECTOR_INDEX_TO_ETC1[patterns[s_idx]]          # (BY, BX, 16)
    bit = (np.arange(16) % 4) * 4 + np.arange(16) // 4     # x * 4 + y
    lsb = ((val & 1) << bit).sum(-1)
    msb = ((val >> 1) << bit).sum(-1)
    out[..., 4] = (msb >> 8) & 0xFF
    out[..., 5] = msb & 0xFF
    out[..., 6] = (lsb >> 8) & 0xFF
    out[..., 7] = lsb & 0xFF
    return out


def texels(e_idx, s_idx, color5, inten, patterns) -> np.ndarray:
    """(BY, BX, 16, 3) uint8 decoded texels of a slice."""
    base = color5.astype(np.int32)
    base = (base << 3) | (base >> 2)
    pal = np.clip(base[:, None, :] + ETC1_INTEN_TABLES[inten][:, :, None],
                  0, 255)                                   # (E, 4, 3)
    sel = patterns[s_idx].astype(np.int64)                  # (BY, BX, 16)
    return pal[e_idx[..., None], sel].astype(np.uint8)
