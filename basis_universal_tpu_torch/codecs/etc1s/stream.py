"""Copy of `basis_universal_tpu/codecs/etc1s/stream.py`.

ETC1S codebook + slice bitstream decode (host side).

The serial entropy layer: canonical Huffman + VLC + approximate-MTF selector
history. Output is dense numpy index arrays that feed the device transcode
kernels (symbols→pixels is device work; bits→symbols is host work).

Behavioral contract studied from the reference:
  - decode_palettes / decode_tables:
    transcoder/basisu_transcoder.cpp (basisu_lowlevel_etc1s_transcoder::
    decode_palettes :8257, decode_tables :8441)
  - slice symbol stream: transcode_slice (:8511) — per-2x2-group endpoint
    predictor symbols with repeat-RLE, delta endpoint indices, selector MTF
    history buffer with RLE runs
  - constants: transcoder/basisu_transcoder_internal.h:256-267
"""

import dataclasses

import numpy as np

from ...entropy.bitio import BitReader, BitWriter
from ...entropy.huffman import HuffmanDecoder, HuffmanEncoder, read_huffman_table

# Endpoint color5 delta coding ranges (basisu_transcoder_internal.h:251-254)
COLOR5_PAL0_PREV_HI, COLOR5_PAL0_DELTA_LO, COLOR5_PAL0_DELTA_HI = 9, -9, 31
COLOR5_PAL1_PREV_HI, COLOR5_PAL1_DELTA_LO, COLOR5_PAL1_DELTA_HI = 21, -21, 21
COLOR5_PAL2_PREV_HI, COLOR5_PAL2_DELTA_LO, COLOR5_PAL2_DELTA_HI = 31, -31, 9

ENDPOINT_PRED_TOTAL_SYMBOLS = (4 * 4 * 4 * 4) + 1
ENDPOINT_PRED_REPEAT_LAST_SYMBOL = ENDPOINT_PRED_TOTAL_SYMBOLS - 1
ENDPOINT_PRED_MIN_REPEAT_COUNT = 3
ENDPOINT_PRED_COUNT_VLC_BITS = 4

NUM_ENDPOINT_PREDS = 3
CR_ENDPOINT_PRED_INDEX = NUM_ENDPOINT_PREDS - 1
NO_ENDPOINT_PRED_INDEX = 3
MAX_SELECTOR_HISTORY_BUF_SIZE = 64
SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH = 3
SELECTOR_HISTORY_BUF_RLE_COUNT_BITS = 6
SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL = 1 << SELECTOR_HISTORY_BUF_RLE_COUNT_BITS


@dataclasses.dataclass
class Etc1sCodebooks:
    """Decoded ETC1S palettes: endpoint (color5+inten) and selector entries."""

    color5: np.ndarray     # (num_endpoints, 3) uint8, 5-bit components
    inten5: np.ndarray     # (num_endpoints,) uint8, 0-7
    selectors: np.ndarray  # (num_selectors, 16) uint8 values 0-3, idx = y*4+x


@dataclasses.dataclass
class Etc1sTables:
    endpoint_pred: HuffmanDecoder
    delta_endpoint: HuffmanDecoder
    selector: HuffmanDecoder
    selector_history_buf_rle: HuffmanDecoder
    selector_history_buf_size: int


class ApproxMoveToFront:
    """Selector history buffer (basisu_transcoder_internal.h:863-925)."""

    def __init__(self, n: int):
        self.values = [0] * n
        self.rover = n // 2

    def add(self, v: int):
        self.values[self.rover] = v
        self.rover += 1
        if self.rover == len(self.values):
            self.rover = len(self.values) // 2

    def use(self, index: int):
        if index:
            half = index // 2
            self.values[half], self.values[index] = self.values[index], self.values[half]

    def find(self, v: int) -> int:
        try:
            return self.values.index(v)
        except ValueError:
            return -1

    def __getitem__(self, i: int) -> int:
        return self.values[i]

    def __len__(self):
        return len(self.values)


def _color5_delta_model_index(prev: int) -> int:
    if prev <= COLOR5_PAL0_PREV_HI:
        return 0
    if prev <= COLOR5_PAL1_PREV_HI:
        return 1
    return 2


def decode_palettes(num_endpoints: int, endpoints_data: bytes,
                    num_selectors: int, selectors_data: bytes) -> Etc1sCodebooks:
    r = BitReader(endpoints_data)
    models = [read_huffman_table(r) for _ in range(3)]
    inten_model = read_huffman_table(r)
    grayscale = r.get_bits(1) != 0

    color5 = np.zeros((num_endpoints, 3), dtype=np.uint8)
    inten5 = np.zeros(num_endpoints, dtype=np.uint8)
    prev = [16, 16, 16]
    prev_inten = 0
    nchan = 1 if grayscale else 3
    for i in range(num_endpoints):
        inten_delta = inten_model.decode(r)
        prev_inten = (inten_delta + prev_inten) & 7
        inten5[i] = prev_inten
        for c in range(nchan):
            delta = models[_color5_delta_model_index(prev[c])].decode(r)
            v = (prev[c] + delta) & 31
            color5[i, c] = v
            prev[c] = v
        if grayscale:
            color5[i, 1] = color5[i, 0]
            color5[i, 2] = color5[i, 0]

    r = BitReader(selectors_data)
    if r.get_bits(1):
        raise ValueError("global selector codebooks unsupported")
    if r.get_bits(1):
        raise ValueError("hybrid selector codebooks unsupported")
    raw = r.get_bits(1) != 0
    selectors = np.zeros((num_selectors, 16), dtype=np.uint8)
    if raw:
        for i in range(num_selectors):
            for j in range(4):
                byte = r.get_bits(8)
                for k in range(4):
                    selectors[i, j * 4 + k] = (byte >> (k * 2)) & 3
    else:
        model = read_huffman_table(r)
        prev_bytes = [0, 0, 0, 0]
        for i in range(num_selectors):
            for j in range(4):
                if i == 0:
                    byte = r.get_bits(8)
                else:
                    byte = model.decode(r) ^ prev_bytes[j]
                prev_bytes[j] = byte
                for k in range(4):
                    selectors[i, j * 4 + k] = (byte >> (k * 2)) & 3
    return Etc1sCodebooks(color5=color5, inten5=inten5, selectors=selectors)


def decode_tables(table_data: bytes) -> Etc1sTables:
    r = BitReader(table_data)
    endpoint_pred = read_huffman_table(r)
    delta_endpoint = read_huffman_table(r)
    selector = read_huffman_table(r)
    selector_rle = read_huffman_table(r)
    for t in (endpoint_pred, delta_endpoint, selector, selector_rle):
        if not t.is_valid():
            raise ValueError("invalid slice huffman table")
    hist_size = r.get_bits(13)
    if not hist_size:
        raise ValueError("bad selector history buf size")
    return Etc1sTables(endpoint_pred, delta_endpoint, selector, selector_rle, hist_size)


def decode_slice(slice_data: bytes, num_blocks_x: int, num_blocks_y: int,
                 tables: Etc1sTables, num_endpoints: int, num_selectors: int,
                 is_video: bool = False, prev_frame_indices=None):
    """Decode one slice's symbol stream.

    Returns (endpoint_idx, selector_idx) int32 arrays of shape
    (num_blocks_y, num_blocks_x). For video P-frames pass the previous
    frame's (endpoint_idx, selector_idx) as prev_frame_indices.

    Dispatches to the native C++ runtime when available (bit-identical
    Python fallback below).
    """
    from ... import native

    if native.available():
        return _decode_slice_native(
            slice_data, num_blocks_x, num_blocks_y, tables,
            num_endpoints, num_selectors, is_video, prev_frame_indices)
    return _decode_slice_py(
        slice_data, num_blocks_x, num_blocks_y, tables,
        num_endpoints, num_selectors, is_video, prev_frame_indices)


def _decode_slice_native(slice_data, num_blocks_x, num_blocks_y, tables,
                         num_endpoints, num_selectors, is_video,
                         prev_frame_indices):
    import ctypes

    from ... import native

    lib = native.get_lib()
    data = np.frombuffer(bytes(slice_data) + b"\0" * 8, dtype=np.uint8)
    out_e = np.zeros((num_blocks_y, num_blocks_x), dtype=np.int32)
    out_s = np.zeros((num_blocks_y, num_blocks_x), dtype=np.int32)
    if is_video and prev_frame_indices is not None:
        pe = np.ascontiguousarray(prev_frame_indices[0], dtype=np.int32)
        ps = np.ascontiguousarray(prev_frame_indices[1], dtype=np.int32)
    else:
        pe = np.zeros((num_blocks_y, num_blocks_x), dtype=np.int32)
        ps = np.zeros((num_blocks_y, num_blocks_x), dtype=np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    def tbl(t):
        sym = np.ascontiguousarray(t.table_sym, dtype=np.int32)
        ln = np.ascontiguousarray(t.table_len, dtype=np.uint8)
        return sym, ln, max(1, t.max_len)

    tb = [tbl(t) for t in (tables.endpoint_pred, tables.delta_endpoint,
                           tables.selector, tables.selector_history_buf_rle)]
    args = [p(data, ctypes.c_uint8), ctypes.c_int64(len(slice_data)),
            num_blocks_x, num_blocks_y, num_endpoints, num_selectors,
            tables.selector_history_buf_size]
    for sym, ln, ml in tb:
        args += [p(sym, ctypes.c_int32), p(ln, ctypes.c_uint8), ml]
    args += [ctypes.c_int32(1 if is_video else 0),
             p(pe, ctypes.c_int32), p(ps, ctypes.c_int32),
             p(out_e, ctypes.c_int32), p(out_s, ctypes.c_int32)]
    rc = lib.etc1s_decode_slice(*args)
    if rc != 0:
        raise ValueError(f"invalid ETC1S slice stream (native rc={rc})")
    return out_e, out_s


def _decode_slice_py(slice_data: bytes, num_blocks_x: int, num_blocks_y: int,
                     tables: Etc1sTables, num_endpoints: int, num_selectors: int,
                     is_video: bool = False, prev_frame_indices=None):
    r = BitReader(slice_data)
    total_blocks = num_blocks_x * num_blocks_y
    hist = ApproxMoveToFront(tables.selector_history_buf_size)
    endpoint_idx = np.zeros((num_blocks_y, num_blocks_x), dtype=np.int32)
    selector_idx = np.zeros((num_blocks_y, num_blocks_x), dtype=np.int32)
    # per-column predictor state for the row pair (block_endpoint_preds)
    pred_bits_row = np.zeros(num_blocks_x, dtype=np.int32)
    up_endpoint = np.zeros((2, num_blocks_x), dtype=np.int32)

    SEL_HIST_FIRST = num_selectors
    SEL_RLE_SYM = tables.selector_history_buf_size + SEL_HIST_FIRST

    cur_selector_rle_count = 0
    cur_pred_bits = 0
    prev_endpoint_pred_sym = 0
    endpoint_pred_repeat_count = 0
    prev_endpoint_index = 0

    for by in range(num_blocks_y):
        cur_row = by & 1
        for bx in range(num_blocks_x):
            if (bx & 1) == 0:
                if (by & 1) == 0:
                    if endpoint_pred_repeat_count:
                        endpoint_pred_repeat_count -= 1
                        cur_pred_bits = prev_endpoint_pred_sym
                    else:
                        cur_pred_bits = tables.endpoint_pred.decode(r)
                        if cur_pred_bits == ENDPOINT_PRED_REPEAT_LAST_SYMBOL:
                            endpoint_pred_repeat_count = (
                                r.decode_vlc(ENDPOINT_PRED_COUNT_VLC_BITS)
                                + ENDPOINT_PRED_MIN_REPEAT_COUNT - 1)
                            cur_pred_bits = prev_endpoint_pred_sym
                        else:
                            prev_endpoint_pred_sym = cur_pred_bits
                    pred_bits_row[bx] = cur_pred_bits >> 4
                else:
                    cur_pred_bits = pred_bits_row[bx]

            pred = cur_pred_bits & 3
            cur_pred_bits >>= 2

            sel_from_cr = False
            if pred == 0:
                if bx == 0:
                    raise ValueError("invalid stream: left pred at x=0")
                e = prev_endpoint_index
            elif pred == 1:
                if by == 0:
                    raise ValueError("invalid stream: upper pred at y=0")
                e = int(up_endpoint[cur_row ^ 1, bx])
            elif pred == 2:
                if is_video:
                    pe, ps = prev_frame_indices
                    e = int(pe[by, bx])
                    s = int(ps[by, bx])
                    sel_from_cr = True
                else:
                    if bx == 0 or by == 0:
                        raise ValueError("invalid stream: upper-left pred")
                    e = int(up_endpoint[cur_row ^ 1, bx - 1])
            else:
                delta = tables.delta_endpoint.decode(r)
                e = delta + prev_endpoint_index
                if e >= num_endpoints:
                    e -= num_endpoints

            up_endpoint[cur_row, bx] = e
            prev_endpoint_index = e

            if not sel_from_cr:
                if cur_selector_rle_count > 0:
                    cur_selector_rle_count -= 1
                    sel_sym = num_selectors
                else:
                    sel_sym = tables.selector.decode(r)
                    if sel_sym == SEL_RLE_SYM:
                        run_sym = tables.selector_history_buf_rle.decode(r)
                        if run_sym == SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL - 1:
                            cur_selector_rle_count = (
                                r.decode_vlc(7) + SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH)
                        else:
                            cur_selector_rle_count = (
                                run_sym + SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH)
                        if cur_selector_rle_count > total_blocks:
                            raise ValueError("invalid selector RLE run")
                        sel_sym = num_selectors
                        cur_selector_rle_count -= 1
                if sel_sym >= num_selectors:
                    hidx = sel_sym - num_selectors
                    if hidx >= len(hist):
                        raise ValueError("invalid history index")
                    s = hist[hidx]
                    if hidx != 0:
                        hist.use(hidx)
                else:
                    s = sel_sym
                    if tables.selector_history_buf_size:
                        hist.add(s)

            if e >= num_endpoints or s >= num_selectors:
                raise ValueError("invalid index")
            endpoint_idx[by, bx] = e
            selector_idx[by, bx] = s

    return endpoint_idx, selector_idx
