"""Copy of `basis_universal_tpu/codecs/uastc/astc_pack.py`.

Physical ASTC 4x4 block packing (astc_helpers::pack_astc_block analog,
transcoder/basisu_astc_helpers.h:263).

Used for the UASTC → ASTC transcode target (lossless repack: the UASTC
quantized endpoints/weights ARE ASTC ISE values) and the ETC1S → ASTC path.
Bit layout per the Khronos ASTC specification: 11-bit block mode, partition
header, CEM, endpoint ISE (trit/quint interleaved), weights packed in
REVERSED bit order from bit 127 downward, CCS just below the weights for
dual-plane blocks.
"""

import functools

import numpy as np

from . import tables as T

# ASTC block mode field per UASTC mode (basisu_transcoder.cpp:15026)
UASTC_MODE_ASTC_BLOCK_MODE = [
    0x242, 0x42, 0x53, 0x42, 0x42, 0x53, 0x442, 0x42, 0,
    0x42, 0x242, 0x442, 0x53, 0x441, 0x42, 0x242, 0x42, 0x442, 0x253,
]


def _decode_trit_block(tt: int):
    """ASTC spec trit-block decode: 8-bit T → 5 trits."""
    def bits(v, lo, hi):
        return (v >> lo) & ((1 << (hi - lo + 1)) - 1)

    if bits(tt, 2, 4) == 0b111:
        c = (bits(tt, 5, 7) << 2) | bits(tt, 0, 1)
        t4 = t3 = 2
    else:
        c = bits(tt, 0, 4)
        if bits(tt, 5, 6) == 0b11:
            t4 = 2
            t3 = bits(tt, 7, 7)
        else:
            t4 = bits(tt, 7, 7)
            t3 = bits(tt, 5, 6)
    if (c & 3) == 0b11:
        t2 = 2
        t1 = (c >> 4) & 1
        c3 = (c >> 3) & 1
        c2 = (c >> 2) & 1
        t0 = (c3 << 1) | (c2 & (1 - c3))
    elif ((c >> 2) & 3) == 0b11:
        t2 = 2
        t1 = 2
        t0 = c & 3
    else:
        t2 = (c >> 4) & 1
        t1 = (c >> 2) & 3
        c1 = (c >> 1) & 1
        c0 = c & 1
        t0 = (c1 << 1) | (c0 & (1 - c1))
    return (t0, t1, t2, t3, t4)


def _decode_quint_block(qq: int):
    def bits(v, lo, hi):
        return (v >> lo) & ((1 << (hi - lo + 1)) - 1)

    if bits(qq, 1, 2) == 0b11 and bits(qq, 5, 6) == 0:
        q0_ = bits(qq, 0, 0)
        q2 = (q0_ << 2) | ((bits(qq, 4, 4) & (1 - q0_)) << 1) | (bits(qq, 3, 3) & (1 - q0_))
        q1 = 4
        q0 = 4
    else:
        if bits(qq, 1, 2) == 0b11:
            q2 = 4
            c = (bits(qq, 3, 4) << 3) | ((~bits(qq, 5, 6) & 3) << 1) | bits(qq, 0, 0)
        else:
            q2 = bits(qq, 5, 6)
            c = bits(qq, 0, 4)
        if (c & 7) == 0b101:
            q1 = 4
            q0 = (c >> 3) & 3
        else:
            q1 = (c >> 3) & 3
            q0 = c & 7
    return (q0, q1, q2)


@functools.lru_cache(maxsize=None)
def _trit_encode_lut():
    lut = {}
    for tt in range(256):
        key = _decode_trit_block(tt)
        lut.setdefault(key, tt)
    return lut


@functools.lru_cache(maxsize=None)
def _quint_encode_lut():
    lut = {}
    for qq in range(128):
        key = _decode_quint_block(qq)
        lut.setdefault(key, qq)
    return lut


class _BlockWriter:
    def __init__(self):
        self.bits = 0
        self.pos = 0

    def put(self, v: int, n: int):
        self.bits |= (v & ((1 << n) - 1)) << self.pos
        self.pos += n

    def put_at(self, v: int, n: int, pos: int):
        self.bits |= (v & ((1 << n) - 1)) << pos

    def to_bytes(self):
        return self.bits.to_bytes(16, "little")


def _ise_encode(w: _BlockWriter, values, range_index: int):
    """ASTC ISE sequence encoding (spec §18.10: trit/quint blocks with
    interleaved bit layout)."""
    bits, trits, quints = T.BISE_RANGE_TABLE[range_index]
    vals = list(values)
    n = len(vals)
    if trits:
        # interleaved trit-bit chunks per value position within a block of 5
        tbits = [(0, 2), (2, 2), (4, 1), (5, 2), (7, 1)]
        for i0 in range(0, n, 5):
            group = vals[i0:i0 + 5]
            ts = tuple((v >> bits) for v in group)
            tt = _find_tq(ts, 5, len(group), tuple(tbits), _decode_trit_block, 256)
            for k, v in enumerate(group):
                w.put(v & ((1 << bits) - 1), bits)
                lo, cnt = tbits[k]
                w.put((tt >> lo) & ((1 << cnt) - 1), cnt)
    elif quints:
        qbits = [(0, 3), (3, 2), (5, 2)]
        for i0 in range(0, n, 3):
            group = vals[i0:i0 + 3]
            qs = tuple((v >> bits) for v in group)
            qq = _find_tq(qs, 3, len(group), tuple(qbits), _decode_quint_block, 128)
            for k, v in enumerate(group):
                w.put(v & ((1 << bits) - 1), bits)
                lo, cnt = qbits[k]
                w.put((qq >> lo) & ((1 << cnt) - 1), cnt)
    else:
        for v in vals:
            w.put(v, bits)


@functools.lru_cache(maxsize=None)
def _find_tq(present, bundle, k, chunks, decode_fn, space):
    """Find a T/Q byte that decodes to `present` in its first k slots AND
    has zeros in all bit positions a truncated group never writes (the spec's
    requirement so decoders reconstruct the missing bits as 0)."""
    chunks = tuple(chunks) if not isinstance(chunks, tuple) else chunks
    written_mask = 0
    for i in range(k):
        lo, cnt = chunks[i]
        written_mask |= ((1 << cnt) - 1) << lo
    # Multiple codes can decode to the same trits/quints; for byte-exact
    # interop with the reference transcoder's encode tables
    # (basisu_transcoder.cpp:5421/:14943) pick the SMALLEST valid code,
    # except the all-fours quint group which that table encodes as 31.
    if decode_fn is _decode_quint_block and k == bundle and tuple(present) == (4, 4, 4):
        return 31
    for tq in range(space):
        if k < bundle and (tq & ~written_mask):
            continue
        if decode_fn(tq)[:k] == tuple(present):
            return tq
    raise ValueError((present, k))


def _reverse_bits64(v: int, n: int) -> int:
    out = 0
    for _ in range(n):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


def pack_astc_block(mode: int, common_pattern: int, ccs: int,
                    endpoints, weights) -> bytes:
    """Pack one UASTC-style logical block into a physical ASTC block.

    endpoints: quantized ISE values in the mode's endpoint range;
    weights: plain values (interleaved planes for dual-plane), each
    weight_bits wide. Returns 16 bytes.
    """
    w = _BlockWriter()
    block_mode = UASTC_MODE_ASTC_BLOCK_MODE[mode]
    subsets = int(T.MODE_SUBSETS[mode])
    planes = int(T.MODE_PLANES[mode])
    comps = int(T.MODE_COMPS[mode])
    cem = int(T.MODE_CEM[mode])
    wb = int(T.MODE_WEIGHT_BITS[mode])
    ep_range = int(T.MODE_ENDPOINT_RANGES[mode])

    w.put(block_mode, 11)
    w.put(subsets - 1, 2)
    if subsets > 1:
        seed = T.mode_pattern_seed(mode, common_pattern)
        w.put(seed, 10)
        w.put(cem << 2, 6)   # all subsets share one CEM (low 2 bits = 00)
    else:
        w.put(cem, 4)

    _ise_encode(w, endpoints[:comps * 2 * subsets], ep_range)

    total_weights = 16 * planes
    # weights: plain-bit ISE, written reversed from bit 127 downward
    wstream = 0
    wlen = 0
    for v in weights[:total_weights]:
        wstream |= (int(v) & ((1 << wb) - 1)) << wlen
        wlen += wb
    w.put_at(_reverse_bits64(wstream, wlen), wlen, 128 - wlen)
    if planes == 2:
        # CCS sits immediately below the weight data
        w.put_at(ccs, 2, 128 - wlen - 2)
    return w.to_bytes()


def pack_void_extent(rgba) -> bytes:
    """LDR void-extent (solid color) block."""
    w = _BlockWriter()
    w.put(0b111111100, 9)
    w.put(0, 1)             # D = 0: LDR
    w.put(0b11, 2)          # reserved (all-ones)
    for _ in range(4):
        w.put((1 << 13) - 1, 13)  # no extent
    for c in rgba:
        w.put((int(c) << 8) | int(c), 16)
    return w.to_bytes()


def uastc_blocks_to_astc(blocks) -> np.ndarray:
    """UASTC blocks (N,16) → physical ASTC 4x4 blocks (N,16) (lossless
    repack, the transcoder's cASTC_4x4 target)."""
    from . import decode as ud

    u = ud.unpack_blocks(blocks)
    n = u.mode.shape[0]
    out = np.zeros((n, 16), dtype=np.uint8)
    for i in range(n):
        mode = int(u.mode[i])
        if mode == T.MODE_SOLID:
            data = pack_void_extent(u.solid_rgba[i])
        else:
            eps = u.endpoints[i].tolist()
            ws = u.weights[i].tolist()
            _blue_contract_fixup(mode, int(u.common_pattern[i]), eps, ws)
            data = pack_astc_block(
                mode, int(u.common_pattern[i]), max(0, int(u.ccs[i])), eps, ws)
        out[i] = np.frombuffer(data, dtype=np.uint8)
    return out


def _blue_contract_fixup(mode: int, common_pattern: int, eps, ws):
    """ASTC CEM 8/12 decoders blue-contract + swap when sum(lo RGB) >
    sum(hi RGB); reorder endpoints (swap lo/hi, invert that subset's
    weights) so decode stays identical (unpack_uastc blue_contract_check,
    basisu_transcoder.cpp)."""
    comps = int(T.MODE_COMPS[mode])
    if comps < 3:
        return
    subsets = int(T.MODE_SUBSETS[mode])
    planes = int(T.MODE_PLANES[mode])
    wb = int(T.MODE_WEIGHT_BITS[mode])
    ep_range = int(T.MODE_ENDPOINT_RANGES[mode])
    unq = T.color_unquant_table(ep_range)
    wmask = (1 << wb) - 1
    invert = [False] * subsets
    any_inv = False
    for s in range(subsets):
        base = s * comps * 2
        s0 = int(unq[eps[base + 0]]) + int(unq[eps[base + 2]]) + int(unq[eps[base + 4]])
        s1 = int(unq[eps[base + 1]]) + int(unq[eps[base + 3]]) + int(unq[eps[base + 5]])
        if s1 < s0:
            for c in range(comps):
                eps[base + c * 2], eps[base + c * 2 + 1] = \
                    eps[base + c * 2 + 1], eps[base + c * 2]
            invert[s] = True
            any_inv = True
    if any_inv:
        seed = T.mode_pattern_seed(mode, common_pattern)
        pat = (T.partition_pattern(seed, subsets) if subsets > 1
               else (0,) * 16)
        for i in range(16):
            if invert[pat[i]]:
                ws[i * planes] = wmask - ws[i * planes]
                if planes == 2:
                    ws[i * planes + 1] = wmask - ws[i * planes + 1]


def etc1s_to_astc(endpoint_idx, selector_idx, color5, inten5, selectors) -> np.ndarray:
    """ETC1S → ASTC 4x4: CEM 8, 8-bit endpoints (range 20), 2-bit weights —
    the same shape as UASTC mode 1 (convert_etc1s_to_astc_4x4 analog)."""
    from ...ops.etc1 import etc1s_palette

    e = np.asarray(endpoint_idx)
    shape = e.shape
    pal = etc1s_palette(color5, inten5)[e.ravel()]        # (N,4,3)
    sel = selectors[np.asarray(selector_idx).ravel()]     # (N,16)
    n = pal.shape[0]
    out = np.zeros((n, 16), dtype=np.uint8)
    for i in range(n):
        lo = pal[i, 0]
        hi = pal[i, 3]
        eps = [int(lo[0]), int(hi[0]), int(lo[1]), int(hi[1]), int(lo[2]), int(hi[2])]
        out[i] = np.frombuffer(
            pack_astc_block(1, 0, 0, eps, sel[i].tolist()), dtype=np.uint8)
    return out.reshape(*shape, 16)