"""Copy of `basis_universal_tpu/codecs/bc7/logical.py`.

Logical BC7 blocks: unpack/pack/interpolate/predict.

Integer-exact port of the reference's bc7u namespace
(transcoder/basisu_transcoder_internal.h:3226-3420 declarations,
basisu_transcoder.cpp:39482-40766 implementations). The spec tables
(weights, partitions, anchors, mode-5 optimal endpoints) live in
bc7_tables.npz — BC7 format constants, bit-exact interop requires them.
"""

import dataclasses
import functools
import pathlib

import numpy as np


@functools.lru_cache(maxsize=None)
def tables():
    return dict(np.load(pathlib.Path(__file__).with_name("bc7_tables.npz")))


# g_endpoint_formats (basisu_transcoder.cpp:39727): (rgb_bits, a_bits, pbits)
ENDPOINT_FORMATS = [
    (4, 0, 2), (6, 0, 1), (5, 0, 0), (7, 0, 2),
    (5, 6, 0), (7, 8, 0), (7, 7, 2), (5, 5, 2),
]


@dataclasses.dataclass
class LogBC7Block:
    mode: int = -1
    num_partitions: int = 0
    pattern_bits: int = 0
    pattern_index: int = 0
    num_planes: int = 1
    dp_rotation_index: int = 0
    mode4_index_selector: int = 0
    endpoint_bits: list = dataclasses.field(default_factory=lambda: [0, 0])
    endpoints: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((3, 2, 4), dtype=np.int64))
    weight_bits: list = dataclasses.field(default_factory=lambda: [0, 0])
    weights: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((2, 16), dtype=np.int64))
    num_pbits: int = 0
    shared_pbits: bool = False
    pbits: list = dataclasses.field(default_factory=lambda: [0] * 6)

    def is_dual_plane(self):
        return self.num_planes == 2

    def get_num_comps(self):
        return 4 if self.endpoint_bits[1] else 3

    def get_num_pbits_per_subset(self):
        if not self.num_pbits:
            return 0
        return 1 if self.shared_pbits else 2

    def get_color_component_selector(self):
        if not self.is_dual_plane():
            return -1
        return (self.dp_rotation_index + 3) & 3

    def copy(self):
        return LogBC7Block(
            mode=self.mode, num_partitions=self.num_partitions,
            pattern_bits=self.pattern_bits, pattern_index=self.pattern_index,
            num_planes=self.num_planes,
            dp_rotation_index=self.dp_rotation_index,
            mode4_index_selector=self.mode4_index_selector,
            endpoint_bits=list(self.endpoint_bits),
            endpoints=self.endpoints.copy(),
            weight_bits=list(self.weight_bits),
            weights=self.weights.copy(),
            num_pbits=self.num_pbits, shared_pbits=self.shared_pbits,
            pbits=list(self.pbits))


NUM_SUBSETS = [3, 2, 3, 2, 1, 1, 1, 2]
PARTITION_BITS = [4, 6, 6, 6, 0, 0, 0, 6]
COLOR_INDEX_BITS = [3, 3, 2, 2, 2, 2, 4, 2]
ALPHA_INDEX_BITS = [0, 0, 0, 0, 3, 2, 4, 2]


def init_log_blk(mode: int) -> LogBC7Block:
    fmt = ENDPOINT_FORMATS[mode]
    blk = LogBC7Block()
    blk.mode = mode
    blk.num_partitions = NUM_SUBSETS[mode]
    blk.num_planes = 2 if mode in (4, 5) else 1
    blk.num_pbits = blk.num_partitions * fmt[2]
    blk.pattern_bits = PARTITION_BITS[mode]
    blk.endpoint_bits = [fmt[0], fmt[1]]
    blk.weight_bits = [COLOR_INDEX_BITS[mode],
                       ALPHA_INDEX_BITS[mode] if blk.num_planes == 2 else 0]
    blk.shared_pbits = fmt[2] == 1
    return blk


def dequant_weight(w: int, num_weight_bits: int) -> int:
    t = tables()
    key = {2: "weights2", 3: "weights3", 4: "weights4"}[num_weight_bits]
    return int(t[key][w])


@functools.lru_cache(maxsize=None)
def _weight_quant():
    """g_weight_quant: [0,64] value → nearest quantized index per bit width."""
    out = {}
    for nb in (2, 3, 4):
        vals = [dequant_weight(i, nb) for i in range(1 << nb)]
        tab = np.zeros(65, dtype=np.int64)
        for de in range(65):
            best, best_err = 0, 1 << 30
            for i, dq in enumerate(vals):
                err = abs(de - dq)
                if err < best_err:
                    best_err, best = err, i
            tab[de] = best
        out[nb] = tab
    return out


def quant_weight(val: int, num_weight_bits: int) -> int:
    val = min(max(val, 0), 64)
    return int(_weight_quant()[num_weight_bits][val])


def bc7_dequant(val: int, val_bits: int, pbit=None) -> int:
    if pbit is not None:
        total = val_bits + 1
        val = (val << 1) | pbit
        val <<= 8 - total
        val |= val >> total
    else:
        val <<= 8 - val_bits
        val |= val >> val_bits
    return val & 0xFF


def bc7_interp(lo: int, hi: int, w: int, num_bits: int) -> int:
    dw = dequant_weight(w, num_bits)
    return (lo * (64 - dw) + hi * dw + 32) >> 6


def _fetch_bits(data: bytes, num_bits: int, bit_ofs: int):
    if not num_bits:
        return 0, bit_ofs
    byte_ofs = bit_ofs >> 3
    b0 = data[byte_ofs]
    b1 = data[min(15, byte_ofs + 1)]
    b = (b0 | (b1 << 8)) >> (bit_ofs & 7)
    return b & ((1 << num_bits) - 1), bit_ofs + num_bits


def determine_mode(data: bytes) -> int:
    for m in range(8):
        if data[0] & (1 << m):
            return m
    return -1


def unpack_phys(data: bytes) -> LogBC7Block:
    """Physical 16-byte BC7 block → logical (bc7u::unpack_bc7,
    basisu_transcoder.cpp:39559)."""
    t = tables()
    mode = determine_mode(data)
    if mode < 0:
        raise ValueError("invalid BC7 block")
    blk = init_log_blk(mode)
    ofs = mode + 1

    def get(n):
        nonlocal ofs
        v, ofs = _fetch_bits(data, n, ofs)
        return v

    if mode in (0, 2):
        blk.pattern_index = get(blk.pattern_bits)
        for c in range(3):
            for s in range(3):
                for e in range(2):
                    blk.endpoints[s][e][c] = get(blk.endpoint_bits[0])
        for p in range(blk.num_pbits):
            blk.pbits[p] = get(1)
        a1 = t["anchor3a"][blk.pattern_index]
        a2 = t["anchor3b"][blk.pattern_index]
        for i in range(16):
            nb = blk.weight_bits[0] - (1 if (i == 0 or i == a1 or i == a2)
                                       else 0)
            blk.weights[0][i] = get(nb)
    elif mode in (1, 3, 7):
        blk.pattern_index = get(blk.pattern_bits)
        num_comps = 4 if mode == 7 else 3
        for c in range(num_comps):
            for s in range(2):
                for e in range(2):
                    blk.endpoints[s][e][c] = get(blk.endpoint_bits[0])
        for p in range(blk.num_pbits):
            blk.pbits[p] = get(1)
        a1 = t["anchor2"][blk.pattern_index]
        for i in range(16):
            nb = blk.weight_bits[0] - (1 if (i == 0 or i == a1) else 0)
            blk.weights[0][i] = get(nb)
    elif mode in (4, 5):
        blk.dp_rotation_index = get(2)
        blk.mode4_index_selector = get(1) if mode == 4 else 0
        for c in range(4):
            for e in range(2):
                blk.endpoints[0][e][c] = get(
                    blk.endpoint_bits[1 if c == 3 else 0])
        for p in range(2):
            for i in range(16):
                nb = blk.weight_bits[p] - (1 if i == 0 else 0)
                blk.weights[p][i] = get(nb)
    else:  # mode 6
        for c in range(4):
            blk.endpoints[0][0][c] = get(7)
            blk.endpoints[0][1][c] = get(7)
        blk.pbits[0] = get(1)
        blk.pbits[1] = get(1)
        for w in range(16):
            blk.weights[0][w] = get(3 if w == 0 else 4)
    assert ofs == 128
    return blk


def unpack_endpoints(blk: LogBC7Block, subset: int):
    """→ [(lo RGBA), (hi RGBA)] dequantized to 8 bits."""
    num_comps = blk.get_num_comps()
    out = [[0, 0, 0, 255], [0, 0, 0, 255]]
    for e in range(2):
        for c in range(num_comps):
            if blk.num_pbits:
                pb = blk.pbits[subset if blk.shared_pbits else subset * 2 + e]
                out[e][c] = bc7_dequant(int(blk.endpoints[subset][e][c]),
                                        blk.endpoint_bits[c == 3], pb)
            else:
                out[e][c] = bc7_dequant(int(blk.endpoints[subset][e][c]),
                                        blk.endpoint_bits[c == 3])
    return out


def texel_subset(blk: LogBC7Block, i: int) -> int:
    t = tables()
    if blk.num_partitions == 2:
        return int(t["partition2"][blk.pattern_index][i])
    if blk.num_partitions == 3:
        return int(t["partition3"][blk.pattern_index][i])
    return 0


def unpack_rgba(blk: LogBC7Block) -> np.ndarray:
    """Logical block → (16, 4) uint8 RGBA (bc7u::unpack_bc7)."""
    eps = [unpack_endpoints(blk, s) for s in range(blk.num_partitions)]
    out = np.zeros((16, 4), dtype=np.uint8)
    sel = blk.mode4_index_selector
    for i in range(16):
        s = texel_subset(blk, i)
        e = eps[s]
        res = [0, 0, 0, 255]
        for c in range(3):
            res[c] = bc7_interp(e[0][c], e[1][c],
                                int(blk.weights[sel][i]),
                                blk.weight_bits[sel])
        if blk.get_num_comps() == 4:
            if blk.num_planes == 2:
                res[3] = bc7_interp(e[0][3], e[1][3],
                                    int(blk.weights[1 - sel][i]),
                                    blk.weight_bits[1 - sel])
            else:
                res[3] = bc7_interp(e[0][3], e[1][3],
                                    int(blk.weights[0][i]),
                                    blk.weight_bits[0])
        if blk.dp_rotation_index:
            r = blk.dp_rotation_index - 1
            res[3], res[r] = res[r], res[3]
        out[i] = res
    return out


def unpack_texel(blk: LogBC7Block, x: int, y: int):
    return unpack_rgba(blk)[x + y * 4]


def create_solid_blk(rgba) -> LogBC7Block:
    t = tables()
    blk = init_log_blk(5)
    for c in range(3):
        lo, hi = t["mode5_opt"][int(rgba[c])]
        blk.endpoints[0][0][c] = int(lo)
        blk.endpoints[0][1][c] = int(hi)
    blk.endpoints[0][0][3] = int(rgba[3])
    blk.endpoints[0][1][3] = int(rgba[3])
    blk.weights[0][:] = 1
    return blk


# --- endpoint DPCM (integer-exact; basisu_transcoder.cpp:39814-40090) -------

def _quant_endpoint(v8: int, num_bits: int) -> int:
    maxv = (1 << num_bits) - 1
    return (v8 * maxv * 2 + 255) // 510


def _quant_endpoint_pbit(v8: int, p: int, iscalep: int) -> int:
    k = (v8 * iscalep + 255 - 255 * p) // 510
    return min(max(k * 2 + p, p), iscalep - 1 + p)


def _expand(v: int, total_bits: int) -> int:
    s = v << (8 - total_bits)
    return s | (s >> total_bits)


def _determine_pbits_int(total_comps, comp_bits, xl, xh, shared: bool):
    total_bits = comp_bits + 1
    iscalep = (1 << total_bits) - 1
    if shared:
        best_err = None
        best = None
        for p in range(2):
            xmin = [_quant_endpoint_pbit(xl[c], p, iscalep) for c in range(4)]
            xmax = [_quant_endpoint_pbit(xh[c], p, iscalep) for c in range(4)]
            err = 0
            for i in range(total_comps):
                d0 = _expand(xmin[i], total_bits) - xl[i]
                d1 = _expand(xmax[i], total_bits) - xh[i]
                err += d0 * d0 + d1 * d1
            if best_err is None or err < best_err:
                best_err = err
                best = ([v >> 1 for v in xmin], [v >> 1 for v in xmax], [p, p])
        return best
    best_err0 = best_err1 = None
    lo = hi = None
    pb = [0, 0]
    for p in range(2):
        xmin = [_quant_endpoint_pbit(xl[c], p, iscalep) for c in range(4)]
        xmax = [_quant_endpoint_pbit(xh[c], p, iscalep) for c in range(4)]
        err0 = err1 = 0
        for i in range(total_comps):
            d0 = _expand(xmin[i], total_bits) - xl[i]
            d1 = _expand(xmax[i], total_bits) - xh[i]
            err0 += d0 * d0
            err1 += d1 * d1
        if best_err0 is None or err0 < best_err0:
            best_err0, pb[0], lo = err0, p, [v >> 1 for v in xmin]
        if best_err1 is None or err1 < best_err1:
            best_err1, pb[1], hi = err1, p, [v >> 1 for v in xmax]
    return lo, hi, pb


def pack_endpoints_int(mode: int, src_lo, src_hi):
    """8-bit RGBA endpoint pair → (packed_lo, packed_hi, pbits[2])."""
    fmt = ENDPOINT_FORMATS[mode]
    num_comps = 4 if fmt[1] else 3
    if fmt[2] == 0:
        lo = [(_quant_endpoint(src_lo[c], fmt[1] if c == 3 else fmt[0])
               if (fmt[1] if c == 3 else fmt[0]) else 0) for c in range(4)]
        hi = [(_quant_endpoint(src_hi[c], fmt[1] if c == 3 else fmt[0])
               if (fmt[1] if c == 3 else fmt[0]) else 0) for c in range(4)]
        return lo, hi, [0, 0]
    lo, hi, pb = _determine_pbits_int(num_comps, fmt[0], list(src_lo),
                                      list(src_hi), fmt[2] == 1)
    return lo, hi, pb


def endpoint_dpcm_decode(pred_blk: LogBC7Block, pred_subset: int,
                         blk: LogBC7Block, subset: int,
                         residuals, residual_pbits):
    """Decode path of bc7u::endpoint_dpcm (basisu_transcoder.cpp:39972)."""
    pred = unpack_endpoints(pred_blk, pred_subset)
    if pred_blk.is_dual_plane():
        ccs = pred_blk.get_color_component_selector()
        pred[0][ccs], pred[0][3] = pred[0][3], pred[0][ccs]
        pred[1][ccs], pred[1][3] = pred[1][3], pred[1][ccs]
    ccs = blk.get_color_component_selector()
    if blk.is_dual_plane():
        pred[0][ccs], pred[0][3] = pred[0][3], pred[0][ccs]
        pred[1][ccs], pred[1][3] = pred[1][3], pred[1][ccs]

    packed_lo, packed_hi, packed_pbits = pack_endpoints_int(
        blk.mode, pred[0], pred[1])
    num_comps = blk.get_num_comps()
    fmt = ENDPOINT_FORMATS[blk.mode]

    g_channel, a_channel = 1, 3
    if blk.is_dual_plane():
        a_channel = ccs
        if ccs == 1:
            g_channel = 3

    temp = list(residuals[:num_comps * 2])
    for c in range(num_comps):
        if c == g_channel or c == a_channel:
            continue
        temp[c * 2 + 0] = (temp[c * 2 + 0] + temp[g_channel * 2 + 0]) & 0xFF
        temp[c * 2 + 1] = (temp[c * 2 + 1] + temp[g_channel * 2 + 1]) & 0xFF

    for c in range(num_comps):
        nb = blk.endpoint_bits[c == 3]
        mask = (1 << nb) - 1
        blk.endpoints[subset][0][c] = (temp[c * 2 + 0] + packed_lo[c]) & mask
        blk.endpoints[subset][1][c] = (temp[c * 2 + 1] + packed_hi[c]) & mask

    for p in range(fmt[2]):
        blk.pbits[subset * fmt[2] + p] = (residual_pbits[p]
                                          + packed_pbits[p]) & 1


# --- physical packing --------------------------------------------------------

class _BitWriter128:
    def __init__(self):
        self.bits = 0
        self.ofs = 0

    def put(self, v: int, n: int):
        self.bits |= (v & ((1 << n) - 1)) << self.ofs
        self.ofs += n

    def to_bytes(self) -> bytes:
        assert self.ofs == 128, self.ofs
        return self.bits.to_bytes(16, "little")


def pack_phys(blk: LogBC7Block) -> bytes:
    """Logical → physical 16-byte BC7 block (bc7u::pack_bc7 semantics:
    anchor-MSB constraints resolved by per-subset endpoint swap + weight
    inversion, lossless in decoded-pixel space)."""
    t = tables()
    b = blk.copy()
    mode = b.mode

    # anchor fixups per weight plane/subset
    if mode in (4, 5):
        for p in range(2):
            wb = b.weight_bits[p]
            if b.weights[p][0] & (1 << (wb - 1)):
                b.weights[p] = ((1 << wb) - 1) - b.weights[p]
                for c in range(4):
                    if _endpoint_channel_plane(b, c) == p:
                        b.endpoints[0][0][c], b.endpoints[0][1][c] = \
                            int(b.endpoints[0][1][c]), int(b.endpoints[0][0][c])
    else:
        anchors = [0]
        if b.num_partitions == 2:
            anchors = [0, int(t["anchor2"][b.pattern_index])]
        elif b.num_partitions == 3:
            anchors = [0, int(t["anchor3a"][b.pattern_index]),
                       int(t["anchor3b"][b.pattern_index])]
        wb = b.weight_bits[0]
        for s in range(b.num_partitions):
            a = anchors[s]
            if b.weights[0][a] & (1 << (wb - 1)):
                for i in range(16):
                    if texel_subset(b, i) == s:
                        b.weights[0][i] = ((1 << wb) - 1) - int(b.weights[0][i])
                for c in range(4):
                    b.endpoints[s][0][c], b.endpoints[s][1][c] = \
                        int(b.endpoints[s][1][c]), int(b.endpoints[s][0][c])
                npb = b.get_num_pbits_per_subset()
                if npb == 2:
                    b.pbits[s * 2], b.pbits[s * 2 + 1] = \
                        b.pbits[s * 2 + 1], b.pbits[s * 2]

    w = _BitWriter128()
    w.put(1 << mode, mode + 1)
    if mode in (0, 2):
        w.put(b.pattern_index, b.pattern_bits)
        for c in range(3):
            for s in range(3):
                for e in range(2):
                    w.put(int(b.endpoints[s][e][c]), b.endpoint_bits[0])
        for p in range(b.num_pbits):
            w.put(b.pbits[p], 1)
        a1 = int(t["anchor3a"][b.pattern_index])
        a2 = int(t["anchor3b"][b.pattern_index])
        for i in range(16):
            nb = b.weight_bits[0] - (1 if (i == 0 or i == a1 or i == a2)
                                     else 0)
            w.put(int(b.weights[0][i]), nb)
    elif mode in (1, 3, 7):
        w.put(b.pattern_index, b.pattern_bits)
        num_comps = 4 if mode == 7 else 3
        for c in range(num_comps):
            for s in range(2):
                for e in range(2):
                    w.put(int(b.endpoints[s][e][c]), b.endpoint_bits[0])
        for p in range(b.num_pbits):
            w.put(b.pbits[p], 1)
        a1 = int(t["anchor2"][b.pattern_index])
        for i in range(16):
            nb = b.weight_bits[0] - (1 if (i == 0 or i == a1) else 0)
            w.put(int(b.weights[0][i]), nb)
    elif mode in (4, 5):
        w.put(b.dp_rotation_index, 2)
        if mode == 4:
            w.put(b.mode4_index_selector, 1)
        for c in range(4):
            for e in range(2):
                w.put(int(b.endpoints[0][e][c]),
                      b.endpoint_bits[1 if c == 3 else 0])
        for p in range(2):
            for i in range(16):
                nb = b.weight_bits[p] - (1 if i == 0 else 0)
                w.put(int(b.weights[p][i]), nb)
    else:  # 6
        for c in range(4):
            w.put(int(b.endpoints[0][0][c]), 7)
            w.put(int(b.endpoints[0][1][c]), 7)
        w.put(b.pbits[0], 1)
        w.put(b.pbits[1], 1)
        for i in range(16):
            w.put(int(b.weights[0][i]), 3 if i == 0 else 4)
    return w.to_bytes()


def _endpoint_channel_plane(blk: LogBC7Block, c: int) -> int:
    if not blk.is_dual_plane():
        return 0
    if c == 3:
        return 1 - blk.mode4_index_selector
    return blk.mode4_index_selector
