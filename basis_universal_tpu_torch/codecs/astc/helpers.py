"""Copy of `basis_universal_tpu/codecs/astc/helpers.py`.

General ASTC block decode: physical → logical → pixels (LDR and HDR).

astc_helpers decode-side equivalent (transcoder/basisu_astc_helpers.h:
decode_config/unpack_block :4725, decode_block :2925; HDR endpoint decode
from basisu_transcoder.cpp:22150+). Follows the Khronos ASTC specification:
11-bit block-mode rows, ISE with interleaved trit/quint blocks, weight-grid
bilinear infill (§18.11), LDR CEMs 0/4/6/8/12 with blue-contract, HDR CEMs
7/11 decoded to qlog12 and interpolated in qlog16 space.
"""

import dataclasses

import numpy as np

from ..uastc import tables as T
from ..uastc.astc_pack import _decode_quint_block, _decode_trit_block

BISE_RANGE_TABLE = T.BISE_RANGE_TABLE  # (bits, trits, quints) per range


def ise_levels(r: int) -> int:
    b, t, q = BISE_RANGE_TABLE[r]
    return (1 << b) * (3 ** t) * (5 ** q)


def ise_sequence_bits(count: int, r: int) -> int:
    b, t, q = BISE_RANGE_TABLE[r]
    total = count * b
    if t:
        total += (count * 8 + 4) // 5
    if q:
        total += (count * 7 + 2) // 3
    return total


class _Bits:
    """128-bit little-endian bit reader over a 16-byte block."""

    def __init__(self, block16: bytes):
        self.v = int.from_bytes(bytes(block16), "little")

    def get(self, ofs: int, n: int) -> int:
        return (self.v >> ofs) & ((1 << n) - 1)

    def reversed(self) -> "_Bits":
        r = _Bits(b"\0" * 16)
        v = self.v
        out = 0
        for _ in range(128):
            out = (out << 1) | (v & 1)
            v >>= 1
        r.v = out
        return r


def decode_bise(bits: _Bits, ofs: int, count: int, r: int):
    """ISE sequence decode → list of symbol values ((tq<<bits)|m layout)."""
    b, t, q = BISE_RANGE_TABLE[r]
    vals = []
    pos = ofs
    if t:
        tbits = (2, 2, 1, 2, 1)
        for i0 in range(0, count, 5):
            n = min(5, count - i0)
            m = []
            tt = 0
            t_ofs = 0
            for c in range(n):
                m.append(bits.get(pos, b) if b else 0)
                pos += b
                tt |= bits.get(pos, tbits[c]) << t_ofs
                pos += tbits[c]
                t_ofs += tbits[c]
            trits = _decode_trit_block(tt)
            vals.extend((trits[c] << b) | m[c] for c in range(n))
    elif q:
        qbits = (3, 2, 2)
        for i0 in range(0, count, 3):
            n = min(3, count - i0)
            m = []
            qq = 0
            q_ofs = 0
            for c in range(n):
                m.append(bits.get(pos, b) if b else 0)
                pos += b
                qq |= bits.get(pos, qbits[c]) << q_ofs
                pos += qbits[c]
                q_ofs += qbits[c]
            quints = _decode_quint_block(qq)
            vals.extend((quints[c] << b) | m[c] for c in range(n))
    else:
        for _ in range(count):
            vals.append(bits.get(pos, b))
            pos += b
    return vals


# block-mode decode rows (the spec's table; layout mirrored from
# basisu_astc_helpers.h s_dec_rows)
_DEC_ROWS = [
    # Dp, P, W_ofs, W_sz, H_ofs, H_sz, W_bias, H_bias, p0, p1, p2
    (10, 9, 7, 2, 5, 2, 4, 2, 4, 0, 1),
    (10, 9, 7, 2, 5, 2, 8, 2, 4, 0, 1),
    (10, 9, 5, 2, 7, 2, 2, 8, 4, 0, 1),
    (10, 9, 5, 2, 7, 1, 2, 6, 4, 0, 1),
    (10, 9, 7, 1, 5, 2, 2, 2, 4, 0, 1),
    (10, 9, 0, 0, 5, 2, 12, 2, 4, 2, 3),
    (10, 9, 5, 2, 0, 0, 2, 12, 4, 2, 3),
    (10, 9, 0, 0, 0, 0, 6, 10, 4, 2, 3),
    (10, 9, 0, 0, 0, 0, 10, 6, 4, 2, 3),
    (-1, -1, 5, 2, 9, 2, 6, 6, 4, 2, 3),
]


@dataclasses.dataclass
class LogBlock:
    grid_width: int = 0
    grid_height: int = 0
    dual_plane: bool = False
    weight_ise_range: int = 0
    endpoint_ise_range: int = 0
    num_partitions: int = 1
    partition_id: int = 0
    cems: tuple = (0,)
    ccs: int = 0
    endpoints: list = dataclasses.field(default_factory=list)
    weights: list = dataclasses.field(default_factory=list)  # grid order, planes interleaved
    solid_hdr: bool = False
    solid_ldr: bool = False
    solid_color: tuple = (0, 0, 0, 0)   # unorm16/half bits


def _decode_config(bits: _Bits, blk: LogBlock) -> bool:
    if bits.get(0, 4) == 0:
        return False
    if bits.get(0, 2) == 0 and bits.get(6, 3) == 0b111:
        if bits.get(2, 4) != 0b1111:
            return False
    if bits.get(0, 9) == 0b111111100:
        # bit 9 (D) set → HDR void extent, colors are half-float bits
        # (decode_void_extent, transcoder/basisu_astc_helpers.h:4439)
        blk.solid_hdr = bits.get(9, 1) == 1
        blk.solid_ldr = not blk.solid_hdr
        blk.solid_color = tuple(bits.get(64 + 16 * i, 16) for i in range(4))
        return True
    x0_2 = bits.get(0, 2)
    x2_2 = bits.get(2, 2)
    x5_4 = bits.get(5, 4)
    x8_1 = bits.get(8, 1)
    x7_2 = bits.get(7, 2)
    row = -1
    if x0_2 == 0:
        if x7_2 == 0b00:
            row = 5
        elif x7_2 == 0b01:
            row = 6
        elif x5_4 == 0b1100:
            row = 7
        elif x5_4 == 0b1101:
            row = 8
        elif x7_2 == 0b10:
            row = 9
    else:
        if x2_2 == 0b00:
            row = 0
        elif x2_2 == 0b01:
            row = 1
        elif x2_2 == 0b10:
            row = 2
        elif x8_1 == 0:
            row = 3
        else:
            row = 4
    if row < 0:
        return False
    (dp_ofs, p_ofs, w_ofs, w_sz, h_ofs, h_sz, w_bias, h_bias,
     p0o, p1o, p2o) = _DEC_ROWS[row]
    p_flag = bits.get(p_ofs, 1) if p_ofs >= 0 else 0
    dp = bits.get(dp_ofs, 1) if dp_ofs >= 0 else 0
    w = w_bias + (bits.get(w_ofs, w_sz) if w_sz else 0)
    h = h_bias + (bits.get(h_ofs, h_sz) if h_sz else 0)
    p = bits.get(p0o, 1) | (bits.get(p1o, 1) << 1) | (bits.get(p2o, 1) << 2)
    if p < 2:
        return False
    blk.grid_width = w
    blk.grid_height = h
    blk.weight_ise_range = (p - 2) + (6 if p_flag else 0)  # +BISE_10_LEVELS
    blk.dual_plane = bool(dp)
    return True


def cem_num_values(cem: int) -> int:
    return 2 + 2 * (cem >> 2)


def unpack_block(block16, blk_width: int = 4, blk_height: int = 4):
    """Physical ASTC block → LogBlock (None on invalid encodings)."""
    bits = _Bits(block16)
    blk = LogBlock()
    if not _decode_config(bits, blk):
        return None
    if blk.solid_hdr or blk.solid_ldr:
        return blk
    if blk.grid_width > blk_width or blk.grid_height > blk_height:
        return None
    total_w = (2 if blk.dual_plane else 1) * blk.grid_width * blk.grid_height
    total_weight_bits = ise_sequence_bits(total_w, blk.weight_ise_range)
    if not total_w or total_w > 64 or total_weight_bits < 24 or total_weight_bits > 96:
        return None
    end_of_weights = 128 - total_weight_bits

    extra_bits = 0
    blk.num_partitions = bits.get(11, 2) + 1
    cems = [0] * blk.num_partitions
    if blk.num_partitions == 1:
        cems[0] = bits.get(13, 4)
    else:
        if blk.dual_plane and blk.num_partitions == 4:
            return None
        blk.partition_id = bits.get(13, 10)
        cem_bits = bits.get(23, 6)
        if (cem_bits & 3) == 0:
            cems = [cem_bits >> 2] * blk.num_partitions
        else:
            first_cem_index = ((cem_bits & 3) - 1) * 4
            extra_bits = 3 * blk.num_partitions - 4
            if total_weight_bits + extra_bits > 128:
                return None
            pos = end_of_weights - extra_bits
            cbits = cem_bits >> 2
            c = [(cbits >> i) & 1 for i in range(blk.num_partitions)]
            cbits >>= blk.num_partitions
            m = [0] * blk.num_partitions
            if blk.num_partitions == 2:
                m[0] = cbits & 3
                m[1] = bits.get(pos, 2); pos += 2
            elif blk.num_partitions == 3:
                m[0] = (cbits & 1) | (bits.get(pos, 1) << 1); pos += 1
                m[1] = bits.get(pos, 2); pos += 2
                m[2] = bits.get(pos, 2); pos += 2
            else:
                for i in range(4):
                    m[i] = bits.get(pos, 2); pos += 2
            cems = [first_cem_index + c[i] * 4 + m[i]
                    for i in range(blk.num_partitions)]
    blk.cems = tuple(cems)

    if blk.dual_plane:
        extra_bits += 2
        if extra_bits > end_of_weights:
            return None
        blk.ccs = bits.get(end_of_weights - extra_bits, 2)

    config_bits = 11 + 2 + (4 if blk.num_partitions == 1 else 16)
    remaining = 128 - config_bits - extra_bits - total_weight_bits
    if remaining < 0:
        return None
    total_vals = sum(cem_num_values(c) for c in cems)
    if total_vals > 18:
        return None
    ep_range = -1
    for k in range(20, 0, -1):
        if ise_sequence_bits(total_vals, k) <= remaining:
            ep_range = k
            break
    if ep_range < 4:
        return None
    blk.endpoint_ise_range = ep_range
    blk.endpoints = decode_bise(bits, config_bits, total_vals, ep_range)
    blk.weights = decode_bise(bits.reversed(), 0, total_w, blk.weight_ise_range)
    return blk


# --- dequantization ----------------------------------------------------------

def dequant_weight(val: int, r: int) -> int:
    """ISE weight symbol → [0,64] (dequant_bise_weight semantics)."""
    b, t, q = BISE_RANGE_TABLE[r]
    if r == 0:
        u = 63 if val else 0
    elif r == 1:
        u = (0, 32, 63)[val]
    elif r == 3:
        u = (0, 16, 32, 47, 63)[val]
    elif not t and not q:
        u = _bit_rep(val, b, 6)
    else:
        range_index = b * 2 + (1 if q else 0)
        m = val & ((1 << b) - 1)
        d = val >> b
        a_ = m & 1
        bb = (m >> 1) & 1
        cc = (m >> 2) & 1
        A = 0x7F if a_ else 0
        B = 0
        if range_index == 4:
            B = (bb << 6) | (bb << 2) | bb
        elif range_index == 5:
            B = (bb << 6) | (bb << 1)
        elif range_index == 6:
            B = (cc << 6) | (bb << 5) | (cc << 1) | bb
        C = (50, 28, 23, 13, 11)[range_index - 2]
        u = d * C + B
        u ^= A
        u = (A & 0x20) | (u >> 2)
    if u > 32:
        u += 1
    return u


def _bit_rep(v, src, dst):
    out = 0
    shift = dst - src
    while shift > -src:
        out |= (v << shift) if shift >= 0 else (v >> -shift)
        shift -= src
    return out & ((1 << dst) - 1)


def dequant_endpoint(val: int, r: int) -> int:
    return int(T.color_unquant_table(r)[val])


# --- weight grid infill (spec §18.11) ----------------------------------------

def upsample_weights(grid, gw: int, gh: int, bw: int, bh: int):
    """grid: per-grid-sample weights [0,64] → per-texel weights [0,64]."""
    if gw == bw and gh == bh:
        return list(grid)
    ds = (1024 + bw // 2) // (bw - 1)
    dt = (1024 + bh // 2) // (bh - 1)
    out = []
    for t_ in range(bh):
        for s_ in range(bw):
            cs = ds * s_
            ct = dt * t_
            gs = (cs * (gw - 1) + 32) >> 6
            gt = (ct * (gh - 1) + 32) >> 6
            js, fs = gs >> 4, gs & 0xF
            jt, ft = gt >> 4, gt & 0xF
            w11 = (fs * ft + 8) >> 4
            w10 = ft - w11
            w01 = fs - w11
            w00 = 16 - fs - ft + w11
            def g(x, y):
                x = min(x, gw - 1)
                y = min(y, gh - 1)
                return grid[y * gw + x]
            out.append((g(js, jt) * w00 + g(js + 1, jt) * w01
                        + g(js, jt + 1) * w10 + g(js + 1, jt + 1) * w11
                        + 8) >> 4)
    return out


# --- HDR endpoint decode (basisu_transcoder.cpp:22150+) ----------------------

def _decode_mode7_qlog12(v):
    v0, v1, v2, v3 = v
    modeval = ((v0 & 0xC0) >> 6) | ((v1 & 0x80) >> 5) | ((v2 & 0x80) >> 4)
    if (modeval & 0xC) != 0xC:
        majcomp, mode = modeval >> 2, modeval & 3
    elif modeval != 0xF:
        majcomp, mode = modeval & 3, 4
    else:
        majcomp, mode = 0, 5
    red, green, blue, scale = v0 & 0x3F, v1 & 0x1F, v2 & 0x1F, v3 & 0x1F
    x0, x1 = (v1 >> 6) & 1, (v1 >> 5) & 1
    x2, x3 = (v2 >> 6) & 1, (v2 >> 5) & 1
    x4, x5, x6 = (v3 >> 7) & 1, (v3 >> 6) & 1, (v3 >> 5) & 1
    ohm = 1 << mode
    if ohm & 0x30: green |= x0 << 6
    if ohm & 0x3A: green |= x1 << 5
    if ohm & 0x30: blue |= x2 << 6
    if ohm & 0x3A: blue |= x3 << 5
    if ohm & 0x3D: scale |= x6 << 5
    if ohm & 0x2D: scale |= x5 << 6
    if ohm & 0x04: scale |= x4 << 7
    if ohm & 0x3B: red |= x4 << 6
    if ohm & 0x04: red |= x3 << 6
    if ohm & 0x10: red |= x5 << 7
    if ohm & 0x0F: red |= x2 << 7
    if ohm & 0x05: red |= x1 << 8
    if ohm & 0x0A: red |= x0 << 8
    if ohm & 0x05: red |= x0 << 9
    if ohm & 0x02: red |= x6 << 9
    if ohm & 0x01: red |= x3 << 10
    if ohm & 0x02: red |= x5 << 10
    shamt = (1, 1, 2, 3, 4, 5)[mode]
    red <<= shamt; green <<= shamt; blue <<= shamt; scale <<= shamt
    if mode != 5:
        green = red - green
        blue = red - blue
    if majcomp == 1:
        red, green = green, red
    if majcomp == 2:
        red, blue = blue, red
    clamp = lambda x: min(max(x, 0), 0xFFF)
    e1 = (clamp(red), clamp(green), clamp(blue))
    e0 = (clamp(red - scale), clamp(green - scale), clamp(blue - scale))
    return e0, e1


def _sign_extend(v, bits):
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _decode_mode11_qlog12(v):
    v0, v1, v2, v3, v4, v5 = v
    maj = ((v4 >> 7) & 1) | (((v5 >> 7) & 1) << 1)
    if maj == 3:
        e0 = (v0 << 4, v2 << 4, (v4 & 127) << 5)
        e1 = (v1 << 4, v3 << 4, (v5 & 127) << 5)
        return e0, e1
    mode = ((v1 >> 7) & 1) | (((v2 >> 7) & 1) << 1) | (((v3 >> 7) & 1) << 2)
    va = v0 | (((v1 >> 6) & 1) << 8)
    vb0 = v2 & 63
    vb1 = v3 & 63
    vc = v1 & 63
    dbits = (7, 6, 7, 6, 5, 6, 5, 6)[mode]
    vd0 = _sign_extend(v4 & 0x7F, dbits) if dbits == 7 else _sign_extend(v4 & ((1 << dbits) - 1), dbits)
    vd1 = _sign_extend(v5 & 0x7F, dbits) if dbits == 7 else _sign_extend(v5 & ((1 << dbits) - 1), dbits)
    x0, x1 = (v2 >> 6) & 1, (v3 >> 6) & 1
    x2, x3 = (v4 >> 6) & 1, (v5 >> 6) & 1
    x4, x5 = (v4 >> 5) & 1, (v5 >> 5) & 1
    ohm = 1 << mode
    if ohm & 0xA4: va |= x0 << 9
    if ohm & 0x08: va |= x2 << 9
    if ohm & 0x50: va |= x4 << 9
    if ohm & 0x50: va |= x5 << 10
    if ohm & 0xA0: va |= x1 << 10
    if ohm & 0xC0: va |= x2 << 11
    if ohm & 0x04: vc |= x1 << 6
    if ohm & 0xE8: vc |= x3 << 6
    if ohm & 0x20: vc |= x2 << 7
    if ohm & 0x5B: vb0 |= x0 << 6
    if ohm & 0x5B: vb1 |= x1 << 6
    if ohm & 0x12: vb0 |= x2 << 7
    if ohm & 0x12: vb1 |= x3 << 7
    shamt = (mode >> 1) ^ 3
    va <<= shamt; vb0 <<= shamt; vb1 <<= shamt
    vc <<= shamt; vd0 <<= shamt; vd1 <<= shamt
    clamp = lambda x: min(max(x, 0), 0xFFF)
    e1 = [clamp(va), clamp(va - vb0), clamp(va - vb1)]
    e0 = [clamp(va - vc), clamp(va - vb0 - vc - vd0), clamp(va - vb1 - vc - vd1)]
    if maj:
        e0[0], e0[maj] = e0[maj], e0[0]
        e1[0], e1[maj] = e1[maj], e1[0]
    return tuple(e0), tuple(e1)


def qlog16_to_half(k: int) -> int:
    e = (k & 0xF800) >> 11
    m = k & 0x7FF
    if m < 512:
        mt = 3 * m
    elif m >= 1536:
        mt = 5 * m - 2048
    else:
        mt = 4 * m - 512
    return (e << 10) + (mt >> 3)


def _interp(le: int, he: int, w: int) -> int:
    return (le * (64 - w) + he * w + 32) >> 6


def _blue_contract(r, g, b):
    return ((r + b) >> 1, (g + b) >> 1, b)


def decode_block(blk: LogBlock, bw: int = 4, bh: int = 4, srgb: bool = False):
    """LogBlock → pixels. LDR CEMs return (bh,bw,4) uint8; HDR CEMs return
    (bh,bw,4) uint16 half-float bits (alpha = 1.0 half)."""
    any_hdr = (blk.solid_hdr or any(c in (2, 3, 7, 11, 14) for c in blk.cems)) \
        if not blk.solid_ldr else False
    if blk.solid_ldr:
        out = np.zeros((bh, bw, 4), dtype=np.uint8)
        for c in range(4):
            out[..., c] = blk.solid_color[c] >> 8
        return out
    if blk.solid_hdr:
        out = np.zeros((bh, bw, 4), dtype=np.uint16)
        for c in range(4):
            out[..., c] = blk.solid_color[c]  # already half bits
        return out

    # per-subset endpoint decode
    ep_vals = blk.endpoints
    subsets = blk.num_partitions
    ofs = 0
    sub_eps = []
    for s in range(subsets):
        cem = blk.cems[s]
        n = cem_num_values(cem)
        vals = [dequant_endpoint(v, blk.endpoint_ise_range)
                for v in ep_vals[ofs:ofs + n]]
        ofs += n
        if cem == 0:     # LDR luminance direct
            e0 = (vals[0], vals[0], vals[0], 255)
            e1 = (vals[1], vals[1], vals[1], 255)
            hdr = False
        elif cem == 4:   # LDR LA direct
            e0 = (vals[0], vals[0], vals[0], vals[2])
            e1 = (vals[1], vals[1], vals[1], vals[3])
            hdr = False
        elif cem == 6:   # LDR RGB scale
            e1 = (vals[0], vals[1], vals[2], 255)
            e0 = ((vals[0] * vals[3]) >> 8, (vals[1] * vals[3]) >> 8,
                  (vals[2] * vals[3]) >> 8, 255)
            hdr = False
        elif cem == 8:   # LDR RGB direct
            s0 = vals[0] + vals[2] + vals[4]
            s1 = vals[1] + vals[3] + vals[5]
            if s1 >= s0:
                e0 = (vals[0], vals[2], vals[4], 255)
                e1 = (vals[1], vals[3], vals[5], 255)
            else:
                e0 = _blue_contract(vals[1], vals[3], vals[5]) + (255,)
                e1 = _blue_contract(vals[0], vals[2], vals[4]) + (255,)
            hdr = False
        elif cem == 12:  # LDR RGBA direct
            s0 = vals[0] + vals[2] + vals[4]
            s1 = vals[1] + vals[3] + vals[5]
            if s1 >= s0:
                e0 = (vals[0], vals[2], vals[4], vals[6])
                e1 = (vals[1], vals[3], vals[5], vals[7])
            else:
                e0 = _blue_contract(vals[1], vals[3], vals[5]) + (vals[7],)
                e1 = _blue_contract(vals[0], vals[2], vals[4]) + (vals[6],)
            hdr = False
        elif cem == 7:   # HDR RGB base+scale
            e0, e1 = _decode_mode7_qlog12(vals)
            hdr = True
        elif cem == 11:  # HDR RGB direct
            e0, e1 = _decode_mode11_qlog12(vals)
            hdr = True
        elif cem in (1, 5, 9, 10, 13):  # remaining LDR CEMs (base+ofs etc.)
            from .xuastc_cems import decode_endpoint_ise20

            e0, e1 = decode_endpoint_ise20(cem, vals)
            hdr = False
        else:
            raise NotImplementedError(f"CEM {cem} not supported yet")
        sub_eps.append((e0, e1, hdr))

    # weights: dequantize, upsample to the block
    raw_w = [dequant_weight(w, blk.weight_ise_range) for w in blk.weights]
    if blk.dual_plane:
        p0 = upsample_weights(raw_w[0::2], blk.grid_width, blk.grid_height, bw, bh)
        p1 = upsample_weights(raw_w[1::2], blk.grid_width, blk.grid_height, bw, bh)
    else:
        p0 = upsample_weights(raw_w, blk.grid_width, blk.grid_height, bw, bh)
        p1 = p0

    small = (bw * bh) < 31
    out_hdr = any(h for (_a, _b, h) in sub_eps)
    out = np.zeros((bh, bw, 4), dtype=np.uint16 if out_hdr else np.uint8)
    for y in range(bh):
        for x in range(bw):
            if subsets > 1:
                sub = T.astc_select_partition(
                    blk.partition_id, x, y, 0, subsets, small)
            else:
                sub = 0
            e0, e1, hdr = sub_eps[sub]
            for c in range(4):
                w = p1[y * bw + x] if (blk.dual_plane and c == blk.ccs) else p0[y * bw + x]
                if hdr:
                    if c == 3:
                        out[y, x, c] = 0x3C00  # 1.0 half
                    else:
                        q = _interp(e0[c] << 4, e1[c] << 4, w)
                        hf = qlog16_to_half(q)
                        if (hf & 0x7C00) == 0x7C00:  # Inf/NaN clamp
                            hf = 0x7BFF
                        out[y, x, c] = hf
                else:
                    le, he = e0[c], e1[c]
                    if srgb:
                        # sRGB decode expands ALL channels (incl. alpha) as
                        # (v<<8)|0x80 (basisu_astc_helpers.h:3602)
                        l16 = (le << 8) | 0x80
                        h16 = (he << 8) | 0x80
                    else:
                        l16 = (le << 8) | le
                        h16 = (he << 8) | he
                    out[y, x, c] = _interp(l16, h16, w) >> 8
    return out


def decode_blocks_rgba16f(blocks, bw: int = 4, bh: int = 4) -> np.ndarray:
    """(N,16) ASTC HDR blocks → (N,bh,bw,4) uint16 half-float bits."""
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, 16)
    out = np.zeros((blocks.shape[0], bh, bw, 4), dtype=np.uint16)
    for i in range(blocks.shape[0]):
        blk = unpack_block(blocks[i].tobytes(), bw, bh)
        if blk is None:
            raise ValueError(f"invalid ASTC block {i}")
        px = decode_block(blk, bw, bh)
        if px.dtype == np.uint8:  # LDR block inside an HDR stream
            h = np.zeros_like(out[i])
            f = px.astype(np.float32) / 255.0
            h[:] = np.asarray(f, dtype=np.float16).view(np.uint16)
            out[i] = h
        else:
            out[i] = px
    return out


def decode_blocks_rgba8(blocks, srgb: bool = False,
                        bw: int = 4, bh: int = 4) -> np.ndarray:
    """(N,16) ASTC LDR blocks → (N,bh,bw,4) uint8.  Any standard LDR block
    footprint 4x4..12x12 (the per-block machinery above is size-generic)."""
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, 16)
    out = np.zeros((blocks.shape[0], bh, bw, 4), dtype=np.uint8)
    for i in range(blocks.shape[0]):
        blk = unpack_block(blocks[i].tobytes(), bw, bh)
        if blk is None:
            raise ValueError(f"invalid ASTC block {i}")
        px = decode_block(blk, bw, bh, srgb=srgb)
        assert px.dtype == np.uint8
        out[i] = px
    return out


def decode_block_mode_fields(bm: int):
    """11-bit block mode → (grid_w, grid_h, weight_ise_range, dual_plane)
    or None (uses the same row machinery as _decode_config)."""
    blk16 = bytearray(16)
    blk16[0] = bm & 0xFF
    blk16[1] = (bm >> 8) & 7
    bits = _Bits(bytes(blk16))
    blk = LogBlock()
    if bits.get(0, 9) == 0b111111100:
        return None
    if not _decode_config(bits, blk):
        return None
    return blk.grid_width, blk.grid_height, blk.weight_ise_range, blk.dual_plane
