"""Copy of `basis_universal_tpu/ops/gpu_unpack.py`.

GPU block-format unpackers for validation + stats (gpu_image analog —
basisu_gpu_texture.cpp's unpack_block family). Vectorized numpy; each takes
(N, bytes) blocks and returns (N, 4, 4, C) pixels (y, x order)."""

import numpy as np

from .transcode import EAC_MODIFIERS


def unpack_bc1(blocks, bc1_threecolor=True):
    b = np.asarray(blocks, dtype=np.uint32)
    n = b.shape[0]
    c0 = b[:, 0] | (b[:, 1] << 8)
    c1 = b[:, 2] | (b[:, 3] << 8)

    def exp565(c):
        r = (c >> 11) & 31
        g = (c >> 5) & 63
        bl = c & 31
        return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                         (bl << 3) | (bl >> 2)], -1).astype(np.int64)

    p0, p1 = exp565(c0), exp565(c1)
    four = (c0 > c1) | (~np.asarray(bc1_threecolor, dtype=bool))
    p2_4 = (p0 * 2 + p1) // 3
    p3_4 = (p0 + p1 * 2) // 3
    p2_3 = (p0 + p1) // 2
    p3_3 = np.zeros_like(p0)
    p2 = np.where(four[:, None], p2_4, p2_3)
    p3 = np.where(four[:, None], p3_4, p3_3)
    pal = np.stack([p0, p1, p2, p3], axis=1)                # (N,4,3)
    bits = (b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16)
            | (b[:, 7].astype(np.uint64) << np.uint64(24))).astype(np.uint64)
    out = np.zeros((n, 4, 4, 4), dtype=np.uint8)
    out[..., 3] = 255
    for i in range(16):
        idx = ((bits >> np.uint64(2 * i)) & np.uint64(3)).astype(np.int64)
        out[:, i // 4, i % 4, :3] = pal[np.arange(n), idx]
        # 3-color mode index 3 alpha=0
        trans = (~four) & (idx == 3)
        out[trans, i // 4, i % 4, 3] = 0
    return out


def unpack_bc4(blocks):
    """(N,8) → (N,4,4) single-channel values."""
    b = np.asarray(blocks, dtype=np.int64)
    n = b.shape[0]
    a0, a1 = b[:, 0], b[:, 1]
    pal = np.zeros((n, 8), dtype=np.int64)
    pal[:, 0], pal[:, 1] = a0, a1
    eight = a0 > a1
    for k in range(1, 7):
        pal[:, k + 1] = np.where(eight, ((7 - k) * a0 + k * a1) // 7, 0)
    # six-interpolant mode (a0 <= a1): pal[2..5]=interp/5, pal[6]=0, pal[7]=255
    six = ~eight
    for k in range(1, 5):
        v = ((5 - k) * a0 + k * a1) // 5
        pal[six, k + 1] = v[six]
    pal[six, 6] = 0
    pal[six, 7] = 255
    bits = np.zeros(n, dtype=np.uint64)
    for i in range(6):
        bits |= b[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    out = np.zeros((n, 4, 4), dtype=np.uint8)
    for i in range(16):
        idx = ((bits >> np.uint64(3 * i)) & np.uint64(7)).astype(np.int64)
        out[:, i // 4, i % 4] = pal[np.arange(n), idx]
    return out


def unpack_bc3(blocks):
    b = np.asarray(blocks, dtype=np.uint8)
    rgb = unpack_bc1(b[:, 8:], bc1_threecolor=False)
    a = unpack_bc4(b[:, :8])
    rgb[..., 3] = a
    return rgb


def unpack_bc5(blocks):
    b = np.asarray(blocks, dtype=np.uint8)
    r = unpack_bc4(b[:, :8])
    g = unpack_bc4(b[:, 8:])
    n = b.shape[0]
    out = np.zeros((n, 4, 4, 4), dtype=np.uint8)
    out[..., 0] = r
    out[..., 1] = g
    out[..., 3] = 255
    return out


def unpack_bc7_mode5(blocks):
    """Decode BC7 blocks that are known to be mode 5 (our ETC1S output)."""
    b = np.asarray(blocks, dtype=np.uint8)
    n = b.shape[0]
    lo = np.zeros(n, dtype=np.uint64)
    hi = np.zeros(n, dtype=np.uint64)
    for i in range(8):
        lo |= b[:, i].astype(np.uint64) << np.uint64(8 * i)
        hi |= b[:, 8 + i].astype(np.uint64) << np.uint64(8 * i)

    def get(pos, nbits):
        if pos >= 64:
            v = hi >> np.uint64(pos - 64)
        elif pos + nbits > 64:
            v = (lo >> np.uint64(pos)) | (hi << np.uint64(64 - pos))
        else:
            v = lo >> np.uint64(pos)
        return (v & np.uint64((1 << nbits) - 1)).astype(np.int64)

    assert True
    mode = get(0, 6)
    if not np.all(mode == 0b100000):
        raise ValueError("not all mode-5 blocks")
    pos = 8  # skip mode + rotation (assumed 0)
    rot = get(6, 2)
    ep = np.zeros((n, 2, 4), dtype=np.int64)
    for ch in range(3):
        e0 = get(pos, 7); pos += 7
        e1 = get(pos, 7); pos += 7
        ep[:, 0, ch] = (e0 << 1) | (e0 >> 6)
        ep[:, 1, ch] = (e1 << 1) | (e1 >> 6)
    ep[:, 0, 3] = get(pos, 8); pos += 8
    ep[:, 1, 3] = get(pos, 8); pos += 8

    weights = np.array([0, 21, 43, 64], dtype=np.int64)
    cidx = np.zeros((n, 16), dtype=np.int64)
    cidx[:, 0] = get(pos, 1); pos += 1
    for i in range(1, 16):
        cidx[:, i] = get(pos, 2); pos += 2
    aidx = np.zeros((n, 16), dtype=np.int64)
    aidx[:, 0] = get(pos, 1); pos += 1
    for i in range(1, 16):
        aidx[:, i] = get(pos, 2); pos += 2
    assert pos == 128

    out = np.zeros((n, 4, 4, 4), dtype=np.uint8)
    for i in range(16):
        wc = weights[cidx[:, i]]
        wa = weights[aidx[:, i]]
        rgb = (ep[:, 0, :3] * (64 - wc)[:, None] + ep[:, 1, :3] * wc[:, None] + 32) >> 6
        a = (ep[:, 0, 3] * (64 - wa) + ep[:, 1, 3] * wa + 32) >> 6
        out[:, i // 4, i % 4, :3] = rgb
        out[:, i // 4, i % 4, 3] = a
    # rotation swaps a channel with alpha; our encoder always writes rot=0
    if np.any(rot != 0):
        raise ValueError("rotation != 0 unsupported in validator")
    return out


def unpack_atc(blocks):
    """ATC RGB blocks → (N,4,4,4) RGBA (unpack_atc semantics,
    basisu_gpu_texture.cpp:326)."""
    b = np.asarray(blocks, dtype=np.int64)
    n = b.shape[0]
    color0 = b[:, 0] | (b[:, 1] << 8)
    color1 = b[:, 2] | (b[:, 3] << 8)
    mode = (color0 & 0x8000) != 0
    r0 = (color0 >> 10) & 31
    g0 = (color0 >> 5) & 31
    b0 = color0 & 31
    c0 = np.stack([(r0 << 3) | (r0 >> 2), (g0 << 3) | (g0 >> 2),
                   (b0 << 3) | (b0 >> 2)], -1)
    r3 = (color1 >> 11) & 31
    g3 = (color1 >> 5) & 63
    b3 = color1 & 31
    c3 = np.stack([(r3 << 3) | (r3 >> 2), (g3 << 2) | (g3 >> 4),
                   (b3 << 3) | (b3 >> 2)], -1)
    # normal mode interpolants
    c1n = (c0 * 5 + c3 * 3) >> 3
    c2n = (c0 * 3 + c3 * 5) >> 3
    # alt mode
    c1a = np.maximum(0, c0 - (c3 >> 2))
    pal = np.zeros((n, 4, 3), dtype=np.int64)
    m = mode[:, None]
    pal[:, 0] = np.where(m, 0, c0)
    pal[:, 1] = np.where(m, c1a, c1n)
    pal[:, 2] = np.where(m, c0, c2n)
    pal[:, 3] = c3
    sels = (b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)).astype(np.uint64)
    out = np.zeros((n, 4, 4, 4), dtype=np.uint8)
    out[..., 3] = 255
    for i in range(16):
        s = ((sels >> np.uint64(2 * i)) & np.uint64(3)).astype(np.int64)
        out[:, i // 4, i % 4, :3] = pal[np.arange(n), s]
    return out


def unpack_eac_r11(blocks):
    """EAC R11 blocks → (N,4,4) 8-bit values (11-bit decode scaled down)."""
    b = np.asarray(blocks, dtype=np.int64)
    n = b.shape[0]
    base = b[:, 0]
    mult = b[:, 1] >> 4
    table = b[:, 1] & 15
    bits = np.zeros(n, dtype=np.uint64)
    for i in range(6):
        bits |= b[:, 2 + i].astype(np.uint64) << np.uint64(8 * (5 - i))
    out = np.zeros((n, 4, 4), dtype=np.uint8)
    scale = np.where(mult > 0, mult * 8, 1)
    for x in range(4):
        for y in range(4):
            shift = np.uint64(45 - 3 * (x * 4 + y))
            s = ((bits >> shift) & np.uint64(7)).astype(np.int64)
            v11 = np.clip(base * 8 + 4 + EAC_MODIFIERS[table, s] * scale, 0, 2047)
            out[:, y, x] = (v11 * 255 + 1023) // 2047
    return out


def unpack_eac_a8(blocks):
    b = np.asarray(blocks, dtype=np.int64)
    n = b.shape[0]
    base = b[:, 0]
    mult = b[:, 1] >> 4
    table = b[:, 1] & 15
    bits = np.zeros(n, dtype=np.uint64)
    for i in range(6):
        bits |= b[:, 2 + i].astype(np.uint64) << np.uint64(8 * (5 - i))
    out = np.zeros((n, 4, 4), dtype=np.uint8)
    for x in range(4):
        for y in range(4):
            shift = np.uint64(45 - 3 * (x * 4 + y))
            s = ((bits >> shift) & np.uint64(7)).astype(np.int64)
            v = np.clip(base + EAC_MODIFIERS[table, s] * np.maximum(mult, 1), 0, 255)
            # mult==0: modifier table scaled by 1/8? spec: multiplier 0 means
            # modifiers are divided by 8 — our encoder never emits mult=0
            out[:, y, x] = v
    return out


def unpack_fxt1(blocks, width, height):
    """FXT1 CC_MIXED blocks (nby, nfx, 16) → (H, W, 4) RGBA (validation
    mirror of encoder/basisu_gpu_texture.cpp unpack_fxt1:716)."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    nby, nfx = blocks.shape[:2]
    words = blocks.view("<u8").reshape(nby, nfx, 2).astype(np.uint64)
    lo, hi = words[..., 0], words[..., 1]
    assert ((hi >> np.uint64(63)) == 1).all(), "FXT1: only CC_MIXED supported"
    assert (((hi >> np.uint64(60)) & np.uint64(1)) == 0).all()

    sel_bytes = blocks[..., :8].astype(np.int64)           # (nby,nfx,8)
    glsb = ((hi >> np.uint64(61)) & np.uint64(3)).astype(np.int64)

    def color(slot, g_lsb):
        s = slot * 15
        b = ((hi >> np.uint64(s)) & np.uint64(31)).astype(np.int64)
        g5 = ((hi >> np.uint64(s + 5)) & np.uint64(31)).astype(np.int64)
        r = ((hi >> np.uint64(s + 10)) & np.uint64(31)).astype(np.int64)
        g = (g5 << 1) | g_lsb
        # expand 565
        r8 = (r << 3) | (r >> 2)
        g8 = (g << 2) | (g >> 4)
        b8 = (b << 3) | (b >> 2)
        return np.stack([r8, g8, b8], axis=-1)

    out = np.zeros((nby * 4, nfx * 8, 4), dtype=np.uint8)
    out[..., 3] = 255
    for half in range(2):
        anchor = (sel_bytes[..., half * 4] >> 1) & 1
        gl = (glsb >> half) & 1
        c0 = color(half * 2, anchor ^ gl)
        c1 = color(half * 2 + 1, gl)
        ramp = np.stack([
            c0,
            (c0 * 2 + c1 + 1) // 3,
            (c1 * 2 + c0 + 1) // 3,
            c1], axis=2)                                    # (nby,nfx,4,3)
        for y in range(4):
            row = sel_bytes[..., half * 4 + y]
            for x in range(4):
                sel = (row >> (x * 2)) & 3
                px = np.take_along_axis(
                    ramp, sel[..., None, None], axis=2)[..., 0, :]
                out[y::4, (half * 4 + x)::8, :3] = px
    return out[:height, :width]


def unpack_bc7(blocks):
    """(N,16) uint8 physical BC7 → (N,16,4) uint8 RGBA (texel-major).

    Fully vectorized all-mode unpack (unpack_block cBC7,
    basisu_gpu_texture.cpp; semantics = bc7u::unpack_bc7): blocks are
    grouped by mode, and within a mode every field is a static bit range
    except the weight grid, whose per-texel widths depend on the
    anchor-texel positions — handled with per-block anchor lookups and a
    cumulative-offset gather over an (N,128) little-endian bit matrix."""
    from ..codecs.bc7 import logical as L

    blocks = np.ascontiguousarray(np.asarray(blocks, np.uint8)).reshape(-1, 16)
    n = blocks.shape[0]
    out = np.zeros((n, 16, 4), np.uint8)
    if not n:
        return out
    bits = np.unpackbits(blocks, axis=1, bitorder="little")   # (N,128)
    mode = np.argmax(bits[:, :8], axis=1)
    mode[bits[:, :8].sum(1) == 0] = 0        # invalid → treated as mode 0
    t = L.tables()
    dq = {nb: np.array([L.dequant_weight(i, nb) for i in range(1 << nb)],
                       np.int64) for nb in (2, 3, 4)}

    def get_field(sub, ofs, width):
        """Static bit range [ofs, ofs+width) of each selected block."""
        sl = sub[:, ofs:ofs + width].astype(np.int64)
        return (sl << np.arange(width, dtype=np.int64)).sum(1)

    def gather_var(sub, offs, widths, max_w):
        """Per-block variable-offset gather: value[k] = bits[offs[k]..]."""
        m = sub.shape[0]
        rows = np.arange(m)[:, None]
        vals = np.zeros((m,) + offs.shape[1:], np.int64)
        for k in range(max_w):
            take = k < widths
            idx = np.minimum(offs + k, 127)   # masked lanes may point past end
            vals |= (sub[rows, idx] & take).astype(np.int64) << k
        return vals

    for md in range(8):
        sel = np.nonzero(mode == md)[0]
        if not sel.size:
            continue
        sub = bits[sel]
        m = sel.size
        blk = L.init_log_blk(md)
        fmt = L.ENDPOINT_FORMATS[md]
        nsub, pbits_n = blk.num_partitions, blk.num_pbits
        eb, ab = fmt[0], fmt[1]
        wb0 = blk.weight_bits[0]
        ofs = md + 1

        rot = np.zeros(m, np.int64)
        idxsel = np.zeros(m, np.int64)
        if md in (4, 5):
            rot = get_field(sub, ofs, 2)
            ofs += 2
            if md == 4:
                idxsel = get_field(sub, ofs, 1)
                ofs += 1

        pat = np.zeros(m, np.int64)
        if blk.pattern_bits:
            pat = get_field(sub, ofs, blk.pattern_bits)
            ofs += blk.pattern_bits

        # endpoints[subset][e][c] in the mode's field order
        num_comps = 4 if ab else 3
        eps = np.zeros((m, nsub, 2, 4), np.int64)
        if md in (4, 5):
            for c in range(4):
                nb = ab if c == 3 else eb
                for e in range(2):
                    eps[:, 0, e, c] = get_field(sub, ofs, nb)
                    ofs += nb
        elif md == 6:
            for c in range(4):
                for e in range(2):
                    eps[:, 0, e, c] = get_field(sub, ofs, 7)
                    ofs += 7
        else:
            for c in range(num_comps):
                for s in range(nsub):
                    for e in range(2):
                        eps[:, s, e, c] = get_field(sub, ofs, eb)
                        ofs += eb
        pb = np.zeros((m, 6), np.int64)
        for p in range(pbits_n):
            pb[:, p] = get_field(sub, ofs, 1)
            ofs += 1

        # per-texel subset + anchor flags
        if nsub == 2:
            subs = np.asarray(t["partition2"], np.int64)[pat]      # (m,16)
            anchors = np.stack([np.zeros(m, np.int64),
                                np.asarray(t["anchor2"], np.int64)[pat]], 1)
        elif nsub == 3:
            subs = np.asarray(t["partition3"], np.int64)[pat]
            anchors = np.stack([np.zeros(m, np.int64),
                                np.asarray(t["anchor3a"], np.int64)[pat],
                                np.asarray(t["anchor3b"], np.int64)[pat]], 1)
        else:
            subs = np.zeros((m, 16), np.int64)
            anchors = np.zeros((m, 1), np.int64)

        is_anchor = (anchors[:, :, None]
                     == np.arange(16)[None, None, :]).any(1)       # (m,16)
        is_anchor[:, 0] = True

        # weight grids: plane 0 then (modes 4/5) plane 1
        planes_w = []
        for p in range(blk.num_planes):
            wb = blk.weight_bits[p] if blk.num_planes == 2 else wb0
            if blk.num_planes == 2:
                # dual-plane: only texel 0 is the anchor of each plane
                widths = np.full((m, 16), wb, np.int64)
                widths[:, 0] = wb - 1
            else:
                widths = wb - is_anchor.astype(np.int64)
            offs = ofs + np.concatenate(
                [np.zeros((m, 1), np.int64),
                 np.cumsum(widths[:, :-1], axis=1)], axis=1)
            planes_w.append(gather_var(sub, offs, widths, wb))
            # per-block totals are equal within a mode (anchor count is
            # fixed), so the next field's base offset stays static
            ofs += int(widths.sum(1)[0])
        w0 = planes_w[0]
        w1 = planes_w[1] if blk.num_planes == 2 else w0

        # dequantize endpoints (+ pbits)
        rows = np.arange(m)[:, None]
        e8 = np.zeros((m, nsub, 2, 4), np.int64)
        for s in range(nsub):
            for e in range(2):
                for c in range(num_comps):
                    nb = ab if c == 3 else eb
                    v = eps[:, s, e, c]
                    if pbits_n:
                        pbi = pb[:, s] if blk.shared_pbits else pb[:, s * 2 + e]
                        total = nb + 1
                        v2 = ((v << 1) | pbi) << (8 - total)
                        e8[:, s, e, c] = (v2 | (v2 >> total)) & 0xFF
                    else:
                        v2 = v << (8 - nb)
                        e8[:, s, e, c] = (v2 | (v2 >> nb)) & 0xFF
            if num_comps == 3:
                e8[:, s, :, 3] = 255

        # interpolate
        lo = e8[rows, subs]                                 # (m,16,2,4)
        hi = lo[:, :, 1, :]
        lo = lo[:, :, 0, :]
        res = np.empty((m, 16, 4), np.int64)
        if blk.num_planes == 2:
            # mode 4: plane0=2b, plane1=3b; index_selector swaps the
            # color/alpha roles of the two planes (mode 5: selector 0)
            dw0 = dq[blk.weight_bits[0]][w0]
            dw1 = dq[blk.weight_bits[1]][w1]
            flip = idxsel[:, None].astype(bool)
            dw_c = np.where(flip, dw1, dw0)
            dw_a = np.where(flip, dw0, dw1)
            for c in range(3):
                res[..., c] = (lo[..., c] * (64 - dw_c) + hi[..., c] * dw_c
                               + 32) >> 6
            res[..., 3] = (lo[..., 3] * (64 - dw_a) + hi[..., 3] * dw_a
                           + 32) >> 6
            # rotation: swap channel (rot-1) with alpha
            for r in (1, 2, 3):
                mask = rot == r
                if mask.any():
                    tmp = res[mask][..., r - 1].copy()
                    res[mask, :, r - 1] = res[mask][..., 3]
                    res[mask, :, 3] = tmp
        else:
            dw = dq[wb0][w0]
            for c in range(4):
                if c == 3 and num_comps == 3:
                    res[..., 3] = 255
                    continue
                res[..., c] = (lo[..., c] * (64 - dw) + hi[..., c] * dw
                               + 32) >> 6
        out[sel] = res.astype(np.uint8)
    return out
