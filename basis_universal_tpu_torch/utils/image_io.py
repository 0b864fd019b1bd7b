"""Copy of `basis_universal_tpu/utils/image_io.py`.

Image file I/O: PNG/JPEG/QOI/DDS/EXR/HDR readers + PNG/DDS/KTX writers.

Covers the reference's image pipeline surface (encoder/basisu_enc.cpp
load_png/load_jpg/load_qoi/load_dds/load_exr, gpu_image export paths
basisu_gpu_texture.cpp:153-244). PNG/JPEG via PIL; EXR/HDR via OpenCV;
QOI decoded natively (spec is 30 lines); DDS reader handles DX9/DX10
uncompressed + BC1-7 block data passthrough.
"""

import os
import pathlib
import struct
from typing import Optional, Tuple

import numpy as np

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")


def load_image(path) -> np.ndarray:
    """Load an LDR image file → (H, W, 4) uint8 RGBA."""
    path = pathlib.Path(path)
    ext = path.suffix.lower()
    if ext == ".qoi":
        return load_qoi(path)
    if ext == ".dds":
        rgba, _ = load_dds(path)
        return rgba
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))


def load_image_hdr(path) -> np.ndarray:
    """Load an HDR image file (.exr/.hdr) → (H, W, 3) float32 linear."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".exr":
        return load_exr(path)
    if path.suffix.lower() == ".hdr":
        return load_radiance_hdr(path)
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    if img is None:
        raise IOError(f"failed to read {path}")
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return np.ascontiguousarray(img[..., ::-1].astype(np.float32))  # BGR→RGB


def load_exr(path) -> np.ndarray:
    """Minimal OpenEXR scanline reader (NONE/RLE/ZIPS/ZIP compression,
    HALF/FLOAT channels). PIZ files need round-2 support."""
    import zlib

    data = pathlib.Path(path).read_bytes()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    p = 8
    attrs = {}
    while True:
        e = data.index(b"\0", p)
        name = data[p:e].decode()
        if not name:
            p = e + 1
            break
        p = e + 1
        e = data.index(b"\0", p)
        atype = data[p:e].decode()
        p = e + 1
        (sz,) = struct.unpack_from("<I", data, p)
        p += 4
        attrs[name] = (atype, data[p:p + sz])
        p += sz

    comp = attrs["compression"][1][0]
    if comp not in (0, 1, 2, 3, 4):
        raise NotImplementedError(
            f"EXR compression {comp} (PXR24/B44/...) not supported yet")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    # channels: list of (name, pixel_type 0=UINT 1=HALF 2=FLOAT)
    chans = []
    cdata = attrs["channels"][1]
    q = 0
    while cdata[q] != 0:
        e = cdata.index(b"\0", q)
        cname = cdata[q:e].decode()
        ptype = struct.unpack_from("<i", cdata, e + 1)[0]
        chans.append((cname, ptype))
        q = e + 1 + 16
    chans.sort()  # stored in alphabetical order per spec

    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}[comp]
    nblocks = -(-h // lines_per_block)
    offsets = struct.unpack_from(f"<{nblocks}Q", data, p)

    out = {c: np.zeros((h, w), dtype=np.float32) for c, _ in chans}
    for bo in offsets:
        y, nbytes = struct.unpack_from("<ii", data, bo)
        raw = data[bo + 8:bo + 8 + nbytes]
        ny = min(lines_per_block, y1 - y + 1)
        row_bytes = sum(w * (2 if t == 1 else 4) for _, t in chans)
        expect = row_bytes * ny
        if comp in (2, 3):
            buf = zlib.decompress(raw)
            if len(buf) == expect:
                raw = _exr_reconstruct(buf)
        elif comp == 1 and len(raw) != expect:
            raw = _exr_rle_decompress(raw, expect)
        elif comp == 4:
            raw = _exr_piz_decompress(raw, chans, w, ny, expect)
        pos = 0
        for row in range(ny):
            for cname, ptype in chans:
                n = w * (2 if ptype == 1 else 4)
                seg = raw[pos:pos + n]
                pos += n
                if ptype == 1:
                    vals = np.frombuffer(seg, np.float16).astype(np.float32)
                else:
                    vals = np.frombuffer(seg, np.float32)
                out[cname][y - y0 + row] = vals
    rgb = np.stack([out.get("R", 0 * out[chans[0][0]]),
                    out.get("G", 0 * out[chans[0][0]]),
                    out.get("B", 0 * out[chans[0][0]])], axis=-1)
    return np.ascontiguousarray(rgb)


def _exr_reconstruct(buf: bytes) -> bytes:
    """OpenEXR zip/rle post-processing: sequential delta reconstruction
    (a running prefix sum, vectorized as cumsum) then half de-interleave."""
    b = np.frombuffer(buf, np.uint8).astype(np.int64)
    b = (np.cumsum(b - 128) + 128) % 256
    b = b.astype(np.uint8)
    half = (len(b) + 1) // 2
    o = np.empty(len(b), dtype=np.uint8)
    o[0::2] = b[:half]
    o[1::2] = b[half:]
    return o.tobytes()


def _exr_rle_decompress(raw, expect):
    out = bytearray()
    i = 0
    while i < len(raw) and len(out) < expect:
        n = struct.unpack_from("<b", raw, i)[0]
        i += 1
        if n < 0:
            out += raw[i:i - n]
            i += -n
        else:
            out += raw[i:i + 1] * (n + 1)
            i += 1
    return _exr_reconstruct(bytes(out))


def load_radiance_hdr(path) -> np.ndarray:
    """Radiance .HDR (RGBE) reader (load_hdr analog, basisu_enc.cpp)."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    p = data.index(b"\n\n") + 2 if b"\n\n" in data else data.index(b"\n \n") + 3
    e = data.index(b"\n", p)
    dims = data[p:e].decode().split()
    assert dims[0] == "-Y" and dims[2] == "+X"
    h, w = int(dims[1]), int(dims[3])
    p = e + 1
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    for y in range(h):
        if data[p] == 2 and data[p + 1] == 2:  # new RLE
            p += 4
            row = np.zeros((4, w), dtype=np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    n = data[p]
                    p += 1
                    if n > 128:
                        row[c, x:x + n - 128] = data[p]
                        p += 1
                        x += n - 128
                    else:
                        row[c, x:x + n] = np.frombuffer(data, np.uint8, n, p)
                        p += n
                        x += n
            rgbe[y] = row.T
        else:  # flat
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, p).reshape(w, 4)
            p += w * 4
    f = rgbe[..., :3].astype(np.float32)
    ex = rgbe[..., 3].astype(np.int32)
    scale = np.where(ex > 0, np.ldexp(1.0, ex - 136), 0.0).astype(np.float32)
    return f * scale[..., None]


def save_png(path, rgba: np.ndarray):
    from PIL import Image

    Image.fromarray(rgba).save(path)


# --- QOI (Quite OK Image format, public spec) -------------------------------

def load_qoi(path) -> np.ndarray:
    data = pathlib.Path(path).read_bytes()
    if data[:4] != b"qoif":
        raise ValueError("not a QOI file")
    w, h = struct.unpack(">II", data[4:12])
    px = [0, 0, 0, 255]
    index = [[0, 0, 0, 0] for _ in range(64)]
    out = np.zeros((h * w, 4), dtype=np.uint8)
    p = 14
    i = 0
    n = h * w
    d = data
    while i < n:
        b0 = d[p]
        p += 1
        if b0 == 0xFE:      # RGB
            px = [d[p], d[p + 1], d[p + 2], px[3]]
            p += 3
        elif b0 == 0xFF:    # RGBA
            px = [d[p], d[p + 1], d[p + 2], d[p + 3]]
            p += 4
        else:
            tag = b0 >> 6
            if tag == 0:    # INDEX
                px = list(index[b0 & 63])
            elif tag == 1:  # DIFF
                px = [(px[0] + ((b0 >> 4) & 3) - 2) & 0xFF,
                      (px[1] + ((b0 >> 2) & 3) - 2) & 0xFF,
                      (px[2] + (b0 & 3) - 2) & 0xFF, px[3]]
            elif tag == 2:  # LUMA
                vg = (b0 & 63) - 32
                b1 = d[p]
                p += 1
                px = [(px[0] + vg - 8 + ((b1 >> 4) & 15)) & 0xFF,
                      (px[1] + vg) & 0xFF,
                      (px[2] + vg - 8 + (b1 & 15)) & 0xFF, px[3]]
            else:           # RUN
                run = (b0 & 63) + 1
                out[i:i + run] = px
                i += run
                index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) & 63] = px
                continue
        index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) & 63] = px
        out[i] = px
        i += 1
    return out.reshape(h, w, 4)


# --- DDS ---------------------------------------------------------------------

DDS_MAGIC = 0x20534444
DDPF_FOURCC = 0x4
DDPF_RGB = 0x40

_DXGI_TO_FMT = {
    71: ("BC1", 8), 72: ("BC1", 8),          # UNORM / UNORM_SRGB
    74: ("BC2", 16), 75: ("BC2", 16),
    77: ("BC3", 16), 78: ("BC3", 16),
    80: ("BC4", 8), 83: ("BC5", 16),
    95: ("BC6H", 16), 98: ("BC7", 16), 99: ("BC7", 16),
    28: ("RGBA8", 4), 29: ("RGBA8", 4), 87: ("BGRA8", 4), 91: ("BGRA8", 4),
}
_FOURCC_TO_FMT = {
    b"DXT1": ("BC1", 8), b"DXT3": ("BC2", 16), b"DXT5": ("BC3", 16),
    b"ATI1": ("BC4", 8), b"BC4U": ("BC4", 8),
    b"ATI2": ("BC5", 16), b"BC5U": ("BC5", 16),
}


def load_dds(path):
    """Read a .DDS file. Returns (rgba (H,W,4) uint8 or None, info dict with
    raw block data for compressed formats)."""
    data = pathlib.Path(path).read_bytes()
    if struct.unpack_from("<I", data, 0)[0] != DDS_MAGIC:
        raise ValueError("not a DDS file")
    (size, flags, h, w, pitch, depth, mips) = struct.unpack_from("<7I", data, 4)
    pf_flags, fourcc = struct.unpack_from("<II", data, 80)
    rgb_bits, rmask, gmask, bmask, amask = struct.unpack_from("<5I", data, 88)
    ofs = 4 + 124
    fmt = None
    layers = 1
    if pf_flags & DDPF_FOURCC:
        fcc = data[84:88]
        if fcc == b"DX10":
            dxgi, dim, misc, array_size, misc2 = struct.unpack_from("<5I", data, ofs)
            ofs += 20
            fmt = _DXGI_TO_FMT.get(dxgi)
            layers = max(1, array_size)
        else:
            fmt = _FOURCC_TO_FMT.get(fcc)
    elif pf_flags & DDPF_RGB:
        fmt = ("RGBA8" if amask else "RGB8", rgb_bits // 8)
    if fmt is None:
        raise NotImplementedError("unsupported DDS format")
    name, bpb = fmt
    info = dict(width=w, height=h, mips=max(1, mips), layers=layers,
                format=name, data_offset=ofs, raw=data[ofs:])
    rgba = None
    if name in ("RGBA8", "BGRA8", "RGB8"):
        npx = w * h
        px = np.frombuffer(data, dtype=np.uint8, count=npx * bpb, offset=ofs)
        px = px.reshape(h, w, bpb)
        rgba = np.zeros((h, w, 4), dtype=np.uint8)
        rgba[..., 3] = 255
        if name == "BGRA8":
            rgba[..., :3] = px[..., 2::-1]
            rgba[..., 3] = px[..., 3]
        else:
            rgba[..., :px.shape[-1]] = px
    elif name in ("BC1", "BC3", "BC4", "BC5", "BC7"):
        from ..ops import gpu_unpack
        from ..ops.etc1 import blocks_to_image

        bx, by = (w + 3) // 4, (h + 3) // 4
        nbytes = bx * by * bpb
        blocks = np.frombuffer(data, np.uint8, count=nbytes, offset=ofs).reshape(-1, bpb)
        if name == "BC1":
            dec = gpu_unpack.unpack_bc1(blocks)
        elif name == "BC3":
            dec = gpu_unpack.unpack_bc3(blocks)
        elif name == "BC4":
            v = gpu_unpack.unpack_bc4(blocks)
            dec = np.zeros(v.shape + (4,), np.uint8)
            dec[..., 0] = v
            dec[..., 3] = 255
        elif name == "BC5":
            dec = gpu_unpack.unpack_bc5(blocks)
        else:
            dec = None  # BC7: only mode-5 unpack available; leave raw
        if dec is not None:
            rgba = blocks_to_image(dec.reshape(by, bx, 4, 4, 4), w, h)
    return rgba, info


_FMT_TO_DXGI = {"BC1": 71, "BC3": 77, "BC4": 80, "BC5": 83, "BC7": 98,
                "BC6H": 95, "RGBA8": 28}
_FMT_BPB = {"BC1": 8, "BC3": 16, "BC4": 8, "BC5": 16, "BC7": 16,
            "BC6H": 16, "RGBA8": 4}


def write_dds(path, block_data: bytes, width: int, height: int, fmt: str):
    """Write a DX10-header .DDS with one mip level
    (basisu_dds_export.cpp analog)."""
    dxgi = _FMT_TO_DXGI[fmt]
    bpb = _FMT_BPB[fmt]
    out = bytearray()
    out += struct.pack("<I", DDS_MAGIC)
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | (0x80000 if fmt != "RGBA8" else 0x8)
    pitch = ((width + 3) // 4) * bpb if fmt != "RGBA8" else width * 4
    out += struct.pack("<7I", 124, flags, height, width, pitch, 0, 1)
    out += b"\0" * 44
    out += struct.pack("<II4s5I", 32, DDPF_FOURCC, b"DX10", 0, 0, 0, 0, 0)
    out += struct.pack("<5I", 0x1000, 0, 0, 0, 0)  # caps
    out += struct.pack("<5I", dxgi, 3, 0, 1, 0)    # DX10: 2D, 1 layer
    out += block_data
    pathlib.Path(path).write_bytes(bytes(out))


_GL_FORMATS = {"BC1": 0x83F1, "BC3": 0x83F3, "BC7": 0x8E8C,
               "ETC1": 0x8D64, "ETC2_RGBA": 0x8278, "ASTC_4x4": 0x93B0}


def write_ktx1(path, block_data: bytes, width: int, height: int, fmt: str):
    """Write a KTX v1 container for a compressed GL format
    (gpu_image::write_ktx analog)."""
    ident = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB,
                   0x0D, 0x0A, 0x1A, 0x0A])
    gl_fmt = _GL_FORMATS[fmt]
    out = bytearray()
    out += ident
    out += struct.pack("<I", 0x04030201)  # endianness
    out += struct.pack("<5I", 0, 1, 0, gl_fmt, gl_fmt)  # type, typesize, fmt, internal, base
    out += struct.pack("<7I", width, height, 0, 0, 1, 1, 0)
    out += struct.pack("<I", len(block_data))
    out += block_data
    pathlib.Path(path).write_bytes(bytes(out))


# ---------------------------------------------------------------------------
# PIZ decompression (parity: encoder/3rdparty/tinyexr.h DecompressPiz:3240,
# hufUncompress:3110, hufUnpackEncTable:2603, hufDecode:2935, wav2Decode:2131,
# reverseLutFromBitmap:3212)
# ---------------------------------------------------------------------------

_HUF_ENCSIZE = 65537
_HUF_DECBITS = 14
_HUF_DECMASK = (1 << _HUF_DECBITS) - 1


def _huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    """OpenEXR 16-bit Huffman decode → uint16 array of n_out symbols.
    Uses the native C++ runtime when available; the pure-Python path below
    is the bit-identical fallback."""
    from .. import native

    lib = native.get_lib()
    if lib is not None:
        import ctypes

        buf = np.frombuffer(data, np.uint8)
        out = np.zeros(n_out, dtype=np.uint16)
        rc = lib.exr_huf_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n_out)
        # rc==1 means the bitstream ended short of n_out symbols — treat
        # truncated/corrupt PIZ data as an error (tinyexr.h:3110 semantics),
        # never silently accept a zero-filled tail.
        if rc == 0:
            return out
        if rc > 0:
            raise ValueError("EXR PIZ Huffman stream truncated")
    return _huf_uncompress_py(data, n_out)


def _huf_uncompress_py(data: bytes, n_out: int) -> np.ndarray:
    im, iM = struct.unpack_from("<II", data, 0)
    (nbits,) = struct.unpack_from("<I", data, 12)
    pos = 20

    # --- unpack code lengths (6-bit, zero-run codes 59..63)
    lengths = np.zeros(_HUF_ENCSIZE, dtype=np.int64)
    c = 0
    lc = 0
    i = im
    while i <= iM:
        while lc < 6:
            c = (c << 8) | data[pos]
            pos += 1
            lc += 8
        lc -= 6
        l = (c >> lc) & 63
        if l == 63:
            while lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            run = ((c >> lc) & 255) + 6
            i += run
        elif l >= 59:
            i += l - 59 + 2
        else:
            lengths[i] = l
            i += 1

    # --- canonical codes (hufCanonicalCodeTable:2490)
    n = np.zeros(59, dtype=np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    code_base = np.zeros(59, dtype=np.int64)
    cc = 0
    for l in range(58, 0, -1):
        nc = (cc + n[l]) >> 1
        code_base[l] = cc
        cc = nc
    syms = np.nonzero(lengths)[0]
    codes = np.zeros(_HUF_ENCSIZE, dtype=np.int64)
    next_code = code_base.copy()
    for s in syms:
        l = lengths[s]
        codes[s] = next_code[l]
        next_code[l] += 1

    # --- fast decode table for codes <= 14 bits
    tbl_len = np.zeros(1 << _HUF_DECBITS, dtype=np.int32)
    tbl_lit = np.zeros(1 << _HUF_DECBITS, dtype=np.int32)
    short = syms[lengths[syms] <= _HUF_DECBITS]
    if short.size:
        sl = lengths[short]
        starts = codes[short] << (_HUF_DECBITS - sl)
        counts = (np.int64(1) << (_HUF_DECBITS - sl))
        order = np.argsort(starts)
        fill_lit = np.repeat(short[order], counts[order])
        fill_len = np.repeat(sl[order], counts[order])
        st = starts[order]
        pos0 = np.repeat(st, counts[order]) + (
            np.arange(fill_lit.size)
            - np.repeat(np.cumsum(counts[order]) - counts[order],
                        counts[order]))
        tbl_lit[pos0] = fill_lit
        tbl_len[pos0] = fill_len
    longs = {}
    for s in syms[lengths[syms] > _HUF_DECBITS]:
        l = int(lengths[s])
        pfx = int(codes[s]) >> (l - _HUF_DECBITS)
        longs.setdefault(pfx, []).append((int(s), l, int(codes[s])))

    # --- bitstream decode (hufDecode:2935); RLC symbol = iM
    out = np.zeros(n_out, dtype=np.uint16)
    oi = 0
    rlc = iM
    tl_list = tbl_len.tolist()
    ti_list = tbl_lit.tolist()
    ie = pos + (nbits + 7) // 8
    c = 0
    lc = 0

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 255
            prev = out[oi - 1]
            out[oi:oi + cs] = prev
            oi += cs
        else:
            out[oi] = sym
            oi += 1

    while pos < ie:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= _HUF_DECBITS:
            idx = (c >> (lc - _HUF_DECBITS)) & _HUF_DECMASK
            pl = tl_list[idx]
            if pl:
                lc -= pl
                emit(ti_list[idx])
            else:
                for s, l, code in longs.get(idx, ()):
                    while lc < l and pos < ie:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= l and code == ((c >> (lc - l)) & ((1 << l) - 1)):
                        lc -= l
                        emit(s)
                        break
                else:
                    raise ValueError("PIZ: invalid huffman code")

    i = (8 - nbits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = (c << (_HUF_DECBITS - lc)) & _HUF_DECMASK
        pl = tl_list[idx]
        if pl and pl <= lc:
            lc -= pl
            emit(ti_list[idx])
        else:
            break
    return out


def _wdec(a, b, w14):
    """Vectorized wdec14/wdec16 (tinyexr.h:1994-2017)."""
    if w14:
        ls = a.astype(np.int16).astype(np.int64)
        hi = b.astype(np.int16).astype(np.int64)
        ai = ls + (hi & 1) + (hi >> 1)
        return (ai.astype(np.int16).astype(np.uint16),
                (ai - hi).astype(np.int16).astype(np.uint16))
    m = a.astype(np.int64)
    d = b.astype(np.int64)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(buf, start, nx, ox, ny, oy, mx):
    """In-place 2D wavelet decode of one plane (wav2Decode:2131);
    element (y, x) lives at buf[start + y*oy + x*ox]."""
    w14 = mx < (1 << 14)
    nmin = min(nx, ny)
    p = 1
    while p <= nmin:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2) if ny >= p2 else np.zeros(0, np.int64)
        xs = np.arange(0, nx - p2 + 1, p2) if nx >= p2 else np.zeros(0, np.int64)
        if ys.size and xs.size:
            idx = start + ys[:, None] * oy + xs[None, :] * ox
            A = buf[idx]
            B = buf[idx + ox * p]
            C = buf[idx + oy * p]
            D = buf[idx + oy * p + ox * p]
            i00, i10 = _wdec(A, C, w14)
            i01, i11 = _wdec(B, D, w14)
            a, b = _wdec(i00, i01, w14)
            cc, dd = _wdec(i10, i11, w14)
            buf[idx] = a
            buf[idx + ox * p] = b
            buf[idx + oy * p] = cc
            buf[idx + oy * p + ox * p] = dd
        if (nx & p) and ys.size:
            x_odd = (xs[-1] + p2) if xs.size else 0
            j = start + ys * oy + x_odd * ox
            a, b = _wdec(buf[j], buf[j + oy * p], w14)
            buf[j] = a
            buf[j + oy * p] = b
        if ny & p:
            y_odd = (ys[-1] + p2) if ys.size else 0
            j = start + y_odd * oy + xs * ox
            a, b = _wdec(buf[j], buf[j + ox * p], w14)
            buf[j] = a
            buf[j + ox * p] = b
        p2 = p
        p >>= 1


def _exr_piz_decompress(raw, chans, w, ny, expect):
    """PIZ scanline-block → raw per-line channel-interleaved bytes."""
    if len(raw) == expect:
        return raw
    min_nz, max_nz = struct.unpack_from("<HH", raw, 0)
    pos = 4
    bitmap = np.zeros(8192, dtype=np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz:min_nz + nb] = np.frombuffer(raw[pos:pos + nb], np.uint8)
        pos += nb
    bits = np.unpackbits(bitmap, bitorder="little")
    sel = np.nonzero(bits)[0]
    if not sel.size or sel[0] != 0:
        sel = np.concatenate([[0], sel])
    lut = np.zeros(65536, dtype=np.uint16)
    lut[:sel.size] = sel
    max_value = sel.size - 1

    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    tmp = _huf_uncompress(raw[pos:pos + length], expect // 2)

    ofs = 0
    for _cname, ptype in chans:
        size = 1 if ptype == 1 else 2
        for j in range(size):
            _wav2_decode(tmp, ofs + j, w, size, ny, w * size, max_value)
        ofs += w * ny * size
    tmp = lut[tmp]

    out = bytearray()
    cur = [0] * len(chans)
    base = []
    b = 0
    for _cname, ptype in chans:
        base.append(b)
        b += w * ny * (1 if ptype == 1 else 2)
    for y in range(ny):
        for ci, (_cname, ptype) in enumerate(chans):
            n = w * (1 if ptype == 1 else 2)
            seg = tmp[base[ci] + cur[ci]:base[ci] + cur[ci] + n]
            cur[ci] += n
            out += seg.astype("<u2").tobytes()
    return bytes(out)
