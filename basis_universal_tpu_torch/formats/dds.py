"""Copy of `basis_universal_tpu/formats/dds.py`.

DDS container read support for TRANSCODING (mips/arrays/cubemaps).

Parity: the reference's DDS transcoder input path
(transcoder/basisu_dds_transcoder.inl; basisu_transcoder.h:1617) — parse
DX9/DX10 headers, enumerate per-(layer, face, mip) images, and expose the
raw payload so the transcode engines can decode BC1-7 / uncompressed data.
utils/image_io.load_dds remains the simple single-image ENCODE input path.
"""

import dataclasses
import struct
from typing import Optional

DDS_MAGIC = 0x20534444
DDPF_FOURCC = 0x4
DDPF_RGB = 0x40
DDSCAPS2_CUBEMAP = 0x200

# (format name, bytes per block/pixel, block-compressed?)
DXGI_FORMATS = {
    71: ("BC1", 8, True), 72: ("BC1", 8, True),
    74: ("BC2", 16, True), 75: ("BC2", 16, True),
    77: ("BC3", 16, True), 78: ("BC3", 16, True),
    80: ("BC4", 8, True), 81: ("BC4", 8, True),
    83: ("BC5", 16, True), 84: ("BC5", 16, True),
    95: ("BC6H", 16, True), 96: ("BC6H", 16, True),
    98: ("BC7", 16, True), 99: ("BC7", 16, True),
    28: ("RGBA8", 4, False), 29: ("RGBA8", 4, False),
    87: ("BGRA8", 4, False), 91: ("BGRA8", 4, False),
    61: ("R8", 1, False), 49: ("RG8", 2, False),
}
FOURCC_FORMATS = {
    b"DXT1": ("BC1", 8, True), b"DXT2": ("BC2", 16, True),
    b"DXT3": ("BC2", 16, True), b"DXT4": ("BC3", 16, True),
    b"DXT5": ("BC3", 16, True),
    b"ATI1": ("BC4", 8, True), b"BC4U": ("BC4", 8, True),
    b"ATI2": ("BC5", 16, True), b"BC5U": ("BC5", 16, True),
}
SRGB_DXGI = {72, 75, 78, 99, 29, 91}


@dataclasses.dataclass
class DdsImage:
    level: int
    layer: int
    face: int
    width: int
    height: int
    offset: int
    size: int


class DdsFile:
    """Parsed DDS: header + per-image payload table."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 128 or struct.unpack_from("<I", data, 0)[0] != DDS_MAGIC:
            raise ValueError("not a DDS file")
        (_sz, _flags, self.height, self.width, _pitch, _depth,
         mips) = struct.unpack_from("<7I", data, 4)
        self.mips = max(1, mips)
        pf_flags = struct.unpack_from("<I", data, 80)[0]
        rgb_bits, amask = struct.unpack_from("<I", data, 88)[0], \
            struct.unpack_from("<I", data, 104)[0]
        caps2 = struct.unpack_from("<I", data, 112)[0]
        ofs = 128
        self.layers = 1
        self.faces = 6 if (caps2 & DDSCAPS2_CUBEMAP) else 1
        self.srgb = False
        fmt = None
        if pf_flags & DDPF_FOURCC:
            fcc = data[84:88]
            if fcc == b"DX10":
                dxgi, _dim, misc, array_size, _m2 = struct.unpack_from(
                    "<5I", data, 128)
                ofs = 148
                fmt = DXGI_FORMATS.get(dxgi)
                self.layers = max(1, array_size)
                self.srgb = dxgi in SRGB_DXGI
                if misc & 0x4:      # DDS_RESOURCE_MISC_TEXTURECUBE
                    self.faces = 6
            else:
                fmt = FOURCC_FORMATS.get(fcc)
        elif pf_flags & DDPF_RGB:
            fmt = (("RGBA8" if amask else "RGB8"), rgb_bits // 8, False)
        if fmt is None:
            raise NotImplementedError("unsupported DDS pixel format")
        self.format, self.bytes_per_unit, self.block_compressed = fmt

        # image table: DDS layout = for each layer/face: all mips
        self.images = {}
        pos = ofs
        for layer in range(self.layers):
            for face in range(self.faces):
                for level in range(self.mips):
                    w = max(1, self.width >> level)
                    h = max(1, self.height >> level)
                    if self.block_compressed:
                        n = ((w + 3) // 4) * ((h + 3) // 4)
                    else:
                        n = w * h
                    size = n * self.bytes_per_unit
                    self.images[(level, layer, face)] = DdsImage(
                        level=level, layer=layer, face=face,
                        width=w, height=h, offset=pos, size=size)
                    pos += size
        if pos > len(data):
            raise ValueError("DDS payload truncated")

    def image(self, level: int = 0, layer: int = 0, face: int = 0) -> DdsImage:
        return self.images[(level, layer, face)]

    def image_data(self, level: int = 0, layer: int = 0,
                   face: int = 0) -> bytes:
        im = self.image(level, layer, face)
        return self.data[im.offset:im.offset + im.size]
