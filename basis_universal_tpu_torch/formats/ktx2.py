"""Copy of `basis_universal_tpu/formats/ktx2.py`.

.KTX2 container reader/writer (Khronos KTX 2.0 + Basis supercompression).

Byte-level contract (studied from the reference, re-implemented):
  - ktx2_header / ktx2_level_index / ETC1S global data structs:
    transcoder/basisu_transcoder.h:1028-1089
  - file assembly order, padding and level ordering (smallest mip first):
    basis_compressor::create_ktx2_file, encoder/basisu_comp.cpp:4830+
  - DFD values: basis_compressor::get_dfd (encoder/basisu_comp.cpp:4636;
    templates :4469-4534), generated programmatically here per the Khronos
    Data Format Specification layout.
  - supercompression schemes: NONE=0 BASISLZ=1 ZSTANDARD=2 UASTC_HDR_6x6I=4
    (basisu_transcoder.h:1142-1146); XUASTC_LDR / XUBC7 use their own ids.
"""

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .constants import BasisTexFormat

KTX2_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB,
                         0x0D, 0x0A, 0x1A, 0x0A])

KTX2_SS_NONE = 0
KTX2_SS_BASISLZ = 1
KTX2_SS_ZSTANDARD = 2
KTX2_SS_UASTC_HDR_6x6_INTERMEDIATE = 4

KTX2_VK_FORMAT_UNDEFINED = 0

KTX2_IMAGE_IS_P_FRAME = 2

# KDFS color models (basisu_transcoder.h:1123-1129)
KDF_MODEL_ASTC = 162
KDF_MODEL_ETC1S = 163
KDF_MODEL_UASTC_LDR_4X4 = 166
KDF_MODEL_UASTC_HDR_4X4 = 167
KDF_MODEL_UASTC_HDR_6X6_INTERMEDIATE = 168
KDF_MODEL_XUASTC_LDR = 169
KDF_MODEL_XUBC7 = 170

KDF_PRIMARIES_BT709 = 1
KDF_PRIMARIES_BT2020 = 2
KDF_TRANSFER_LINEAR = 1
KDF_TRANSFER_SRGB = 2

_HDR_FMT = "<13I2Q"  # after the 12-byte identifier (80-byte header total)


def make_dfd(color_model: int, *, block_w: int = 4, block_h: int = 4,
             bytes_per_block: int = 8, srgb: bool = True, alpha: bool = False,
             alpha_plane_bytes: int = 0, channels: Optional[list] = None,
             primaries: int = KDF_PRIMARIES_BT709) -> bytes:
    """Build a KDFS basic descriptor block equal to the reference templates.

    channels: list of (bitOffset, bitLength-1, channelTypeAndQualifiers,
    lower, upper) samples; default is the single 64-bit RGB sample the
    reference templates use (channelType 0 with flags 0x3F? — see
    g_ktx2_etc1s_nonalpha_dfd, basisu_comp.cpp:4469).
    """
    if channels is None:
        channels = [(0, 63, 0x00, 0, 0xFFFFFFFF)]
        if alpha:
            channels.append((64, 63, 0x0F, 0, 0xFFFFFFFF))
    num_samples = len(channels)
    block_size = 24 + 16 * num_samples
    total = 4 + block_size
    out = bytearray()
    out += struct.pack("<I", total)
    out += struct.pack("<HH", 0, 0)                  # vendor KHR, type basic
    out += struct.pack("<HH", 2, block_size)         # version 2, block size
    transfer = KDF_TRANSFER_SRGB if srgb else KDF_TRANSFER_LINEAR
    out += bytes([color_model & 0xFF, primaries, transfer, 0])
    out += bytes([block_w - 1, block_h - 1, 0, 0])   # texel block dims
    planes = [bytes_per_block, alpha_plane_bytes, 0, 0, 0, 0, 0, 0]
    out += bytes(planes)
    for (bit_ofs, bit_len_m1, ch, lower, upper) in channels:
        out += struct.pack("<HBB", bit_ofs, bit_len_m1, ch)
        out += bytes([0, 0, 0, 0])                   # sample positions
        out += struct.pack("<II", lower, upper)
    assert len(out) == total
    return bytes(out)


def etc1s_dfd(srgb: bool, alpha: bool) -> bytes:
    """Matches g_ktx2_etc1s_{non,}alpha_dfd byte-for-byte (44/60 bytes):
    sample0 = RGB (channelType 0, bitLength 63), sample1 = alpha
    (channelType 0x0F) when present."""
    channels = [(0, 63, 0x00, 0, 0xFFFFFFFF)]
    if alpha:
        channels.append((64, 63, 0x0F, 0, 0xFFFFFFFF))
    return make_dfd(
        KDF_MODEL_ETC1S, bytes_per_block=8, srgb=srgb, alpha=alpha,
        alpha_plane_bytes=8 if alpha else 0, channels=channels)


def uastc_ldr_4x4_dfd(srgb: bool, alpha: bool) -> bytes:
    """Matches g_ktx2_uastc_ldr_4x4_{non,}alpha_dfd (44 bytes): one 128-bit
    sample, channelType 4 (RGB) or 3 (RGBA) — basisu_comp.cpp:4505-4534."""
    channels = [(0, 127, 0x03 if alpha else 0x04, 0, 0xFFFFFFFF)]
    return make_dfd(
        KDF_MODEL_UASTC_LDR_4X4, bytes_per_block=16, srgb=srgb, alpha=False,
        channels=channels)


def uastc_hdr_4x4_dfd() -> bytes:
    """Matches g_ktx2_uastc_hdr_4x4_nonalpha_dfd byte-for-byte: model 167,
    linear transfer, one 128-bit sample with the FLOAT qualifier (0x80),
    sampleLower 0.0 / sampleHigher 1.0f bits (basisu_comp.cpp:4537)."""
    channels = [(0, 127, 0x80, 0, 0x3F800000)]
    return make_dfd(
        KDF_MODEL_UASTC_HDR_4X4, bytes_per_block=16, srgb=False,
        channels=channels)


ASTC_VK_SIZES = ["4x4", "5x4", "5x5", "6x5", "6x6", "8x5", "8x6", "8x8",
                 "10x5", "10x6", "10x8", "10x10", "12x10", "12x12"]


def astc_dfd(srgb: bool, block_w: int, block_h: int,
             hdr: bool = False) -> bytes:
    """Standard-ASTC DFD (model 162 KHR_DF_MODEL_ASTC, one 128-bit sample;
    byte-exact vs the reference's KTX2 output for -ldr_*/-hdr_6x6)."""
    if hdr:
        channels = [(0, 127, 0x80, 0, 0x3F800000)]
        return make_dfd(162, block_w=block_w, block_h=block_h,
                        bytes_per_block=16, srgb=False, channels=channels)
    channels = [(0, 127, 0x00, 0, 0xFFFFFFFF)]
    return make_dfd(162, block_w=block_w, block_h=block_h,
                    bytes_per_block=16, srgb=srgb, channels=channels)


def write_ktx2_astc(
    *, base_width: int, base_height: int, level_count: int,
    layer_count: int, face_count: int,
    slice_blocks: List[bytes], slice_info: List[dict],
    block_w: int = 4, block_h: int = 4, srgb: bool = True,
    hdr: bool = False, zstd_level: int = 6, supercompression: bool = True,
    key_values: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """Standard-ASTC payload KTX2 (VkFormat ASTC_<WxH>_UNORM/SRGB/SFLOAT,
    Zstd supercompression) — the container the reference writes for its
    ASTC LDR 4x4-12x12 and ASTC HDR 6x6 modes."""
    idx = ASTC_VK_SIZES.index(f"{block_w}x{block_h}")
    if hdr:
        vk = 1000066000 + idx
    else:
        vk = 157 + idx * 2 + (1 if srgb else 0)
    return _write_ktx2_blocks(
        base_width=base_width, base_height=base_height,
        level_count=level_count, layer_count=layer_count,
        face_count=face_count, slice_blocks=slice_blocks,
        slice_info=slice_info,
        dfd=astc_dfd(srgb, block_w, block_h, hdr=hdr), vk_format=vk,
        zstd_level=zstd_level, supercompression=supercompression,
        key_values=key_values, block_w=block_w, block_h=block_h)


def uastc_hdr_6x6i_dfd() -> bytes:
    """Matches the reference's UASTC HDR 6x6 intermediate DFD byte-for-byte
    (model 168, linear, 6x6 texel block, one 128-bit FLOAT sample)."""
    channels = [(0, 127, 0x80, 0, 0x3F800000)]
    return make_dfd(168, block_w=6, block_h=6, bytes_per_block=16,
                    srgb=False, channels=channels)


def write_ktx2_uastc_hdr_6x6i(
    *, base_width: int, base_height: int,
    stream: bytes, key_values: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """UASTC HDR 6x6 intermediate KTX2: vk_format 0, supercompression
    scheme 4 (the intermediate stream is its own supercompression)."""
    # SGD: one std slice offset/len desc per image:
    # (offset-in-level, length, profile = the stream's 16-bit signature)
    sig = struct.unpack_from("<H", stream, 0)[0]
    sgd = struct.pack("<3I", 0, len(stream), sig)
    return _write_ktx2_blocks(
        base_width=base_width, base_height=base_height,
        level_count=1, layer_count=1, face_count=1,
        slice_blocks=[stream],
        slice_info=[dict(level=0, layer=0, face=0)],
        dfd=uastc_hdr_6x6i_dfd(), vk_format=0,
        zstd_level=0, supercompression=False,
        key_values=key_values, block_w=6, block_h=6,
        scheme_override=4, sgd=sgd)


def xuastc_ldr_dfd(srgb: bool, block_w: int, block_h: int) -> bytes:
    """XUASTC LDR DFD (model 169, one 128-bit sample, channelType 0) —
    byte-exact vs the reference's -ldr_*i KTX2 output."""
    channels = [(0, 127, 0x00, 0, 0xFFFFFFFF)]
    return make_dfd(KDF_MODEL_XUASTC_LDR, block_w=block_w, block_h=block_h,
                    bytes_per_block=16, srgb=srgb, channels=channels)


def _xu_sgd(slice_blocks: List[bytes], slice_info: List[dict],
            level_count: int, sig: Optional[int] = None) -> bytes:
    """XUASTC/XUBC7 SGD: one (offset-within-level, length, signature) desc
    per slice, ordered level-major (the order the reference's -tex_array /
    -mipmap KTX2 output carries them). sig None = first-u16 of each stream
    (XUASTC); a fixed value (0x1B7) for XUBC7."""
    level_ofs = [0] * max(1, level_count)
    sgd = b""
    for data, info in zip(slice_blocks, slice_info):
        s = struct.unpack_from("<H", data, 0)[0] if sig is None else sig
        sgd += struct.pack("<3I", level_ofs[info["level"]], len(data), s)
        level_ofs[info["level"]] += len(data)
    return sgd


def write_ktx2_xuastc(
    *, base_width: int, base_height: int, stream: Optional[bytes] = None,
    block_w: int, block_h: int, srgb: bool = True,
    key_values: Optional[Dict[str, bytes]] = None,
    slice_blocks: Optional[List[bytes]] = None,
    slice_info: Optional[List[dict]] = None,
    level_count: int = 1, layer_count: int = 1, face_count: int = 1,
) -> bytes:
    """XUASTC LDR KTX2: vk_format 0, supercompression scheme 5, SGD =
    per-slice (offset, length, first-u16-signature) descs. Single-image
    callers pass stream=; arrays/mips/cubemaps pass slice_blocks +
    slice_info in level-major order."""
    if slice_blocks is None:
        slice_blocks = [stream]
        slice_info = [dict(level=0, layer=0, face=0)]
    sgd = _xu_sgd(slice_blocks, slice_info, level_count)
    return _write_ktx2_blocks(
        base_width=base_width, base_height=base_height,
        level_count=level_count, layer_count=layer_count,
        face_count=face_count,
        slice_blocks=slice_blocks, slice_info=slice_info,
        dfd=xuastc_ldr_dfd(srgb, block_w, block_h), vk_format=0,
        zstd_level=0, supercompression=False,
        key_values=key_values, block_w=block_w, block_h=block_h,
        scheme_override=5, sgd=sgd)


def xubc7_dfd(srgb: bool) -> bytes:
    """XUBC7 DFD (model 170, 4x4, one 128-bit sample, channelType 0) —
    byte-exact vs the reference's -xubc7 KTX2 output."""
    channels = [(0, 127, 0x00, 0, 0xFFFFFFFF)]
    return make_dfd(KDF_MODEL_XUBC7, block_w=4, block_h=4,
                    bytes_per_block=16, srgb=srgb, channels=channels)


def write_ktx2_xubc7(
    *, base_width: int, base_height: int, stream: Optional[bytes] = None,
    srgb: bool = True,
    key_values: Optional[Dict[str, bytes]] = None,
    slice_blocks: Optional[List[bytes]] = None,
    slice_info: Optional[List[dict]] = None,
    level_count: int = 1, layer_count: int = 1, face_count: int = 1,
) -> bytes:
    """XUBC7 KTX2: vk_format 0, supercompression scheme 6, SGD = per-slice
    (offset, length, 0x1B7) descs — 0x1B7 is the constant signature the
    reference writes."""
    if slice_blocks is None:
        slice_blocks = [stream]
        slice_info = [dict(level=0, layer=0, face=0)]
    sgd = _xu_sgd(slice_blocks, slice_info, level_count, sig=0x1B7)
    return _write_ktx2_blocks(
        base_width=base_width, base_height=base_height,
        level_count=level_count, layer_count=layer_count,
        face_count=face_count,
        slice_blocks=slice_blocks, slice_info=slice_info,
        dfd=xubc7_dfd(srgb), vk_format=0,
        zstd_level=0, supercompression=False,
        key_values=key_values, block_w=4, block_h=4,
        scheme_override=6, sgd=sgd)


def write_ktx2_uastc_hdr(
    *, base_width: int, base_height: int, level_count: int,
    layer_count: int, face_count: int,
    slice_blocks: List[bytes], slice_info: List[dict],
    zstd_level: int = 6, supercompression: bool = True,
    key_values: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """UASTC HDR 4x4 KTX2: vk_format ASTC_4x4_SFLOAT (1000066000),
    optional Zstandard supercompression."""
    return _write_ktx2_blocks(
        base_width=base_width, base_height=base_height,
        level_count=level_count, layer_count=layer_count,
        face_count=face_count, slice_blocks=slice_blocks,
        slice_info=slice_info, dfd=uastc_hdr_4x4_dfd(),
        vk_format=1000066000,  # KTX2_FORMAT_ASTC_4x4_SFLOAT_BLOCK
        zstd_level=zstd_level, supercompression=supercompression,
        key_values=key_values)


def write_ktx2_uastc(
    *, base_width: int, base_height: int, level_count: int,
    layer_count: int, face_count: int,
    slice_blocks: List[bytes],            # raw UASTC block bytes per slice
    slice_info: List[dict],               # {level, layer, face}
    srgb: bool = True, has_alpha: bool = False,
    zstd_level: int = 6, supercompression: bool = True,
    key_values: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """Assemble a UASTC LDR 4x4 .KTX2 (optional Zstandard supercompression,
    basisu_comp.cpp create_ktx2_file UASTC path)."""
    return _write_ktx2_blocks(
        base_width=base_width, base_height=base_height,
        level_count=level_count, layer_count=layer_count,
        face_count=face_count, slice_blocks=slice_blocks,
        slice_info=slice_info, dfd=uastc_ldr_4x4_dfd(srgb, has_alpha),
        vk_format=KTX2_VK_FORMAT_UNDEFINED,
        zstd_level=zstd_level, supercompression=supercompression,
        key_values=key_values)


def _write_ktx2_blocks(
    *, base_width: int, base_height: int, level_count: int,
    layer_count: int, face_count: int,
    slice_blocks: List[bytes], slice_info: List[dict], dfd: bytes,
    vk_format: int, zstd_level: int, supercompression: bool,
    key_values: Optional[Dict[str, bytes]],
    block_w: int = 4, block_h: int = 4,
    scheme_override: Optional[int] = None,
    sgd: bytes = b"",
) -> bytes:
    total_levels = max(1, level_count)
    total_layers = max(1, layer_count)
    total_faces = max(1, face_count)
    level_bytes = [bytearray() for _ in range(total_levels)]
    for data, info in zip(slice_blocks, slice_info):
        level_bytes[info["level"]] += data

    scheme = KTX2_SS_NONE if scheme_override is None else scheme_override
    comp_levels = [bytes(lb) for lb in level_bytes]
    if supercompression:
        try:
            import zstandard

            cctx = zstandard.ZstdCompressor(level=zstd_level)
            comp_levels = [cctx.compress(bytes(lb)) for lb in level_bytes]
            scheme = KTX2_SS_ZSTANDARD
        except ImportError:
            pass

    kvs = dict(key_values or {})
    kvs.setdefault("KTXwriter", b"basis_universal_tpu 0.1.0\0")
    kvd = pack_key_values(kvs)

    out = bytearray()
    out += KTX2_IDENTIFIER
    hdr_ofs = len(out)
    out += b"\0" * struct.calcsize(_HDR_FMT)
    li_ofs = len(out)
    out += b"\0" * (24 * total_levels)
    dfd_ofs = len(out)
    out += dfd
    kvd_ofs = len(out)
    out += kvd
    sgd_ofs = 0
    if sgd:
        sgd_ofs = len(out)
        out += sgd
    if scheme == KTX2_SS_NONE:
        _align(out, 16)

    li = [None] * total_levels
    for lvl in range(total_levels - 1, -1, -1):
        bo = len(out)
        out += comp_levels[lvl]
        li[lvl] = (bo, len(comp_levels[lvl]),
                   len(level_bytes[lvl]) if scheme == KTX2_SS_ZSTANDARD else 0)
    for i, (bo, bl, ul) in enumerate(li):
        struct.pack_into("<3Q", out, li_ofs + 24 * i, bo, bl, ul)
    struct.pack_into(
        _HDR_FMT, out, hdr_ofs,
        vk_format, 1, base_width, base_height,
        0, layer_count if layer_count > 1 else 0, total_faces, total_levels,
        scheme, dfd_ofs, len(dfd), kvd_ofs, len(kvd),
        sgd_ofs, len(sgd))
    return bytes(out)


def _align(buf: bytearray, a: int):
    while len(buf) % a:
        buf.append(0)


def pack_key_values(kvs: Dict[str, bytes]) -> bytes:
    out = bytearray()
    for key in sorted(kvs):
        val = kvs[key]
        kb = key.encode() + b"\0"
        out += struct.pack("<I", len(kb) + len(val))
        out += kb + val
        _align(out, 4)
    return bytes(out)


@dataclasses.dataclass
class Ktx2Level:
    byte_offset: int
    byte_length: int
    uncompressed_byte_length: int


@dataclasses.dataclass
class Ktx2EtcS1ImageDesc:
    image_flags: int
    rgb_slice_byte_offset: int
    rgb_slice_byte_length: int
    alpha_slice_byte_offset: int
    alpha_slice_byte_length: int


class Ktx2File:
    """Parsed KTX2 (reader side of ktx2_transcoder::init,
    transcoder/basisu_transcoder.cpp:~20000)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        if self.data[:12] != KTX2_IDENTIFIER:
            raise ValueError("bad KTX2 identifier")
        fields = struct.unpack_from(_HDR_FMT, self.data, 12)
        (self.vk_format, self.type_size, self.pixel_width, self.pixel_height,
         self.pixel_depth, self.layer_count, self.face_count, self.level_count,
         self.supercompression_scheme, self.dfd_byte_offset, self.dfd_byte_length,
         self.kvd_byte_offset, self.kvd_byte_length,
         self.sgd_byte_offset, self.sgd_byte_length) = fields
        ofs = 12 + struct.calcsize(_HDR_FMT)
        self.levels: List[Ktx2Level] = []
        for i in range(max(1, self.level_count)):
            bo, bl, ul = struct.unpack_from("<3Q", self.data, ofs)
            self.levels.append(Ktx2Level(bo, bl, ul))
            ofs += 24
        self.key_values = self._parse_kvd()
        self.dfd = self.data[self.dfd_byte_offset:
                             self.dfd_byte_offset + self.dfd_byte_length]

    def _parse_kvd(self) -> Dict[str, bytes]:
        out = {}
        p = self.kvd_byte_offset
        end = p + self.kvd_byte_length
        while p + 4 <= end:
            (n,) = struct.unpack_from("<I", self.data, p)
            p += 4
            blob = self.data[p:p + n]
            z = blob.find(b"\0")
            if z > 0:
                out[blob[:z].decode(errors="replace")] = blob[z + 1:]
            p += n
            p += (4 - (p & 3)) & 3
        return out

    @property
    def dfd_color_model(self) -> int:
        return self.dfd[12] if len(self.dfd) >= 13 else 0

    @property
    def is_srgb(self) -> bool:
        return len(self.dfd) >= 15 and self.dfd[14] == KDF_TRANSFER_SRGB

    def basis_tex_format(self) -> Optional[BasisTexFormat]:
        m = self.dfd_color_model
        if m == KDF_MODEL_ETC1S:
            return BasisTexFormat.ETC1S
        if m == KDF_MODEL_UASTC_LDR_4X4:
            return BasisTexFormat.UASTC_LDR_4x4
        if m == KDF_MODEL_UASTC_HDR_4X4:
            return BasisTexFormat.UASTC_HDR_4x4
        if m == 168:  # UASTC HDR 6x6 intermediate (supercompression scheme 4)
            return BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE
        if m == KDF_MODEL_XUBC7:
            return BasisTexFormat.XUBC7
        if m == KDF_MODEL_XUASTC_LDR:
            # block size lives in the XUASTC container's bit header
            from ..codecs.astc import xuastc_ldr

            bw, bh = xuastc_ldr.probe_block_size(self.level_data(0))
            return getattr(BasisTexFormat, f"XUASTC_LDR_{bw}x{bh}")
        # standard ASTC payloads are identified by VkFormat
        if self.vk_format == 1000066004:  # ASTC_6x6_SFLOAT
            return BasisTexFormat.ASTC_HDR_6x6
        if 157 <= self.vk_format <= 184:  # ASTC_*_UNORM/SRGB pairs
            sizes = ["4x4", "5x4", "5x5", "6x5", "6x6", "8x5", "8x6",
                     "8x8", "10x5", "10x6", "10x8", "10x10", "12x10",
                     "12x12"]
            name = sizes[(self.vk_format - 157) // 2]
            return getattr(BasisTexFormat, f"ASTC_LDR_{name}")
        return None

    def level_data(self, level: int) -> bytes:
        li = self.levels[level]
        raw = self.data[li.byte_offset:li.byte_offset + li.byte_length]
        if self.supercompression_scheme == KTX2_SS_ZSTANDARD:
            import zstandard

            return zstandard.ZstdDecompressor().decompress(
                raw, max_output_size=li.uncompressed_byte_length)
        return raw

    def xu_slice_descs(self) -> List[tuple]:
        """XUASTC/XUBC7 SGD: [(offset-within-level, length, sig)] per slice,
        level-major (level, layer, face) order — the layout the reference's
        -tex_array/-mipmap/-cubemap KTX2 output carries."""
        sgd = self.data[self.sgd_byte_offset:
                        self.sgd_byte_offset + self.sgd_byte_length]
        return [struct.unpack_from("<3I", sgd, i * 12)
                for i in range(len(sgd) // 12)]

    # --- ETC1S (BasisLZ) global data ---
    def etc1s_global_data(self):
        """Returns (num_endpoints, num_selectors, endpoints, selectors,
        tables, [image_descs per level*layer*face])."""
        if self.supercompression_scheme != KTX2_SS_BASISLZ:
            raise ValueError("not a BasisLZ/ETC1S file")
        p = self.sgd_byte_offset
        (ne, ns, ebl, sbl, tbl, xbl) = struct.unpack_from("<HHIIII", self.data, p)
        p += 20
        num_images = max(1, self.level_count) * max(1, self.layer_count) * max(1, self.face_count)
        descs = []
        for _ in range(num_images):
            vals = struct.unpack_from("<5I", self.data, p)
            descs.append(Ktx2EtcS1ImageDesc(*vals))
            p += 20
        endpoints = self.data[p:p + ebl]; p += ebl
        selectors = self.data[p:p + sbl]; p += sbl
        tables = self.data[p:p + tbl]; p += tbl
        return ne, ns, endpoints, selectors, tables, descs


def write_ktx2_etc1s(
    *, base_width: int, base_height: int, level_count: int,
    layer_count: int, face_count: int,
    slice_streams: List[bytes],           # per slice, in .basis slice order
    slice_info: List[dict],               # {level, layer, face, alpha, iframe}
    endpoint_palette: bytes, selector_palette: bytes, tables: bytes,
    num_endpoints: int, num_selectors: int,
    srgb: bool = True, has_alpha: bool = False, is_video: bool = False,
    key_values: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """Assemble an ETC1S .KTX2 file (BasisLZ supercompression)."""
    total_levels = max(1, level_count)
    total_layers = max(1, layer_count)
    total_faces = max(1, face_count)

    level_bytes = [bytearray() for _ in range(total_levels)]
    num_images = total_levels * total_layers * total_faces
    descs = [[0, 0, 0, 0, 0] for _ in range(num_images)]
    for data, info in zip(slice_streams, slice_info):
        lvl, layer, face = info["level"], info.get("layer", 0), info.get("face", 0)
        idx = lvl * (total_layers * total_faces) + layer * total_faces + face
        ofs = len(level_bytes[lvl])
        if info.get("alpha"):
            descs[idx][3] = ofs
            descs[idx][4] = len(data)
        else:
            if is_video and not info.get("iframe"):
                descs[idx][0] = KTX2_IMAGE_IS_P_FRAME
            descs[idx][1] = ofs
            descs[idx][2] = len(data)
        level_bytes[lvl] += data

    sgd = bytearray()
    sgd += struct.pack("<HHIIII", num_endpoints, num_selectors,
                       len(endpoint_palette), len(selector_palette),
                       len(tables), 0)
    for d in descs:
        sgd += struct.pack("<5I", *d)
    sgd += endpoint_palette + selector_palette + tables

    dfd = etc1s_dfd(srgb, has_alpha)
    kvs = dict(key_values or {})
    kvs.setdefault("KTXwriter", b"basis_universal_tpu 0.1.0\0")
    kvd = pack_key_values(kvs)

    out = bytearray()
    out += KTX2_IDENTIFIER
    hdr_ofs = len(out)
    out += b"\0" * struct.calcsize(_HDR_FMT)
    li_ofs = len(out)
    out += b"\0" * (24 * total_levels)
    dfd_ofs = len(out)
    out += dfd
    kvd_ofs = len(out)
    out += kvd
    _align(out, 8)
    sgd_ofs = len(out)
    out += sgd

    levels = []
    for lvl in range(total_levels - 1, -1, -1):   # smallest mip first
        bo = len(out)
        out += level_bytes[lvl]
        levels.append((lvl, bo, len(level_bytes[lvl])))
    li = [None] * total_levels
    for lvl, bo, bl in levels:
        li[lvl] = (bo, bl, 0)
    for i, (bo, bl, ul) in enumerate(li):
        struct.pack_into("<3Q", out, li_ofs + 24 * i, bo, bl, ul)

    struct.pack_into(
        _HDR_FMT, out, hdr_ofs,
        KTX2_VK_FORMAT_UNDEFINED, 1, base_width, base_height,
        0, layer_count if layer_count > 1 else 0, total_faces, total_levels,
        KTX2_SS_BASISLZ, dfd_ofs, len(dfd), kvd_ofs, len(kvd),
        sgd_ofs, len(sgd))
    return bytes(out)
