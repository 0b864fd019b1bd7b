"""The .basis and .KTX2 containers, read in plain Python.

A frozen reading of the layouts the port writes (the reference encoder's
`basisu_file_headers.h` and `basisu_transcoder.h`): the .basis header and
slice descriptors, its CRC-16s, and the KTX2 header, level index, DFD and
the ETC1S (BasisLZ) supercompression global data.
"""

import binascii
import struct

BASIS_SIG = (ord("B") << 8) | ord("s")
BASIS_VERSION = 0x13
HEADER_SIZE = 77
SLICE_DESC_SIZE = 23

FORMAT_ETC1S = 0
FORMAT_UASTC_LDR_4x4 = 1

HEADER_FLAG_ETC1S = 1
HEADER_FLAG_HAS_ALPHA_SLICES = 4
HEADER_FLAG_USES_GLOBAL_CODEBOOK = 8
SLICE_FLAG_HAS_ALPHA = 1

KTX2_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB,
                         0x0D, 0x0A, 0x1A, 0x0A])
KTX2_HEADER = "<13I2Q"
KTX2_SS_NONE = 0
KTX2_SS_BASISLZ = 1
KTX2_SS_ZSTANDARD = 2
KDF_MODEL_ETC1S = 163
KDF_MODEL_UASTC_LDR_4X4 = 166

_HEADER_FIELDS = (
    ("sig", 2), ("ver", 2), ("header_size", 2), ("header_crc16", 2),
    ("data_size", 4), ("data_crc16", 2), ("total_slices", 3),
    ("total_images", 3), ("tex_format", 1), ("flags", 2), ("tex_type", 1),
    ("us_per_frame", 3), ("reserved", 4), ("userdata0", 4), ("userdata1", 4),
    ("total_endpoints", 2), ("endpoint_cb_file_ofs", 4),
    ("endpoint_cb_file_size", 3), ("total_selectors", 2),
    ("selector_cb_file_ofs", 4), ("selector_cb_file_size", 3),
    ("tables_file_ofs", 4), ("tables_file_size", 4),
    ("slice_desc_file_ofs", 4), ("extended_file_ofs", 4),
    ("extended_file_size", 4))
_SLICE_FIELDS = (
    ("image_index", 3), ("level_index", 1), ("flags", 1), ("orig_width", 2),
    ("orig_height", 2), ("num_blocks_x", 2), ("num_blocks_y", 2),
    ("file_ofs", 4), ("file_size", 4), ("slice_data_crc16", 2))


class FormatError(ValueError):
    """A file that breaks its container's rules."""


def crc16(data, crc: int = 0) -> int:
    """The .basis CRC-16: CRC-16/XMODEM between two complements
    (basisu_transcoder.cpp `crc16`)."""
    return (~binascii.crc_hqx(bytes(data), (~crc) & 0xFFFF)) & 0xFFFF


def _fields(data: bytes, ofs: int, fields) -> dict:
    out = {}
    for name, n in fields:
        out[name] = int.from_bytes(data[ofs:ofs + n], "little")
        ofs += n
    return out


class Basis:
    """A parsed .basis file; raises FormatError where the header, its CRCs
    or a section's place in the file are wrong."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        if len(self.data) < HEADER_SIZE:
            raise FormatError("file shorter than its header")
        h = _fields(self.data, 0, _HEADER_FIELDS)
        self.header = h
        if h["sig"] != BASIS_SIG or h["ver"] != BASIS_VERSION \
                or h["header_size"] != HEADER_SIZE:
            raise FormatError("bad signature, version or header size")
        if HEADER_SIZE + h["data_size"] != len(self.data):
            raise FormatError("data size disagrees with the file's length")
        if crc16(self.data[8:HEADER_SIZE]) != h["header_crc16"]:
            raise FormatError("header CRC-16")
        if crc16(self.data[HEADER_SIZE:]) != h["data_crc16"]:
            raise FormatError("data CRC-16")
        self.slices = []
        ofs = h["slice_desc_file_ofs"]
        for _ in range(h["total_slices"]):
            if ofs + SLICE_DESC_SIZE > len(self.data):
                raise FormatError("slice descriptor past the end")
            s = _fields(self.data, ofs, _SLICE_FIELDS)
            if s["file_ofs"] + s["file_size"] > len(self.data):
                raise FormatError("slice data past the end")
            self.slices.append(s)
            ofs += SLICE_DESC_SIZE

    def section(self, name: str) -> bytes:
        ofs = self.header[f"{name}_file_ofs"]
        size = self.header[f"{name}_file_size"]
        if ofs + size > len(self.data):
            raise FormatError(f"{name} past the end")
        return self.data[ofs:ofs + size]

    def slice_data(self, i: int) -> bytes:
        s = self.slices[i]
        return self.data[s["file_ofs"]:s["file_ofs"] + s["file_size"]]


class Ktx2:
    """A parsed KTX2 file (header, level index, DFD colour model)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        if self.data[:12] != KTX2_IDENTIFIER:
            raise FormatError("bad KTX2 identifier")
        (self.vk_format, self.type_size, self.width, self.height, self.depth,
         self.layer_count, self.face_count, self.level_count,
         self.supercompression, self.dfd_ofs, self.dfd_len, self.kvd_ofs,
         self.kvd_len, self.sgd_ofs, self.sgd_len) = struct.unpack_from(
             KTX2_HEADER, self.data, 12)
        ofs = 12 + struct.calcsize(KTX2_HEADER)
        self.levels = []
        for _ in range(max(1, self.level_count)):
            self.levels.append(struct.unpack_from("<3Q", self.data, ofs))
            ofs += 24
        for start, length in ((self.dfd_ofs, self.dfd_len),
                              (self.sgd_ofs, self.sgd_len),
                              *((bo, bl) for bo, bl, _ in self.levels)):
            if start + length > len(self.data):
                raise FormatError("KTX2 section past the end")
        dfd = self.data[self.dfd_ofs:self.dfd_ofs + self.dfd_len]
        self.color_model = dfd[12] if len(dfd) > 12 else -1

    def level_data(self, level: int) -> bytes:
        bo, bl, ul = self.levels[level]
        raw = self.data[bo:bo + bl]
        if self.supercompression == KTX2_SS_ZSTANDARD:
            import zstandard

            try:
                return zstandard.ZstdDecompressor().decompress(
                    raw, max_output_size=ul)
            except zstandard.ZstdError as e:
                raise FormatError(f"KTX2 level {level}: {e}") from e
        return raw

    def etc1s_global_data(self):
        """(endpoint count, selector count, endpoint palette, selector
        palette, tables, [(flags, rgb ofs, rgb len, alpha ofs, alpha len)]
        per image)."""
        p = self.sgd_ofs
        ne, ns, ebl, sbl, tbl, xbl = struct.unpack_from("<HHIIII", self.data,
                                                        p)
        p += 20
        n_images = (max(1, self.level_count) * max(1, self.layer_count)
                    * max(1, self.face_count))
        descs = []
        for _ in range(n_images):
            descs.append(struct.unpack_from("<5I", self.data, p))
            p += 20
        endpoints = self.data[p:p + ebl]
        p += ebl
        selectors = self.data[p:p + sbl]
        p += sbl
        tables = self.data[p:p + tbl]
        if p + tbl + xbl > self.sgd_ofs + self.sgd_len:
            raise FormatError("ETC1S global data past its length")
        return ne, ns, endpoints, selectors, tables, descs
