"""Copy of `basis_universal_tpu/formats/basis_file.py`.

.basis container reader/writer.

Byte-level contract from the reference (studied, re-implemented):
  - basis_file_header / basis_slice_desc packed structs:
    transcoder/basisu_file_headers.h:208-252 and :32-48 (pack(1), little-endian)
  - file layout order: header | kv-data | slice descs | endpoint palette |
    selector palette | huffman tables | slice data
    (basisu_file::create_comp_data, encoder/basisu_basis_file.cpp:157-196)
  - CRC fixups: basisu_file::fixup_crcs (encoder/basisu_basis_file.cpp:198-210)
  - file version 0x13 (encoder/basisu_basis_file.cpp:19)
"""

import dataclasses
import struct
from typing import List, Optional

from ..utils.crc import crc16
from .constants import BasisTexFormat, BasisTextureType, HeaderFlags, SliceDescFlags

BASIS_SIG = (ord("B") << 8) | ord("s")
BASIS_VERSION = 0x13
HEADER_SIZE = 77
SLICE_DESC_SIZE = 23


def _u(data: bytes, ofs: int, nbytes: int) -> int:
    return int.from_bytes(data[ofs:ofs + nbytes], "little")


def _p(value: int, nbytes: int) -> bytes:
    return int(value).to_bytes(nbytes, "little")


@dataclasses.dataclass
class SliceDesc:
    image_index: int = 0
    level_index: int = 0
    flags: int = 0
    orig_width: int = 0
    orig_height: int = 0
    num_blocks_x: int = 0
    num_blocks_y: int = 0
    file_ofs: int = 0
    file_size: int = 0
    slice_data_crc16: int = 0

    @property
    def has_alpha(self) -> bool:
        return bool(self.flags & SliceDescFlags.HAS_ALPHA)

    @property
    def is_iframe(self) -> bool:
        return bool(self.flags & SliceDescFlags.FRAME_IS_IFRAME)

    @classmethod
    def parse(cls, data: bytes, ofs: int) -> "SliceDesc":
        return cls(
            image_index=_u(data, ofs + 0, 3),
            level_index=_u(data, ofs + 3, 1),
            flags=_u(data, ofs + 4, 1),
            orig_width=_u(data, ofs + 5, 2),
            orig_height=_u(data, ofs + 7, 2),
            num_blocks_x=_u(data, ofs + 9, 2),
            num_blocks_y=_u(data, ofs + 11, 2),
            file_ofs=_u(data, ofs + 13, 4),
            file_size=_u(data, ofs + 17, 4),
            slice_data_crc16=_u(data, ofs + 21, 2),
        )

    def pack(self) -> bytes:
        return b"".join([
            _p(self.image_index, 3), _p(self.level_index, 1), _p(self.flags, 1),
            _p(self.orig_width, 2), _p(self.orig_height, 2),
            _p(self.num_blocks_x, 2), _p(self.num_blocks_y, 2),
            _p(self.file_ofs, 4), _p(self.file_size, 4),
            _p(self.slice_data_crc16, 2),
        ])


@dataclasses.dataclass
class BasisHeader:
    sig: int = BASIS_SIG
    ver: int = BASIS_VERSION
    header_size: int = HEADER_SIZE
    header_crc16: int = 0
    data_size: int = 0
    data_crc16: int = 0
    total_slices: int = 0
    total_images: int = 0
    tex_format: int = 0
    flags: int = 0
    tex_type: int = 0
    us_per_frame: int = 0
    reserved: int = 0
    userdata0: int = 0
    userdata1: int = 0
    total_endpoints: int = 0
    endpoint_cb_file_ofs: int = 0
    endpoint_cb_file_size: int = 0
    total_selectors: int = 0
    selector_cb_file_ofs: int = 0
    selector_cb_file_size: int = 0
    tables_file_ofs: int = 0
    tables_file_size: int = 0
    slice_desc_file_ofs: int = 0
    extended_file_ofs: int = 0
    extended_file_size: int = 0

    _FIELDS = [
        ("sig", 2), ("ver", 2), ("header_size", 2), ("header_crc16", 2),
        ("data_size", 4), ("data_crc16", 2),
        ("total_slices", 3), ("total_images", 3),
        ("tex_format", 1), ("flags", 2), ("tex_type", 1), ("us_per_frame", 3),
        ("reserved", 4), ("userdata0", 4), ("userdata1", 4),
        ("total_endpoints", 2), ("endpoint_cb_file_ofs", 4), ("endpoint_cb_file_size", 3),
        ("total_selectors", 2), ("selector_cb_file_ofs", 4), ("selector_cb_file_size", 3),
        ("tables_file_ofs", 4), ("tables_file_size", 4),
        ("slice_desc_file_ofs", 4),
        ("extended_file_ofs", 4), ("extended_file_size", 4),
    ]

    @classmethod
    def parse(cls, data: bytes) -> "BasisHeader":
        h = cls()
        ofs = 0
        for name, n in cls._FIELDS:
            setattr(h, name, _u(data, ofs, n))
            ofs += n
        assert ofs == HEADER_SIZE
        return h

    def pack(self) -> bytes:
        out = b"".join(_p(getattr(self, name), n) for name, n in self._FIELDS)
        assert len(out) == HEADER_SIZE
        return out


class BasisFile:
    """Parsed .basis file with section accessors + integrity validation."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        if len(self.data) < HEADER_SIZE:
            raise ValueError("file too small")
        self.header = BasisHeader.parse(self.data)
        if self.header.sig != BASIS_SIG:
            raise ValueError("bad signature")
        if self.header.header_size != HEADER_SIZE:
            raise ValueError("bad header size")
        self.slices: List[SliceDesc] = []
        ofs = self.header.slice_desc_file_ofs
        for _ in range(self.header.total_slices):
            self.slices.append(SliceDesc.parse(self.data, ofs))
            ofs += SLICE_DESC_SIZE

    def validate_crcs(self) -> bool:
        """Header + data CRCs (basisu_transcoder::validate_file_checksums).

        Note: slice_data_crc16 is the CRC of the *unpacked* slice texture
        (physical GPU blocks), computed by the encoder backend
        (encoder/basisu_backend.cpp:664) — it cannot be checked without
        decoding, see tests for the decode-side check.
        """
        h = self.header
        # header CRC covers bytes from m_data_size to the end of the header
        if crc16(self.data[8:HEADER_SIZE]) != h.header_crc16:
            return False
        if crc16(self.data[HEADER_SIZE:HEADER_SIZE + h.data_size]) != h.data_crc16:
            return False
        return True

    @property
    def tex_format(self) -> BasisTexFormat:
        return BasisTexFormat(self.header.tex_format)

    @property
    def endpoint_cb_data(self) -> bytes:
        h = self.header
        return self.data[h.endpoint_cb_file_ofs:h.endpoint_cb_file_ofs + h.endpoint_cb_file_size]

    @property
    def selector_cb_data(self) -> bytes:
        h = self.header
        return self.data[h.selector_cb_file_ofs:h.selector_cb_file_ofs + h.selector_cb_file_size]

    @property
    def tables_data(self) -> bytes:
        h = self.header
        return self.data[h.tables_file_ofs:h.tables_file_ofs + h.tables_file_size]

    def slice_data(self, i: int) -> bytes:
        s = self.slices[i]
        return self.data[s.file_ofs:s.file_ofs + s.file_size]


def write_basis_file(
    tex_format: BasisTexFormat,
    slice_descs: List[SliceDesc],
    slice_data: List[bytes],
    *,
    endpoint_palette: bytes = b"",
    selector_palette: bytes = b"",
    tables: bytes = b"",
    num_endpoints: int = 0,
    num_selectors: int = 0,
    tex_type: BasisTextureType = BasisTextureType.TEX_2D,
    flags: int = 0,
    us_per_frame: int = 0,
    userdata0: int = 0,
    userdata1: int = 0,
    kv_data: bytes = b"",
) -> bytes:
    """Assemble a complete .basis file (layout per basisu_basis_file.cpp)."""
    assert len(slice_descs) == len(slice_data)
    h = BasisHeader()
    h.tex_format = int(tex_format)
    h.tex_type = int(tex_type)
    h.flags = int(flags)
    h.us_per_frame = us_per_frame
    h.userdata0 = userdata0
    h.userdata1 = userdata1
    h.total_slices = len(slice_descs)
    h.total_images = max((s.image_index + 1 for s in slice_descs), default=0)
    h.total_endpoints = num_endpoints
    h.total_selectors = num_selectors

    ofs = HEADER_SIZE
    if kv_data:
        h.extended_file_ofs = ofs
        h.extended_file_size = len(kv_data)
        ofs += len(kv_data)
    h.slice_desc_file_ofs = ofs
    ofs += SLICE_DESC_SIZE * len(slice_descs)
    if endpoint_palette:
        h.endpoint_cb_file_ofs = ofs
        h.endpoint_cb_file_size = len(endpoint_palette)
        ofs += len(endpoint_palette)
    if selector_palette:
        h.selector_cb_file_ofs = ofs
        h.selector_cb_file_size = len(selector_palette)
        ofs += len(selector_palette)
    if tables:
        h.tables_file_ofs = ofs
        h.tables_file_size = len(tables)
        ofs += len(tables)
    for sd, data in zip(slice_descs, slice_data):
        sd.file_ofs = ofs
        sd.file_size = len(data)
        # sd.slice_data_crc16 is the caller's CRC of the *unpacked* slice
        # texture (see basisu_backend.cpp:664), not of `data`.
        ofs += len(data)

    total = ofs
    h.data_size = total - HEADER_SIZE
    body = b"".join(
        [kv_data]
        + [sd.pack() for sd in slice_descs]
        + [endpoint_palette, selector_palette, tables]
        + list(slice_data)
    )
    assert len(body) == h.data_size
    h.data_crc16 = crc16(body)
    hdr_no_crc = h.pack()
    h.header_crc16 = crc16(hdr_no_crc[8:])
    return h.pack() + body
