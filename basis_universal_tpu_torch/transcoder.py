"""Copy of `basis_universal_tpu/transcoder.py`.

High-level transcoder API: .basis/.KTX2 → GPU block formats / rasters.

API mirrors the reference's basisu_transcoder / ktx2_transcoder
(transcoder/basisu_transcoder.h:860, :1256): parse the container, decode the
ETC1S codebooks once (start_transcoding), then transcode any (image, level)
to a target format. The entropy layer runs on host; per-block format
conversion is batched array work (ops/transcode.py).

Two conversions re-encode decoded pixels, and run on a torch device: the
ETC1 target (`UastcTranscodeEngine._reencode_etc1`, an ETC1S
`encode_blocks` at radius 1, also the colour half of ETC2_RGBA) and the
ASTC 4x4 re-encode (the UASTC encoder at effort 2). Every engine that
reaches them (UASTC LDR 4x4, XUBC7, ASTC LDR, XUASTC LDR, DDS) takes the
`device` of its transcoder, "cuda" unless the caller asks for the CPU.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .codecs.etc1s import stream as etc1s_stream
from .codecs.etc1s.frontend import resolve_device
from .formats import basis_file, ktx2
from .formats.constants import (
    BasisTexFormat,
    BasisTextureType,
    HeaderFlags,
    TranscoderTextureFormat as TF,
)
from .ops import etc1 as etc1_ops
from .utils.errors import guard_parse
from .ops import etc1s_encode
from .ops import transcode as tc_ops


@dataclasses.dataclass
class ImageLevelInfo:
    orig_width: int
    orig_height: int
    num_blocks_x: int
    num_blocks_y: int
    has_alpha: bool


class _Etc1sDecodedSlice:
    def __init__(self, endpoint_idx, selector_idx):
        self.endpoint_idx = endpoint_idx
        self.selector_idx = selector_idx


class Etc1sTranscodeEngine:
    """Shared ETC1S decode + format conversion used by both containers."""

    def __init__(self, num_endpoints, endpoints_data, num_selectors,
                 selectors_data, tables_data):
        self.num_endpoints = num_endpoints
        self.num_selectors = num_selectors
        self.codebooks = etc1s_stream.decode_palettes(
            num_endpoints, endpoints_data, num_selectors, selectors_data)
        self.tables = etc1s_stream.decode_tables(tables_data)

    @classmethod
    def from_codebooks(cls, codebooks, tables_data):
        self = cls.__new__(cls)
        self.codebooks = codebooks
        self.num_endpoints = codebooks.color5.shape[0]
        self.num_selectors = codebooks.selectors.shape[0]
        self.tables = etc1s_stream.decode_tables(tables_data)
        return self

    def decode_slice(self, data, nbx, nby, is_video=False, prev=None):
        return etc1s_stream.decode_slice(
            data, nbx, nby, self.tables, self.num_endpoints,
            self.num_selectors, is_video=is_video, prev_frame_indices=prev)

    def convert(self, fmt: TF, rgb: _Etc1sDecodedSlice,
                alpha: Optional[_Etc1sDecodedSlice],
                orig_width: int, orig_height: int) -> np.ndarray:
        cb = self.codebooks
        c5, i5, sels = cb.color5, cb.inten5, cb.selectors
        e, s = rgb.endpoint_idx, rgb.selector_idx
        ae = alpha.endpoint_idx if alpha else None
        asel = alpha.selector_idx if alpha else None

        if fmt == TF.RGBA32:
            blocks = etc1_ops.decode_blocks_to_rgba(e, s, c5, i5, sels, ae, asel)
            return etc1_ops.blocks_to_image(blocks, orig_width, orig_height)
        if fmt in (TF.RGB565, TF.BGR565, TF.RGBA4444):
            blocks = etc1_ops.decode_blocks_to_rgba(e, s, c5, i5, sels, ae, asel)
            img = etc1_ops.blocks_to_image(blocks, orig_width, orig_height)
            if fmt == TF.RGB565:
                return tc_ops.rgba_to_rgb565(img)
            if fmt == TF.BGR565:
                return tc_ops.rgba_to_bgr565(img)
            return tc_ops.rgba_to_rgba4444(img)
        if fmt == TF.ETC1_RGB:
            return etc1_ops.pack_etc1_blocks(e, s, c5, i5, sels)
        if fmt == TF.BC1_RGB:
            return tc_ops.etc1s_to_bc1(e, s, c5, i5, sels)
        if fmt == TF.BC7_RGBA:
            return tc_ops.etc1s_to_bc7_m5(e, s, c5, i5, sels, ae, asel)
        if fmt == TF.BC3_RGBA:
            color = tc_ops.etc1s_to_bc1(e, s, c5, i5, sels)
            by, bx = e.shape
            if alpha is not None:
                avals = tc_ops.etc1s_block_values(ae, asel, c5, i5, sels)
            else:
                avals = np.full((by * bx, 16), 255, dtype=np.int64)
            a = tc_ops.values_to_bc4(avals).reshape(by, bx, 8)
            return np.concatenate([a, color], axis=-1)
        if fmt == TF.BC4_R:
            by, bx = e.shape
            vals = tc_ops.etc1s_block_values(e, s, c5, i5, sels, channel=1)
            return tc_ops.values_to_bc4(vals).reshape(by, bx, 8)
        if fmt == TF.BC5_RG:
            by, bx = e.shape
            r = tc_ops.values_to_bc4(
                tc_ops.etc1s_block_values(e, s, c5, i5, sels, channel=0))
            if alpha is not None:
                g = tc_ops.values_to_bc4(
                    tc_ops.etc1s_block_values(ae, asel, c5, i5, sels, channel=1))
            else:
                g = tc_ops.values_to_bc4(
                    tc_ops.etc1s_block_values(e, s, c5, i5, sels, channel=1))
            return np.concatenate(
                [r.reshape(by, bx, 8), g.reshape(by, bx, 8)], axis=-1)
        if fmt == TF.ASTC_4x4_RGBA:
            from .codecs.uastc import astc_pack

            return astc_pack.etc1s_to_astc(e, s, c5, i5, sels)
        if fmt == TF.ATC_RGB:
            return tc_ops.etc1s_to_atc(e, s, c5, i5, sels)
        if fmt == TF.ATC_RGBA:
            by, bx = e.shape
            color = tc_ops.etc1s_to_atc(e, s, c5, i5, sels)
            if alpha is not None:
                avals = tc_ops.etc1s_block_values(ae, asel, c5, i5, sels)
            else:
                avals = np.full((by * bx, 16), 255, dtype=np.int64)
            a = tc_ops.values_to_bc4(avals).reshape(by, bx, 8)
            return np.concatenate([a, color], axis=-1)
        if fmt == TF.ETC2_EAC_R11:
            by, bx = e.shape
            vals = tc_ops.etc1s_block_values(e, s, c5, i5, sels, channel=0)
            return tc_ops.values_to_eac_r11(vals).reshape(by, bx, 8)
        if fmt == TF.ETC2_EAC_RG11:
            by, bx = e.shape
            r = tc_ops.values_to_eac_r11(
                tc_ops.etc1s_block_values(e, s, c5, i5, sels, channel=0))
            g = tc_ops.values_to_eac_r11(
                tc_ops.etc1s_block_values(e, s, c5, i5, sels, channel=1))
            return np.concatenate([r.reshape(by, bx, 8),
                                   g.reshape(by, bx, 8)], axis=-1)
        if fmt == TF.FXT1_RGB:
            return tc_ops.bc1_to_fxt1(tc_ops.etc1s_to_bc1(e, s, c5, i5, sels))
        if fmt == TF.PVRTC2_4_RGB or (fmt == TF.PVRTC2_4_RGBA and alpha is None):
            from .ops import pvrtc2

            return pvrtc2.etc1s_to_pvrtc2_4_rgb(e, s, c5, i5, sels)
        if fmt == TF.PVRTC2_4_RGBA:
            from .ops import pvrtc2

            return pvrtc2.etc1s_to_pvrtc2_4_rgba(e, s, ae, asel, c5, i5, sels)
        if fmt == TF.PVRTC1_4_RGB:
            from .ops import pvrtc1

            return pvrtc1.etc1s_to_pvrtc1_4_rgb(e, s, c5, i5, sels)
        if fmt == TF.PVRTC1_4_RGBA:
            from .ops import pvrtc1

            if alpha is None:
                raise ValueError("PVRTC1_4_RGBA requires an alpha slice")
            return pvrtc1.etc1s_to_pvrtc1_4_rgba(e, s, ae, asel, c5, i5, sels)
        if fmt == TF.ETC2_RGBA:
            by, bx = e.shape
            color = etc1_ops.pack_etc1_blocks(e, s, c5, i5, sels)
            if alpha is not None:
                avals = tc_ops.etc1s_block_values(ae, asel, c5, i5, sels)
                a = tc_ops.values_to_eac_a8(avals).reshape(by, bx, 8)
            else:
                a = np.zeros((by, bx, 8), dtype=np.uint8)
                a[..., 0] = 255
                a[..., 1] = 0x10  # multiplier 1, table 0, selectors 0 → 255ish
                avals = np.full((by * bx, 16), 255, dtype=np.int64)
                a = tc_ops.values_to_eac_a8(avals).reshape(by, bx, 8)
            return np.concatenate([a, color], axis=-1)
        raise NotImplementedError(f"transcode target {fmt!r} not implemented yet")


class UastcTranscodeEngine:
    """UASTC LDR 4x4 block decode + format conversion; the re-encodes run on
    `device`."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def convert(self, fmt: TF, blocks: np.ndarray, nbx: int, nby: int,
                orig_width: int, orig_height: int) -> np.ndarray:
        from .codecs.uastc import decode as uastc_decode

        if fmt == TF.ASTC_4x4_RGBA:
            from .codecs.uastc import astc_pack

            return astc_pack.uastc_blocks_to_astc(blocks).reshape(nby, nbx, 16)
        rgba = uastc_decode.decode_rgba(blocks)              # (N,4,4,4)
        return self.convert_rgba(fmt, rgba, nbx, nby,
                                 orig_width, orig_height)

    def convert_rgba(self, fmt: TF, rgba: np.ndarray, nbx: int, nby: int,
                     orig_width: int, orig_height: int) -> np.ndarray:
        grid = rgba.reshape(nby, nbx, 4, 4, 4)
        if fmt == TF.RGBA32:
            return etc1_ops.blocks_to_image(grid, orig_width, orig_height)
        if fmt in (TF.RGB565, TF.BGR565, TF.RGBA4444):
            img = etc1_ops.blocks_to_image(grid, orig_width, orig_height)
            if fmt == TF.RGB565:
                return tc_ops.rgba_to_rgb565(img)
            if fmt == TF.BGR565:
                return tc_ops.rgba_to_bgr565(img)
            return tc_ops.rgba_to_rgba4444(img)
        px = rgba.reshape(-1, 16, 4).astype(np.float64)
        if fmt == TF.BC1_RGB:
            return tc_ops.rgba_blocks_to_bc1(px).reshape(nby, nbx, 8)
        if fmt in (TF.BC7_RGBA, TF.BC7_ALT):
            return tc_ops.rgba_blocks_to_bc7_m5(px).reshape(nby, nbx, 16)
        if fmt == TF.BC3_RGBA:
            color = tc_ops.rgba_blocks_to_bc1(px).reshape(nby, nbx, 8)
            a = tc_ops.values_to_bc4(px[..., 3].astype(np.int64)).reshape(nby, nbx, 8)
            return np.concatenate([a, color], axis=-1)
        if fmt == TF.BC4_R:
            return tc_ops.values_to_bc4(px[..., 0].astype(np.int64)).reshape(nby, nbx, 8)
        if fmt == TF.BC5_RG:
            r = tc_ops.values_to_bc4(px[..., 0].astype(np.int64)).reshape(nby, nbx, 8)
            g = tc_ops.values_to_bc4(px[..., 1].astype(np.int64)).reshape(nby, nbx, 8)
            return np.concatenate([r, g], axis=-1)
        if fmt == TF.ETC2_RGBA:
            a = tc_ops.values_to_eac_a8(px[..., 3].astype(np.int64)).reshape(nby, nbx, 8)
            color = self._reencode_etc1(px)
            return np.concatenate([a, color.reshape(nby, nbx, 8)], axis=-1)
        if fmt == TF.ETC1_RGB:
            return self._reencode_etc1(px).reshape(nby, nbx, 8)
        if fmt == TF.ASTC_4x4_RGBA:
            # re-encode path (used when the source isn't 4x4 UASTC blocks)
            from .codecs.uastc import astc_pack
            from .codecs.uastc import encode as uastc_encode

            ub = uastc_encode.encode_blocks(
                rgba.reshape(-1, 16, 4).astype(np.float32),
                effort=2, has_alpha=True, device=self.device)
            return astc_pack.uastc_blocks_to_astc(ub).reshape(nby, nbx, 16)
        if fmt == TF.ETC2_EAC_R11:
            return tc_ops.values_to_eac_r11(
                px[..., 0].astype(np.int64)).reshape(nby, nbx, 8)
        if fmt == TF.ETC2_EAC_RG11:
            r = tc_ops.values_to_eac_r11(px[..., 0].astype(np.int64))
            g = tc_ops.values_to_eac_r11(px[..., 1].astype(np.int64))
            return np.concatenate([r.reshape(nby, nbx, 8),
                                   g.reshape(nby, nbx, 8)], axis=-1)
        if fmt in (TF.PVRTC1_4_RGB, TF.PVRTC1_4_RGBA):
            from .ops import pvrtc1

            return pvrtc1.rgba_blocks_to_pvrtc1(
                grid, has_alpha=(fmt == TF.PVRTC1_4_RGBA))
        if fmt == TF.FXT1_RGB:
            return tc_ops.bc1_to_fxt1(
                tc_ops.rgba_blocks_to_bc1(px).reshape(nby, nbx, 8))
        if fmt in (TF.PVRTC2_4_RGB, TF.PVRTC2_4_RGBA):
            from .ops import pvrtc2

            return pvrtc2.rgba_blocks_to_pvrtc2(
                grid, has_alpha=(fmt == TF.PVRTC2_4_RGBA))
        raise NotImplementedError(f"UASTC transcode target {fmt!r} not implemented yet")

    def _reencode_etc1(self, px):
        """ETC1 blocks (N, 8) of decoded RGBA pixels px (N, 16, 4), re-encoded
        on `self.device`."""
        rgb = torch.as_tensor(np.ascontiguousarray(px[..., :3],
                                                   dtype=np.float32))
        with etc1s_encode.exact_matmuls():
            res = etc1s_encode.encode_blocks(rgb.to(self.device), radius=1)
        got = {k: res[k].cpu().numpy() for k in ("color5", "inten",
                                                 "selectors")}
        n = px.shape[0]
        idx = np.arange(n).reshape(1, n)
        return etc1_ops.pack_etc1_blocks(
            idx, idx, got["color5"].astype(np.uint8),
            got["inten"].astype(np.uint8),
            got["selectors"].astype(np.uint8)).reshape(n, 8)


class AstcHdrTranscodeEngine:
    """UASTC HDR 4x4 / standard ASTC HDR 6x6 (ASTC HDR blocks; the 6x6
    family stores raw blocks exactly like 4x4, just a bigger footprint)."""

    def __init__(self, block_w: int = 4, block_h: int = 4):
        self.bw, self.bh = block_w, block_h

    def convert(self, fmt: TF, blocks: np.ndarray, nbx: int, nby: int,
                orig_width: int, orig_height: int) -> np.ndarray:
        from .codecs.astc import helpers as astc_helpers

        bw, bh = self.bw, self.bh
        if fmt in (TF.ASTC_HDR_4x4_RGBA, TF.ASTC_4x4_RGBA) and (bw, bh) == (4, 4):
            return np.asarray(blocks, dtype=np.uint8).reshape(nby, nbx, 16)
        if fmt == TF.ASTC_HDR_6x6_RGBA and (bw, bh) == (6, 6):
            return np.asarray(blocks, dtype=np.uint8).reshape(nby, nbx, 16)
        half = astc_helpers.decode_blocks_rgba16f(blocks, bw=bw, bh=bh)
        grid = half.reshape(nby, nbx, bh, bw, 4)
        img = grid.transpose(0, 2, 1, 3, 4).reshape(
            nby * bh, nbx * bw, 4)[:orig_height, :orig_width]
        if fmt == TF.RGBA_HALF:
            return img
        if fmt == TF.RGB_HALF:
            return img[..., :3]
        if fmt == TF.RGB_9E5:
            return _half_to_rgb9e5(img[..., :3])
        if fmt == TF.BC6H:
            from .codecs.astc import hdr_encode

            # re-block the decoded halfs on a 4x4 grid
            b4y = -(-orig_height // 4)
            b4x = -(-orig_width // 4)
            pad = np.zeros((b4y * 4, b4x * 4, 3), dtype=np.uint16)
            pad[:img.shape[0], :img.shape[1]] = img[..., :3]
            pad[img.shape[0]:] = pad[img.shape[0] - 1:img.shape[0]] \
                if img.shape[0] < pad.shape[0] else 0
            pad[:, img.shape[1]:] = pad[:, img.shape[1] - 1:img.shape[1]] \
                if img.shape[1] < pad.shape[1] else 0
            b4 = pad.reshape(b4y, 4, b4x, 4, 3).transpose(0, 2, 1, 3, 4)
            return hdr_encode.halfs_to_bc6h(
                b4.reshape(-1, 16, 3)).reshape(b4y, b4x, 16)
        raise NotImplementedError(
            f"ASTC HDR transcode target {fmt!r} not implemented yet")


def _half_to_rgb9e5(half_bits: np.ndarray) -> np.ndarray:
    """(H,W,3) half bits → packed shared-exponent RGB9E5 uint32."""
    f = half_bits.view(np.float16).astype(np.float32)
    f = np.clip(f, 0.0, 65408.0)
    maxc = np.maximum(f[..., 0], np.maximum(f[..., 1], f[..., 2]))
    exp = np.clip(np.floor(np.log2(np.maximum(maxc, 1e-30))) + 1, -15, 16)
    scale = np.exp2(9 - exp)
    m = np.clip(np.round(f * scale[..., None]), 0, 511).astype(np.uint32)
    e = (exp + 15).astype(np.uint32)
    return m[..., 0] | (m[..., 1] << 9) | (m[..., 2] << 18) | (e << 27)


class Hdr6x6IntermediateEngine:
    """UASTC HDR 6x6 INTERMEDIATE (supercompressed stream → logical ASTC
    HDR 6x6 blocks; codecs/astc/hdr6x6_decode.py, bit-exact vs the
    reference's decode_6x6_hdr)."""

    bw = bh = 6

    def convert(self, fmt: TF, data, nbx: int, nby: int,
                orig_width: int, orig_height: int) -> np.ndarray:
        from .codecs.astc import hdr6x6_decode as hd

        if fmt == TF.ASTC_HDR_6x6_RGBA:
            log_blocks, _w, _h = hd.decode_6x6_hdr(bytes(data))
            return hd.pack_log_blocks(log_blocks).reshape(nby, nbx, 16)
        blocks, w, h = hd.decode_blocks_rgba16f(bytes(data))
        grid = blocks.reshape(nby, nbx, 6, 6, 4)
        img = grid.transpose(0, 2, 1, 3, 4).reshape(
            nby * 6, nbx * 6, 4)[:orig_height, :orig_width]
        if fmt == TF.RGBA_HALF:
            return img
        if fmt == TF.RGB_HALF:
            return np.ascontiguousarray(img[..., :3])
        if fmt == TF.RGB_9E5:
            return _half_to_rgb9e5(img[..., :3])
        if fmt == TF.BC6H:
            from .codecs.astc import hdr_encode

            b4y, b4x = -(-orig_height // 4), -(-orig_width // 4)
            pad = np.zeros((b4y * 4, b4x * 4, 3), dtype=np.uint16)
            pad[:img.shape[0], :img.shape[1]] = img[..., :3]
            b4 = pad.reshape(b4y, 4, b4x, 4, 3).transpose(0, 2, 1, 3, 4)
            return hdr_encode.halfs_to_bc6h(
                b4.reshape(-1, 16, 3)).reshape(b4y, b4x, 16)
        raise NotImplementedError(
            f"UASTC HDR 6x6i transcode target {fmt!r} not implemented yet")


class XuastcLdrTranscodeEngine:
    """XUASTC LDR (supercompressed ASTC): decodes the latent stream once per
    level (codecs/astc/xuastc_ldr.decode_log_blocks, parity
    basisu_transcoder.cpp:27633), then serves every target through the
    standard ASTC engine on the reconstructed physical blocks."""

    def __init__(self, srgb: bool, deblock=None, device="cuda"):
        self.srgb = srgb
        self.deblock = deblock
        self.device = resolve_device(device)
        self.bw = self.bh = 4
        self._cache = {}

    def physical_blocks(self, data: bytes):
        key = id(data) if not isinstance(data, bytes) else hash(data)
        if key not in self._cache:
            from .codecs.astc import xuastc_ldr

            c, blocks = xuastc_ldr.decode_astc_physical(data)
            self.bw, self.bh = c.block_w, c.block_h
            self._cache[key] = (c, blocks)
        return self._cache[key]

    def convert(self, fmt: TF, data: bytes, nbx: int, nby: int,
                orig_width: int, orig_height: int) -> np.ndarray:
        c, blocks = self.physical_blocks(data)
        eng = AstcLdrTranscodeEngine(c.block_w, c.block_h,
                                     srgb=c.srgb_decode,
                                     deblock=self.deblock,
                                     device=self.device)
        return eng.convert(fmt, blocks, nbx, nby, orig_width, orig_height)


class Xubc7TranscodeEngine:
    """XUBC7 (supercompressed BC7): latent decode once per level
    (codecs/bc7/xbc7_decode, parity transcoder/basisu_xbc7_decoder.inl),
    then BC7 natively or any other target from the decoded RGBA."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.bw = self.bh = 4
        self._cache = {}

    def _decoded(self, data: bytes):
        key = hash(data)
        if key not in self._cache:
            from .codecs.bc7 import xbc7_decode

            self._cache[key] = xbc7_decode.decode_image(data)
        return self._cache[key]

    def convert(self, fmt: TF, data: bytes, nbx: int, nby: int,
                orig_width: int, orig_height: int) -> np.ndarray:
        from .codecs.bc7 import logical as bc7l

        img, blks = self._decoded(data)
        if fmt == TF.BC7_RGBA:
            out = np.zeros((img.num_blocks_y, img.num_blocks_x, 16),
                           dtype=np.uint8)
            for by in range(img.num_blocks_y):
                for bx in range(img.num_blocks_x):
                    out[by, bx] = np.frombuffer(
                        bc7l.pack_phys(blks[by][bx]), np.uint8)
            return out
        px = np.zeros((img.num_blocks_y * 4, img.num_blocks_x * 4, 4),
                      np.uint8)
        for by in range(img.num_blocks_y):
            for bx in range(img.num_blocks_x):
                px[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                    bc7l.unpack_rgba(blks[by][bx]).reshape(4, 4, 4)
        px = px[:orig_height, :orig_width]
        if fmt == TF.RGBA32:
            return px
        if fmt == TF.RGB565:
            return tc_ops.rgba_to_rgb565(px)
        if fmt == TF.BGR565:
            return tc_ops.rgba_to_bgr565(px)
        if fmt == TF.RGBA4444:
            return tc_ops.rgba_to_rgba4444(px)
        blocks4 = etc1_ops.image_to_blocks(px)
        b4y, b4x = blocks4.shape[:2]
        eng = UastcTranscodeEngine(self.device)
        return eng.convert_rgba(fmt, blocks4.reshape(-1, 4, 4, 4),
                                b4x, b4y, orig_width, orig_height)


class DdsTranscoder:
    """.DDS reader + transcoder (dds_transcoder analog,
    transcoder/basisu_dds_transcoder.inl): BC1-5/BC7/uncompressed inputs,
    mips/arrays/cubemaps, decoded once per image then served to any
    transcode target."""

    @guard_parse
    def __init__(self, data: bytes, device="cuda"):
        from .formats.dds import DdsFile

        self.file = DdsFile(data)
        self.device = resolve_device(device)
        self._cache = {}

    def get_width(self) -> int:
        return self.file.width

    def get_height(self) -> int:
        return self.file.height

    def get_levels(self) -> int:
        return self.file.mips

    def get_layers(self) -> int:
        return self.file.layers

    def get_faces(self) -> int:
        return self.file.faces

    def get_format(self) -> str:
        return self.file.format

    @guard_parse
    def decode_rgba(self, level: int = 0, layer: int = 0,
                    face: int = 0) -> np.ndarray:
        """(H, W, 4) uint8 decode of one image."""
        key = (level, layer, face)
        if key in self._cache:
            return self._cache[key]
        from .ops import gpu_unpack

        im = self.file.image(level, layer, face)
        raw = self.file.image_data(level, layer, face)
        fmt = self.file.format
        w, h = im.width, im.height
        if fmt in ("RGBA8", "BGRA8", "RGB8", "R8", "RG8"):
            c = self.file.bytes_per_unit
            px = np.frombuffer(raw, np.uint8).reshape(h, w, c)
            out = np.zeros((h, w, 4), np.uint8)
            out[..., 3] = 255
            if fmt == "BGRA8":
                out[..., :3] = px[..., 2::-1]
                out[..., 3] = px[..., 3]
            else:
                out[..., :c] = px
        else:
            bx, by = (w + 3) // 4, (h + 3) // 4
            blocks = np.frombuffer(raw, np.uint8).reshape(
                -1, self.file.bytes_per_unit)
            if fmt == "BC1":
                dec = gpu_unpack.unpack_bc1(blocks)
            elif fmt == "BC2":
                # color half decodes in BC1 4-color mode (BC2/3 never use
                # the punch-through path)
                dec = gpu_unpack.unpack_bc1(
                    np.ascontiguousarray(blocks[:, 8:]),
                    bc1_threecolor=False)
                a4 = np.frombuffer(
                    np.ascontiguousarray(blocks[:, :8]), np.uint64)
                shifts = (np.arange(16, dtype=np.uint64) * 4)
                av = ((a4[:, None] >> shifts) & np.uint64(0xF)).astype(np.uint8)
                dec = dec.copy()
                dec[..., 3] = (av * 17).reshape(-1, 16)
            elif fmt == "BC3":
                dec = gpu_unpack.unpack_bc3(blocks)
            elif fmt == "BC4":
                v = gpu_unpack.unpack_bc4(blocks)
                dec = np.zeros(v.shape + (4,), np.uint8)
                dec[..., 0] = v
                dec[..., 3] = 255
            elif fmt == "BC5":
                dec = gpu_unpack.unpack_bc5(blocks)
            elif fmt == "BC7":
                dec = gpu_unpack.unpack_bc7(blocks)      # (N,16,4) texel-major
            else:
                raise NotImplementedError(f"DDS {fmt} decode")
            out = etc1_ops.blocks_to_image(
                dec.reshape(by, bx, 4, 4, 4), w, h)
        self._cache[key] = out
        return out

    @guard_parse
    def transcode_image_level(self, level: int, layer: int, face: int,
                              fmt: TF) -> np.ndarray:
        rgba = self.decode_rgba(level, layer, face)
        h, w = rgba.shape[:2]
        if fmt == TF.RGBA32:
            return rgba
        nby, nbx = -(-h // 4), -(-w // 4)
        pad = np.zeros((nby * 4, nbx * 4, 4), np.uint8)
        pad[:h, :w] = rgba
        if h < pad.shape[0]:
            pad[h:] = pad[h - 1:h]
        if w < pad.shape[1]:
            pad[:, w:] = pad[:, w - 1:w]
        blocks = pad.reshape(nby, 4, nbx, 4, 4).transpose(0, 2, 1, 3, 4)
        eng = UastcTranscodeEngine(self.device)
        return eng.convert_rgba(fmt, blocks.reshape(-1, 4, 4, 4),
                                nbx, nby, w, h)


XUASTC_LDR_FORMATS = {
    BasisTexFormat.XUASTC_LDR_4x4, BasisTexFormat.XUASTC_LDR_5x4,
    BasisTexFormat.XUASTC_LDR_5x5, BasisTexFormat.XUASTC_LDR_6x5,
    BasisTexFormat.XUASTC_LDR_6x6, BasisTexFormat.XUASTC_LDR_8x5,
    BasisTexFormat.XUASTC_LDR_8x6, BasisTexFormat.XUASTC_LDR_10x5,
    BasisTexFormat.XUASTC_LDR_10x6, BasisTexFormat.XUASTC_LDR_8x8,
    BasisTexFormat.XUASTC_LDR_10x8, BasisTexFormat.XUASTC_LDR_10x10,
    BasisTexFormat.XUASTC_LDR_12x10, BasisTexFormat.XUASTC_LDR_12x12,
}


ASTC_LDR_BLOCK_SIZES = {
    BasisTexFormat.ASTC_LDR_4x4: (4, 4), BasisTexFormat.ASTC_LDR_5x4: (5, 4),
    BasisTexFormat.ASTC_LDR_5x5: (5, 5), BasisTexFormat.ASTC_LDR_6x5: (6, 5),
    BasisTexFormat.ASTC_LDR_6x6: (6, 6), BasisTexFormat.ASTC_LDR_8x5: (8, 5),
    BasisTexFormat.ASTC_LDR_8x6: (8, 6), BasisTexFormat.ASTC_LDR_10x5: (10, 5),
    BasisTexFormat.ASTC_LDR_10x6: (10, 6), BasisTexFormat.ASTC_LDR_8x8: (8, 8),
    BasisTexFormat.ASTC_LDR_10x8: (10, 8),
    BasisTexFormat.ASTC_LDR_10x10: (10, 10),
    BasisTexFormat.ASTC_LDR_12x10: (12, 10),
    BasisTexFormat.ASTC_LDR_12x12: (12, 12),
}


class AstcLdrTranscodeEngine:
    """Standard ASTC LDR 4x4..12x12 slices (raw 16-byte blocks; parity:
    basisu_transcoder.cpp m_lowlevel_xuastc_ldr_decoder standard-ASTC path).
    Decodes via the size-generic ASTC decoder; block-compressed targets
    re-encode from the decoded RGBA on a 4x4 grid."""

    def __init__(self, block_w: int, block_h: int, srgb: bool,
                 deblock=None, device="cuda"):
        self.bw, self.bh = block_w, block_h
        self.srgb = srgb
        self.device = resolve_device(device)
        # None = size default (>=10x8); KTX2 DeblockFilterID overrides
        # (basisu_transcoder.cpp:20684-20695)
        self.deblock = deblock

    def convert(self, fmt: TF, blocks: np.ndarray, nbx: int, nby: int,
                orig_width: int, orig_height: int) -> np.ndarray:
        from .codecs.astc import helpers as ah
        from .ops import deblock as db

        if fmt == TF.ASTC_4x4_RGBA and (self.bw, self.bh) == (4, 4):
            return blocks.reshape(nby, nbx, 16)
        px = ah.decode_blocks_rgba8(blocks, srgb=self.srgb,
                                    bw=self.bw, bh=self.bh)
        grid = px.reshape(nby, nbx, self.bh, self.bw, 4)
        img = grid.transpose(0, 2, 1, 3, 4).reshape(
            nby * self.bh, nbx * self.bw, 4)
        # transcode-time CPU deblocking for non-ASTC targets (the GPU
        # shader handles native ASTC at sample time)
        use_db = (db.default_deblock(self.bw, self.bh)
                  if self.deblock is None else self.deblock)
        if use_db:
            img = db.deblock_rgba(img, self.bw, self.bh)
        img = img[:orig_height, :orig_width]
        if fmt == TF.RGBA32:
            return img
        if fmt in (TF.RGB565, TF.BGR565, TF.RGBA4444):
            if fmt == TF.RGB565:
                return tc_ops.rgba_to_rgb565(img)
            if fmt == TF.BGR565:
                return tc_ops.rgba_to_bgr565(img)
            return tc_ops.rgba_to_rgba4444(img)
        # block-compressed targets: re-block the decoded image at 4x4
        blocks4 = etc1_ops.image_to_blocks(img)
        b4y, b4x = blocks4.shape[:2]
        eng = UastcTranscodeEngine(self.device)
        return eng.convert_rgba(fmt, blocks4.reshape(-1, 4, 4, 4),
                                b4x, b4y, orig_width, orig_height)


class BasisTranscoder:
    """.basis reader + transcoder (basisu_transcoder analog); re-encodes run
    on `device`."""

    @guard_parse
    def __init__(self, data: bytes, device="cuda"):
        self.file = basis_file.BasisFile(data)
        self.device = resolve_device(device)
        self._engine: Optional[Etc1sTranscodeEngine] = None
        self._global_codebooks = None
        # group slices by (image, level)
        self._slice_map: Dict[Tuple[int, int], Dict[str, int]] = {}
        etc1s = self.file.tex_format == BasisTexFormat.ETC1S
        for i, sd in enumerate(self.file.slices):
            key = (sd.image_index, sd.level_index)
            entry = self._slice_map.setdefault(key, {})
            # only ETC1S uses separate alpha slices; UASTC alpha is in-block
            entry["alpha" if (sd.has_alpha and etc1s) else "rgb"] = i
        self._decoded: Dict[int, _Etc1sDecodedSlice] = {}

    def validate_header(self) -> bool:
        return self.file.header.sig == basis_file.BASIS_SIG

    def validate_file_checksums(self) -> bool:
        return self.file.validate_crcs()

    @property
    def tex_format(self) -> BasisTexFormat:
        return self.file.tex_format

    def get_total_images(self) -> int:
        return self.file.header.total_images

    def get_total_image_levels(self, image_index: int) -> int:
        return sum(1 for (img, _lvl) in self._slice_map if img == image_index)

    def get_image_level_info(self, image_index: int, level_index: int) -> ImageLevelInfo:
        entry = self._slice_map[(image_index, level_index)]
        sd = self.file.slices[entry["rgb"]]
        return ImageLevelInfo(sd.orig_width, sd.orig_height,
                              sd.num_blocks_x, sd.num_blocks_y,
                              "alpha" in entry)

    def set_global_codebooks(self, source):
        """Attach shared codebooks (set_global_codebooks analog,
        basisu_transcoder.h). source: another started BasisTranscoder or an
        Etc1sCodebooks."""
        if isinstance(source, BasisTranscoder):
            source.start_transcoding()
            self._global_codebooks = source._engine.codebooks
        else:
            self._global_codebooks = source

    @guard_parse
    def start_transcoding(self):
        if self._engine is None:
            h = self.file.header
            if self.tex_format == BasisTexFormat.ETC1S:
                if h.flags & HeaderFlags.USES_GLOBAL_CODEBOOK:
                    if self._global_codebooks is None:
                        raise ValueError(
                            "file uses global codebooks: call "
                            "set_global_codebooks() first")
                    self._engine = Etc1sTranscodeEngine.from_codebooks(
                        self._global_codebooks, self.file.tables_data)
                else:
                    self._engine = Etc1sTranscodeEngine(
                        h.total_endpoints, self.file.endpoint_cb_data,
                        h.total_selectors, self.file.selector_cb_data,
                        self.file.tables_data)
            elif self.tex_format == BasisTexFormat.UASTC_LDR_4x4:
                self._engine = UastcTranscodeEngine(self.device)
            elif self.tex_format == BasisTexFormat.UASTC_HDR_4x4:
                self._engine = AstcHdrTranscodeEngine()
            elif self.tex_format == BasisTexFormat.ASTC_HDR_6x6:
                self._engine = AstcHdrTranscodeEngine(6, 6)
            elif self.tex_format == BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE:
                self._engine = Hdr6x6IntermediateEngine()
            elif self.tex_format in ASTC_LDR_BLOCK_SIZES:
                bw, bh = ASTC_LDR_BLOCK_SIZES[self.tex_format]
                self._engine = AstcLdrTranscodeEngine(
                    bw, bh, srgb=bool(h.flags & HeaderFlags.SRGB),
                    device=self.device)
            elif self.tex_format in XUASTC_LDR_FORMATS:
                self._engine = XuastcLdrTranscodeEngine(
                    srgb=bool(h.flags & HeaderFlags.SRGB), device=self.device)
            elif self.tex_format == BasisTexFormat.XUBC7:
                self._engine = Xubc7TranscodeEngine(self.device)
            else:
                raise NotImplementedError(
                    f"{self.tex_format.name} .basis decode not implemented yet")
        return True

    def _get_decoded(self, slice_index: int) -> _Etc1sDecodedSlice:
        if slice_index not in self._decoded:
            sd = self.file.slices[slice_index]
            is_video = (self.file.header.tex_type
                        == BasisTextureType.VIDEO_FRAMES)
            prev = None
            if is_video and not sd.is_iframe:
                # previous frame = nearest earlier slice of same (level, alpha)
                for j in range(slice_index - 1, -1, -1):
                    pj = self.file.slices[j]
                    if (pj.level_index == sd.level_index
                            and pj.has_alpha == sd.has_alpha):
                        pd = self._get_decoded(j)
                        prev = (pd.endpoint_idx, pd.selector_idx)
                        break
            e, s = self._engine.decode_slice(
                self.file.slice_data(slice_index), sd.num_blocks_x,
                sd.num_blocks_y, is_video=is_video and prev is not None,
                prev=prev)
            self._decoded[slice_index] = _Etc1sDecodedSlice(e, s)
        return self._decoded[slice_index]

    @guard_parse
    def transcode_image_level(self, image_index: int, level_index: int,
                              fmt: TF) -> np.ndarray:
        self.start_transcoding()
        entry = self._slice_map[(image_index, level_index)]
        sd = self.file.slices[entry["rgb"]]
        if isinstance(self._engine, (Hdr6x6IntermediateEngine,
                                     XuastcLdrTranscodeEngine,
                                     Xubc7TranscodeEngine)):
            return self._engine.convert(
                fmt, self.file.slice_data(entry["rgb"]), sd.num_blocks_x,
                sd.num_blocks_y, sd.orig_width, sd.orig_height)
        if isinstance(self._engine, (UastcTranscodeEngine,
                                     AstcHdrTranscodeEngine,
                                     AstcLdrTranscodeEngine)):
            blocks = np.frombuffer(
                self.file.slice_data(entry["rgb"]), dtype=np.uint8).reshape(-1, 16)
            return self._engine.convert(fmt, blocks, sd.num_blocks_x,
                                        sd.num_blocks_y, sd.orig_width,
                                        sd.orig_height)
        rgb = self._get_decoded(entry["rgb"])
        alpha = self._get_decoded(entry["alpha"]) if "alpha" in entry else None
        return self._engine.convert(fmt, rgb, alpha, sd.orig_width, sd.orig_height)


class Ktx2Transcoder:
    """.KTX2 reader + transcoder (ktx2_transcoder analog; ETC1S/BasisLZ);
    re-encodes run on `device`."""

    @guard_parse
    def __init__(self, data: bytes, device="cuda"):
        self.file = ktx2.Ktx2File(data)
        self.device = resolve_device(device)
        self._engine: Optional[Etc1sTranscodeEngine] = None
        self._descs = None
        # per-image decoded ETC1S index cache (video prev-frame chaining)
        self._decoded: Dict[Tuple[int, bool], _Etc1sDecodedSlice] = {}

    @property
    def header(self):
        return self.file

    def get_width(self) -> int:
        return self.file.pixel_width

    def get_height(self) -> int:
        return self.file.pixel_height

    def get_levels(self) -> int:
        return max(1, self.file.level_count)

    def get_layers(self) -> int:
        return max(1, self.file.layer_count)

    def get_faces(self) -> int:
        return max(1, self.file.face_count)

    def get_key_values(self) -> Dict[str, bytes]:
        return self.file.key_values

    def is_srgb(self) -> bool:
        return self.file.is_srgb

    def get_basis_tex_format(self) -> Optional[BasisTexFormat]:
        return self.file.basis_tex_format()

    def get_deblocking_filter_index(self) -> int:
        """DeblockFilterID key value, 0 if absent (ktx2_transcoder analog,
        basisu_transcoder.h:1393, .cpp:20293-20308)."""
        val = self.file.key_values.get("DeblockFilterID")
        if val and val[:1] == b"1" and (len(val) == 1 or val[1] == 0):
            return 1
        return 0

    def _deblock_filter_key(self):
        """KTX2 files carry an explicit decision: the key's presence/value
        fully overrides the block-size default (.cpp:20684-20695)."""
        return self.get_deblocking_filter_index() >= 1

    @guard_parse
    def start_transcoding(self):
        if self._engine is None:
            fmt = self.file.basis_tex_format()
            if fmt == BasisTexFormat.ETC1S:
                ne, ns, ep, sp, tb, descs = self.file.etc1s_global_data()
                self._engine = Etc1sTranscodeEngine(ne, ep, ns, sp, tb)
                self._descs = descs
            elif fmt == BasisTexFormat.UASTC_LDR_4x4:
                self._engine = UastcTranscodeEngine(self.device)
            elif fmt == BasisTexFormat.UASTC_HDR_4x4:
                self._engine = AstcHdrTranscodeEngine()
            elif fmt == BasisTexFormat.ASTC_HDR_6x6:
                self._engine = AstcHdrTranscodeEngine(6, 6)
            elif fmt == BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE:
                self._engine = Hdr6x6IntermediateEngine()
            elif fmt in ASTC_LDR_BLOCK_SIZES:
                bw, bh = ASTC_LDR_BLOCK_SIZES[fmt]
                self._engine = AstcLdrTranscodeEngine(
                    bw, bh, srgb=bool(self.file.is_srgb),
                    deblock=self._deblock_filter_key(), device=self.device)
            elif fmt in XUASTC_LDR_FORMATS:
                self._engine = XuastcLdrTranscodeEngine(
                    srgb=bool(self.file.is_srgb),
                    deblock=self._deblock_filter_key(), device=self.device)
            elif fmt == BasisTexFormat.XUBC7:
                self._engine = Xubc7TranscodeEngine(self.device)
            else:
                raise NotImplementedError(
                    f"KTX2 decode for {fmt!r} not implemented yet")
        return True

    @guard_parse
    def transcode_image_level(self, level: int, layer: int, face: int,
                              fmt: TF) -> np.ndarray:
        self.start_transcoding()
        w = max(1, self.file.pixel_width >> level)
        h = max(1, self.file.pixel_height >> level)
        bw = getattr(self._engine, "bw", 4)
        bh = getattr(self._engine, "bh", 4)
        nbx, nby = -(-w // bw), -(-h // bh)
        layers = self.get_layers()
        faces = self.get_faces()
        idx = level * (layers * faces) + layer * faces + face
        if isinstance(self._engine, Hdr6x6IntermediateEngine):
            return self._engine.convert(
                fmt, self.file.level_data(level), nbx, nby, w, h)
        if isinstance(self._engine, (XuastcLdrTranscodeEngine,
                                     Xubc7TranscodeEngine)):
            data = self.file.level_data(level)
            if layers * faces > 1 or level:
                descs = self.file.xu_slice_descs()
                if idx < len(descs):
                    ofs, ln, _sig = descs[idx]
                    data = data[ofs:ofs + ln]
            if isinstance(self._engine, XuastcLdrTranscodeEngine):
                c, _ = self._engine.physical_blocks(data)
                nbx = -(-w // c.block_w)
                nby = -(-h // c.block_h)
            else:
                nbx, nby = -(-w // 4), -(-h // 4)
            return self._engine.convert(fmt, data, nbx, nby, w, h)
        if isinstance(self._engine, (UastcTranscodeEngine,
                                     AstcHdrTranscodeEngine,
                                     AstcLdrTranscodeEngine)):
            lvl = self.file.level_data(level)
            img_bytes = nbx * nby * 16
            ofs = (layer * faces + face) * img_bytes
            blocks = np.frombuffer(
                lvl[ofs:ofs + img_bytes], dtype=np.uint8).reshape(-1, 16)
            return self._engine.convert(fmt, blocks, nbx, nby, w, h)
        rgb = self._get_decoded(level, layer, face, nbx, nby, alpha=False)
        alpha = None
        if self._descs[idx].alpha_slice_byte_length:
            alpha = self._get_decoded(level, layer, face, nbx, nby, alpha=True)
        return self._engine.convert(fmt, rgb, alpha, w, h)

    def is_video(self) -> bool:
        """Video if the KTXanimData key exists OR any image desc carries the
        P-frame flag (basisu_transcoder.cpp:20268-20371)."""
        if "KTXanimData" in self.file.key_values:
            return True
        if self._descs is not None:
            return any(d.image_flags & ktx2.KTX2_IMAGE_IS_P_FRAME
                       for d in self._descs)
        return False

    def _get_decoded(self, level: int, layer: int, face: int,
                     nbx: int, nby: int, alpha: bool) -> _Etc1sDecodedSlice:
        """Decode one ETC1S image slice, chaining video P-frames back to the
        previous layer's indices of the same (level, face) — the KTX2 analog
        of basisu_transcoder_state::m_prev_frame_indices
        (basisu_transcoder.cpp:20593, :8554+)."""
        layers, faces = self.get_layers(), self.get_faces()
        idx = level * (layers * faces) + layer * faces + face
        key = (idx, alpha)
        if key in self._decoded:
            return self._decoded[key]
        d = self._descs[idx]
        prev = None
        is_p = bool(d.image_flags & ktx2.KTX2_IMAGE_IS_P_FRAME)
        if is_p and layer > 0:
            pd = self._get_decoded(level, layer - 1, face, nbx, nby, alpha)
            prev = (pd.endpoint_idx, pd.selector_idx)
        lvl = self.file.level_data(level)
        if alpha:
            data = lvl[d.alpha_slice_byte_offset:
                       d.alpha_slice_byte_offset + d.alpha_slice_byte_length]
        else:
            data = lvl[d.rgb_slice_byte_offset:
                       d.rgb_slice_byte_offset + d.rgb_slice_byte_length]
        e, s = self._engine.decode_slice(
            data, nbx, nby, is_video=prev is not None, prev=prev)
        out = _Etc1sDecodedSlice(e, s)
        self._decoded[key] = out
        return out
