"""Copy of `basis_universal_tpu/api.py`.

User-facing API mirroring the reference Python bindings (basisu_py).

Encoder(...).compress(image, format, quality, effort, flags) → .basis/.KTX2
bytes; Transcoder().open/decode_rgba/transcode_tfmt over KTX2 (and .basis).
Quality is the unified 1-100 scale, effort the unified 0-10 scale
(python/basisu_py/constants.py:55-74); ETC1S maps quality onto its native
0-255 level exactly like the reference (basisu_comp.cpp:174).
"""

import numpy as np

from . import compressor as _comp
from .codecs.etc1s.frontend import resolve_device
from .formats.constants import BasisTexFormat, TranscoderTextureFormat
from .transcoder import BasisTranscoder, Ktx2Transcoder


class BasisQuality:
    MIN = 1
    MAX = 100


class BasisEffort:
    MIN = 0
    MAX = 10
    SUPER_FAST = 0
    FAST = 2
    NORMAL = 5
    DEFAULT = 2
    SLOW = 8
    VERY_SLOW = 10


class BasisFlags:
    NONE = 0
    THREADED = 1 << 9
    KTX2_OUTPUT = 1 << 11
    SRGB = 1 << 13
    GEN_MIPS_CLAMP = 1 << 14
    GEN_MIPS_WRAP = 1 << 15
    Y_FLIP = 1 << 16
    PRINT_STATS = 1 << 18
    PRINT_STATUS = 1 << 19
    VALIDATE_OUTPUT = 1 << 22


class Encoder:
    """Texture encoder. backend is always the PyTorch pipeline (the
    reference's NATIVE/WASM split does not apply); its device searches run
    on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, backend: str = "auto", device="cuda"):
        self.backend_name = "PyTorch"
        self.device = str(resolve_device(device))

    # formats whose compressor path consumes float32 linear RGB input
    _HDR_FORMATS = (BasisTexFormat.UASTC_HDR_4x4, BasisTexFormat.ASTC_HDR_6x6,
                    BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE)

    def compress(self, image, format: int = -1,
                 quality: int = BasisQuality.MAX,
                 effort: int = BasisEffort.DEFAULT,
                 flags: int = BasisFlags.KTX2_OUTPUT | BasisFlags.SRGB) -> bytes:
        """Compress an image → container bytes. Every BasisTexFormat is
        accepted (ETC1S, UASTC LDR/HDR, ASTC LDR all footprints, XUASTC LDR
        all footprints, ASTC/UASTC HDR 6x6, XUBC7).

        image: numpy HxWx3/4 uint8 (LDR), float32 (HDR linear), or PIL.
        format -1 auto-selects like basisu_py codec.py:78-83 — UASTC HDR 6x6
        intermediate for float32 input, XUASTC LDR 6x6 for uint8.
        quality: unified 1-100 (basisu_comp.cpp:163-270 per-codec remap).
        Returns .KTX2 bytes when KTX2_OUTPUT is set, else .basis bytes.
        """
        img = self._to_array(image)
        is_hdr = img.dtype in (np.float32, np.float64, np.float16)
        if format == -1:
            format = (BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE if is_hdr
                      else BasisTexFormat.XUASTC_LDR_6x6)
        fmt = BasisTexFormat(format)
        if is_hdr != (fmt in self._HDR_FORMATS):
            raise ValueError(
                f"{fmt.name} needs {'float32' if fmt in self._HDR_FORMATS else 'uint8'}"
                f" input, got {img.dtype}")
        q100 = min(max(int(quality), 1), 100)
        if fmt == BasisTexFormat.ETC1S:
            # lerp onto the native 0-255 scale (basisu_comp.cpp:174)
            q_native = max(1, int(round((q100 / 100.0) * 255.0)))
        else:
            # XUASTC/XUBC7 consume 1-100 directly (100 = DCT off); the other
            # codecs have no quality knob (basisu_comp.cpp:229 warns) but we
            # pass it through so future RDO lambdas can key off it
            q_native = q100
        if flags & BasisFlags.Y_FLIP:
            img = img[::-1]
        rdo_uastc = 0.0
        if fmt == BasisTexFormat.UASTC_LDR_4x4 and q100 < 100:
            # unified quality drives UASTC RDO strength (m_rdo_uastc_..._quality_scalar)
            rdo_uastc = 0.2 + (100 - q100) * 0.05
        params = _comp.CompressorParams(
            tex_format=fmt,
            quality_level=q_native,
            effort=min(max(int(effort), 0), 10),
            perceptual=bool(flags & BasisFlags.SRGB) and not is_hdr,
            rdo_uastc_quality=rdo_uastc,
            mip_gen=bool(flags & (BasisFlags.GEN_MIPS_CLAMP | BasisFlags.GEN_MIPS_WRAP)),
            device=self.device,
        )
        out = _comp.compress(img, params)
        return out.ktx2_data if flags & BasisFlags.KTX2_OUTPUT else out.basis_data

    def compress_float32(self, arr, **kwargs):
        """HDR entry point mirroring basisu_py codec.py:90-97."""
        if not isinstance(arr, np.ndarray) or arr.dtype != np.float32:
            raise ValueError("compress_float32 requires float32 NumPy HxWx3/4 array")
        return self.compress(arr, **kwargs)

    @staticmethod
    def _to_array(image) -> np.ndarray:
        if isinstance(image, np.ndarray):
            return image
        try:
            from PIL import Image

            if isinstance(image, Image.Image):
                return np.asarray(image.convert("RGBA"))
        except ImportError:
            pass
        raise TypeError(f"unsupported image type {type(image)!r}")


class Transcoder:
    """KTX2/.basis transcoder mirroring basisu_py.Transcoder; the
    re-encodes of its targets run on `device` ("cuda" unless the caller
    asks for the CPU)."""

    def __init__(self, backend: str = "auto", device="cuda"):
        self.backend_name = "PyTorch"
        self.device = str(resolve_device(device))

    def open(self, data: bytes):
        if data[:12] == bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30,
                               0xBB, 0x0D, 0x0A, 0x1A, 0x0A]):
            h = Ktx2Transcoder(data, device=self.device)
        else:
            h = BasisTranscoder(data, device=self.device)
        h.start_transcoding()
        return h

    def close(self, handle):
        pass

    # introspection
    def get_width(self, h):
        return h.get_width() if isinstance(h, Ktx2Transcoder) else \
            h.get_image_level_info(0, 0).orig_width

    def get_height(self, h):
        return h.get_height() if isinstance(h, Ktx2Transcoder) else \
            h.get_image_level_info(0, 0).orig_height

    def get_levels(self, h):
        return h.get_levels() if isinstance(h, Ktx2Transcoder) else \
            h.get_total_image_levels(0)

    def get_layers(self, h):
        return h.get_layers() if isinstance(h, Ktx2Transcoder) else \
            h.get_total_images()

    def get_faces(self, h):
        return h.get_faces() if isinstance(h, Ktx2Transcoder) else 1

    def get_basis_tex_format(self, h):
        return h.get_basis_tex_format() if isinstance(h, Ktx2Transcoder) else h.tex_format

    def is_etc1s(self, h):
        return self.get_basis_tex_format(h) == BasisTexFormat.ETC1S

    def is_srgb(self, h):
        return h.is_srgb() if isinstance(h, Ktx2Transcoder) else True

    def get_key_values(self, h):
        return h.get_key_values() if isinstance(h, Ktx2Transcoder) else {}

    # decoding
    def decode_rgba(self, data_or_handle, level=0, layer=0, face=0) -> np.ndarray:
        h = self._handle(data_or_handle)
        return self._transcode(h, TranscoderTextureFormat.RGBA32, level, layer, face)

    def transcode_tfmt(self, data_or_handle, tfmt, level=0, layer=0, face=0):
        h = self._handle(data_or_handle)
        return self._transcode(h, TranscoderTextureFormat(tfmt), level, layer, face)

    def _handle(self, x):
        if isinstance(x, (bytes, bytearray)):
            return self.open(bytes(x))
        return x

    @staticmethod
    def _transcode(h, fmt, level, layer, face):
        if isinstance(h, Ktx2Transcoder):
            return h.transcode_image_level(level, layer, face, fmt)
        return h.transcode_image_level(layer, level, fmt)
