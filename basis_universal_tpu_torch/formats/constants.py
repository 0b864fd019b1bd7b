"""Copy of `basis_universal_tpu/formats/constants.py`.

Format enums mirroring the reference bitstream contracts.

Values must match the reference exactly to stay spec-conformant:
  - basis_tex_format: transcoder/basisu_file_headers.h:89-143
  - basis_texture_type: transcoder/basisu_file_headers.h:73-82
  - header/slice flags: transcoder/basisu_file_headers.h:21-68
  - transcoder_texture_format: transcoder/basisu_transcoder.h:49-143
"""

import enum


class BasisTexFormat(enum.IntEnum):
    ETC1S = 0
    UASTC_LDR_4x4 = 1
    UASTC_HDR_4x4 = 2
    ASTC_HDR_6x6 = 3
    UASTC_HDR_6x6_INTERMEDIATE = 4
    XUASTC_LDR_4x4 = 5
    XUASTC_LDR_5x4 = 6
    XUASTC_LDR_5x5 = 7
    XUASTC_LDR_6x5 = 8
    XUASTC_LDR_6x6 = 9
    XUASTC_LDR_8x5 = 10
    XUASTC_LDR_8x6 = 11
    XUASTC_LDR_10x5 = 12
    XUASTC_LDR_10x6 = 13
    XUASTC_LDR_8x8 = 14
    XUASTC_LDR_10x8 = 15
    XUASTC_LDR_10x10 = 16
    XUASTC_LDR_12x10 = 17
    XUASTC_LDR_12x12 = 18
    ASTC_LDR_4x4 = 19
    ASTC_LDR_5x4 = 20
    ASTC_LDR_5x5 = 21
    ASTC_LDR_6x5 = 22
    ASTC_LDR_6x6 = 23
    ASTC_LDR_8x5 = 24
    ASTC_LDR_8x6 = 25
    ASTC_LDR_10x5 = 26
    ASTC_LDR_10x6 = 27
    ASTC_LDR_8x8 = 28
    ASTC_LDR_10x8 = 29
    ASTC_LDR_10x10 = 30
    ASTC_LDR_12x10 = 31
    ASTC_LDR_12x12 = 32
    XUBC7 = 33


_BLOCK_SIZES = {
    BasisTexFormat.ETC1S: (4, 4),
    BasisTexFormat.UASTC_LDR_4x4: (4, 4),
    BasisTexFormat.UASTC_HDR_4x4: (4, 4),
    BasisTexFormat.ASTC_HDR_6x6: (6, 6),
    BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE: (6, 6),
    BasisTexFormat.XUBC7: (4, 4),
}
_ASTC_SIZES = [
    (4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6),
    (10, 5), (10, 6), (8, 8), (10, 8), (10, 10), (12, 10), (12, 12),
]
for _i, _sz in enumerate(_ASTC_SIZES):
    _BLOCK_SIZES[BasisTexFormat(BasisTexFormat.XUASTC_LDR_4x4 + _i)] = _sz
    _BLOCK_SIZES[BasisTexFormat(BasisTexFormat.ASTC_LDR_4x4 + _i)] = _sz


def basis_tex_format_block_size(fmt: BasisTexFormat) -> tuple:
    """Block (width, height) for a basis_tex_format.

    Mirrors get_basis_tex_format_block_size, basisu_file_headers.h:162-206.
    """
    return _BLOCK_SIZES[BasisTexFormat(fmt)]


class BasisTextureType(enum.IntEnum):
    TEX_2D = 0
    TEX_2D_ARRAY = 1
    CUBEMAP_ARRAY = 2
    VIDEO_FRAMES = 3
    VOLUME = 4


class SliceDescFlags(enum.IntFlag):
    HAS_ALPHA = 1
    FRAME_IS_IFRAME = 2


class HeaderFlags(enum.IntFlag):
    ETC1S = 1
    Y_FLIPPED = 2
    HAS_ALPHA_SLICES = 4
    USES_GLOBAL_CODEBOOK = 8
    SRGB = 16


class TranscoderTextureFormat(enum.IntEnum):
    """Physical output formats the transcoder can emit.

    Values mirror transcoder_texture_format, basisu_transcoder.h:49-143.
    """

    ETC1_RGB = 0
    ETC2_RGBA = 1
    BC1_RGB = 2
    BC3_RGBA = 3
    BC4_R = 4
    BC5_RG = 5
    BC7_RGBA = 6
    BC7_ALT = 7
    PVRTC1_4_RGB = 8
    PVRTC1_4_RGBA = 9
    ASTC_4x4_RGBA = 10
    ATC_RGB = 11
    ATC_RGBA = 12
    RGBA32 = 13
    RGB565 = 14
    BGR565 = 15
    RGBA4444 = 16
    FXT1_RGB = 17
    PVRTC2_4_RGB = 18
    PVRTC2_4_RGBA = 19
    ETC2_EAC_R11 = 20
    ETC2_EAC_RG11 = 21
    BC6H = 22
    ASTC_HDR_4x4_RGBA = 23
    RGB_HALF = 24
    RGBA_HALF = 25
    RGB_9E5 = 26
    ASTC_HDR_6x6_RGBA = 27
    # Additional ASTC LDR block sizes (transcoder_texture_format cTFASTC_LDR_*)
    ASTC_LDR_5x4_RGBA = 28
    ASTC_LDR_5x5_RGBA = 29
    ASTC_LDR_6x5_RGBA = 30
    ASTC_LDR_6x6_RGBA = 31
    ASTC_LDR_8x5_RGBA = 32
    ASTC_LDR_8x6_RGBA = 33
    ASTC_LDR_10x5_RGBA = 34
    ASTC_LDR_10x6_RGBA = 35
    ASTC_LDR_8x8_RGBA = 36
    ASTC_LDR_10x8_RGBA = 37
    ASTC_LDR_10x10_RGBA = 38
    ASTC_LDR_12x10_RGBA = 39
    ASTC_LDR_12x12_RGBA = 40


BYTES_PER_BLOCK = {
    TranscoderTextureFormat.ETC1_RGB: 8,
    TranscoderTextureFormat.ETC2_RGBA: 16,
    TranscoderTextureFormat.BC1_RGB: 8,
    TranscoderTextureFormat.BC3_RGBA: 16,
    TranscoderTextureFormat.BC4_R: 8,
    TranscoderTextureFormat.BC5_RG: 16,
    TranscoderTextureFormat.BC7_RGBA: 16,
    TranscoderTextureFormat.PVRTC1_4_RGB: 8,
    TranscoderTextureFormat.PVRTC1_4_RGBA: 8,
    TranscoderTextureFormat.ASTC_4x4_RGBA: 16,
    TranscoderTextureFormat.ATC_RGB: 8,
    TranscoderTextureFormat.ATC_RGBA: 16,
    TranscoderTextureFormat.RGBA32: 4,       # per pixel
    TranscoderTextureFormat.RGB565: 2,       # per pixel
    TranscoderTextureFormat.BGR565: 2,       # per pixel
    TranscoderTextureFormat.RGBA4444: 2,     # per pixel
    TranscoderTextureFormat.FXT1_RGB: 16,
    TranscoderTextureFormat.PVRTC2_4_RGB: 8,
    TranscoderTextureFormat.PVRTC2_4_RGBA: 8,
    TranscoderTextureFormat.ETC2_EAC_R11: 8,
    TranscoderTextureFormat.ETC2_EAC_RG11: 16,
    TranscoderTextureFormat.BC6H: 16,
    TranscoderTextureFormat.ASTC_HDR_4x4_RGBA: 16,
    TranscoderTextureFormat.RGB_HALF: 6,     # per pixel
    TranscoderTextureFormat.RGBA_HALF: 8,    # per pixel
    TranscoderTextureFormat.RGB_9E5: 4,      # per pixel
}
