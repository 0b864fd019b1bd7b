"""Copy of `basis_universal_tpu/ops/etc1.py`.

ETC1/ETC1S block math: palettes, pixel decode, physical block packing.

ETC1 spec constants (public Khronos spec; conventions verified against
transcoder/basisu_transcoder.cpp:480-640):
  - 8 intensity-modifier tables × 4 selector values (low→high order)
  - 5-bit base color expanded to 8 bits via (c << 3) | (c >> 2)
  - ETC1S physical block: differential mode, flip=0, delta=0, both subblocks
    share base color + intensity table (transcode_slice writes flip=false,
    diff=true — basisu_transcoder.cpp:8588-8592)
  - selector physical packing: bit_index = x*4 + y; lsb plane bytes 6-7,
    msb plane bytes 4-5 (MSB-end first); logical selector (0..3, palette
    index) → etc1 encoded value via {3, 2, 0, 1}
    (decoder_etc_block::set_selector, basisu_transcoder.cpp:570-592)

Vectorized over whole images: numpy for host paths, mirrored jnp ops for
device paths used by the encoder frontend.
"""

import numpy as np

# Intensity modifier tables, selector index 0..3 (low → high).
ETC1_INTEN_TABLES = np.array(
    [
        [-8, -2, 2, 8],
        [-17, -5, 5, 17],
        [-29, -9, 9, 29],
        [-42, -13, 13, 42],
        [-60, -18, 18, 60],
        [-80, -24, 24, 80],
        [-106, -33, 33, 106],
        [-183, -47, 47, 183],
    ],
    dtype=np.int32,
)

# logical selector (palette index, 0=lowest) → ETC1 encoded 2-bit value
SELECTOR_INDEX_TO_ETC1 = np.array([3, 2, 0, 1], dtype=np.uint8)
# inverse: ETC1 encoded value → logical selector
ETC1_TO_SELECTOR_INDEX = np.array([2, 3, 1, 0], dtype=np.uint8)


def color5_to_8(c5):
    """Expand 5-bit component to 8 bits: (c << 3) | (c >> 2)."""
    c5 = np.asarray(c5, dtype=np.int32)
    return (c5 << 3) | (c5 >> 2)


def etc1s_palette(color5, inten5):
    """Compute the 4-color palette of ETC1S endpoints.

    color5: (..., 3) int, 5-bit components. inten5: (...,) int 0..7.
    Returns (..., 4, 3) int32 palette, clamped to [0, 255].
    """
    color5 = np.asarray(color5, dtype=np.int32)
    inten5 = np.asarray(inten5, dtype=np.int32)
    base = color5_to_8(color5)[..., None, :]              # (..., 1, 3)
    mods = ETC1_INTEN_TABLES[inten5][..., :, None]        # (..., 4, 1)
    return np.clip(base + mods, 0, 255)


def decode_blocks_to_rgba(endpoint_idx, selector_idx, color5, inten5, selectors,
                          alpha_endpoint_idx=None, alpha_selector_idx=None):
    """ETC1S (indices + codebooks) → RGBA8 pixels per block.

    endpoint_idx/selector_idx: (BY, BX) int arrays.
    color5 (E,3), inten5 (E,), selectors (S,16) with idx = y*4+x.
    Returns (BY, BX, 4, 4, 4) uint8 RGBA (y, x within block).
    """
    pal = etc1s_palette(color5, inten5)                    # (E, 4, 3)
    sel = selectors[selector_idx]                          # (BY, BX, 16)
    block_pal = pal[endpoint_idx]                          # (BY, BX, 4, 3)
    rgb = np.take_along_axis(
        block_pal[:, :, None, :, :],                       # (BY,BX,1,4,3)
        sel[..., None, None].astype(np.int64),             # (BY,BX,16,1,1)
        axis=3,
    )[:, :, :, 0, :]                                       # (BY,BX,16,3)
    by, bx = endpoint_idx.shape
    out = np.empty((by, bx, 16, 4), dtype=np.uint8)
    out[..., :3] = rgb.astype(np.uint8)
    if alpha_endpoint_idx is not None:
        apal = etc1s_palette(color5, inten5)[..., 1]       # green channel (E,4)
        asel = selectors[alpha_selector_idx]               # (BY,BX,16)
        a = np.take_along_axis(
            apal[alpha_endpoint_idx][:, :, None, :],       # (BY,BX,1,4)
            asel[..., None].astype(np.int64), axis=3)[..., 0]
        out[..., 3] = a.astype(np.uint8)
    else:
        out[..., 3] = 255
    return out.reshape(by, bx, 4, 4, 4)


def blocks_to_image(blocks, orig_width, orig_height):
    """(BY, BX, 4, 4, C) block pixels → (H, W, C) image, cropping padding."""
    by, bx = blocks.shape[:2]
    c = blocks.shape[-1]
    img = blocks.transpose(0, 2, 1, 3, 4).reshape(by * 4, bx * 4, c)
    return img[:orig_height, :orig_width]


def image_to_blocks(img):
    """(H, W, C) image → (BY, BX, 4, 4, C), edge-replicating to multiples of 4.

    Matches the reference's block extraction (crop_dup_borders semantics in
    image::extract_block_clamped, encoder/basisu_enc.h).
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    bh, bw = (h + 3) // 4 * 4, (w + 3) // 4 * 4
    if bh != h or bw != w:
        img = np.pad(img, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")
    by, bx = bh // 4, bw // 4
    c = img.shape[-1]
    return img.reshape(by, 4, bx, 4, c).transpose(0, 2, 1, 3, 4)


def pack_etc1_blocks(endpoint_idx, selector_idx, color5, inten5, selectors):
    """Emit physical ETC1 blocks (8 bytes each) for ETC1S data.

    Differential mode, delta=0, flip=0, both subblocks identical.
    Returns (BY, BX, 8) uint8.
    """
    endpoint_idx = np.asarray(endpoint_idx)
    by, bx = endpoint_idx.shape

    from .. import native
    lib = native.get_lib()
    if lib is not None:
        import ctypes
        e = np.ascontiguousarray(endpoint_idx.ravel(), dtype=np.int32)
        s = np.ascontiguousarray(np.asarray(selector_idx).ravel(), dtype=np.int32)
        c5c = np.ascontiguousarray(color5, dtype=np.uint8)
        itc = np.ascontiguousarray(inten5, dtype=np.uint8)
        pat = np.ascontiguousarray(selectors, dtype=np.uint8)
        out = np.zeros(by * bx * 8, dtype=np.uint8)
        lib.etc1s_pack_physical(
            e.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            by * bx,
            c5c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            itc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.reshape(by, bx, 8)

    c5 = color5[endpoint_idx].astype(np.uint8)             # (BY,BX,3)
    it = inten5[endpoint_idx].astype(np.uint8)             # (BY,BX)
    out = np.zeros((by, bx, 8), dtype=np.uint8)
    out[..., 0] = c5[..., 0] << 3   # R5 + delta(0)
    out[..., 1] = c5[..., 1] << 3
    out[..., 2] = c5[..., 2] << 3
    out[..., 3] = (it << 5) | (it << 2) | 2  # both tables, diff=1, flip=0
    sel = selectors[selector_idx].astype(np.uint32)        # (BY,BX,16), y*4+x
    etc1_val = SELECTOR_INDEX_TO_ETC1[sel]                 # (BY,BX,16)
    lsb_plane = np.zeros((by, bx), dtype=np.uint32)
    msb_plane = np.zeros((by, bx), dtype=np.uint32)
    for y in range(4):
        for x in range(4):
            v = etc1_val[..., y * 4 + x].astype(np.uint32)
            bit = x * 4 + y
            lsb_plane |= (v & 1) << bit
            msb_plane |= (v >> 1) << bit
    out[..., 4] = (msb_plane >> 8) & 0xFF
    out[..., 5] = msb_plane & 0xFF
    out[..., 6] = (lsb_plane >> 8) & 0xFF
    out[..., 7] = lsb_plane & 0xFF
    return out


def unpack_etc1_blocks(blocks):
    """Decode physical ETC1 blocks (any mode) → (BY, BX, 4, 4, 4) RGBA8.

    Full ETC1: individual + differential modes, flip, two subblocks.
    Used for validation (gpu_image-style unpackers, basisu_gpu_texture.cpp).
    """
    b = np.asarray(blocks, dtype=np.uint32)
    by, bx = b.shape[:2]
    diff = (b[..., 3] >> 1) & 1
    flip = b[..., 3] & 1
    # base colors per subblock
    r1_i, g1_i, b1_i = b[..., 0] >> 4, b[..., 1] >> 4, b[..., 2] >> 4
    r2_i, g2_i, b2_i = b[..., 0] & 15, b[..., 1] & 15, b[..., 2] & 15
    c1_ind = np.stack([(v << 4) | v for v in (r1_i, g1_i, b1_i)], -1)
    c2_ind = np.stack([(v << 4) | v for v in (r2_i, g2_i, b2_i)], -1)
    base5 = np.stack([b[..., 0] >> 3, b[..., 1] >> 3, b[..., 2] >> 3], -1).astype(np.int32)
    delta3 = np.stack([b[..., 0] & 7, b[..., 1] & 7, b[..., 2] & 7], -1).astype(np.int32)
    delta3 = np.where(delta3 >= 4, delta3 - 8, delta3)
    c1_diff = color5_to_8(base5)
    c2_5 = base5 + delta3
    c2_diff = color5_to_8(np.clip(c2_5, 0, 31))
    c1 = np.where(diff[..., None] == 1, c1_diff, c1_ind)
    c2 = np.where(diff[..., None] == 1, c2_diff, c2_ind)
    t1 = (b[..., 3] >> 5) & 7
    t2 = (b[..., 3] >> 2) & 7
    msb_plane = (b[..., 4] << 8) | b[..., 5]
    lsb_plane = (b[..., 6] << 8) | b[..., 7]
    out = np.empty((by, bx, 4, 4, 4), dtype=np.uint8)
    out[..., 3] = 255
    for y in range(4):
        for x in range(4):
            bit = x * 4 + y
            etc1_val = (((msb_plane >> bit) & 1) << 1) | ((lsb_plane >> bit) & 1)
            sel = ETC1_TO_SELECTOR_INDEX[etc1_val]
            in_second = np.where(flip == 1, y >= 2, x >= 2)
            base = np.where(in_second[..., None], c2, c1)
            table = np.where(in_second, t2, t1)
            mod = ETC1_INTEN_TABLES[table, sel]
            rgb = np.clip(base + mod[..., None], 0, 255)
            out[:, :, y, x, :3] = rgb.astype(np.uint8)
    return out
