"""Copy of `basis_universal_tpu/ops/deblock.py`.

Transcode-time CPU deblocking for large-block ASTC/XUASTC LDR.

Exact vectorized port of the reference's per-block interior filter
(deblock_block_region_interior, transcoder/basisu_transcoder.cpp:42428,
applied by xuastc_deblock_filter :42548 at transcode when the KTX2
DeblockFilterID key or the >=10x8 default enables it,
basisu_transcoder.h:273-280, .cpp:43142,:20684-20695). The filter
mirrors the GPU deblocking shader: block-boundary rows/columns get a
3-tap average, the four block corners a 5-tap plus-shaped average
computed in float32 (matching the shader's float math), interiors pass
through.
"""

import numpy as np

# blocks with area >= this deblock by default (10x8 and larger;
# BASISU_DEBLOCKING_BLOCK_SIZE_THRESHOLD, basisu_transcoder.h:39)
BLOCK_AREA_THRESHOLD = 80


def default_deblock(block_w: int, block_h: int) -> bool:
    return block_w * block_h >= BLOCK_AREA_THRESHOLD


def deblock_rgba(img: np.ndarray, fbw: int, fbh: int) -> np.ndarray:
    """(H, W, 4) uint8 → filtered copy. H/W need not be block multiples
    (the reference filters the block-padded decode; pass that in)."""
    if fbw < 3 or fbh < 3:
        return img
    h, w = img.shape[:2]
    src = img.astype(np.int32)
    pad = np.pad(src, ((1, 1), (1, 1), (0, 0)), mode="edge")
    c = pad[1:-1, 1:-1]
    l = pad[1:-1, :-2]
    r = pad[1:-1, 2:]
    u = pad[:-2, 1:-1]
    d = pad[2:, 1:-1]

    xs = np.arange(w)
    ys = np.arange(h)
    x_edge = (xs % fbw == 0) | (xs % fbw == fbw - 1)
    y_edge = (ys % fbh == 0) | (ys % fbh == fbh - 1)
    corner = y_edge[:, None] & x_edge[None, :]
    v_edge = (~y_edge[:, None]) & x_edge[None, :]   # left/right columns
    h_edge = y_edge[:, None] & (~x_edge[None, :])   # top/bottom rows

    out = c.copy()
    # vertical (left/right) edges: horizontal 3-tap, (l + c + r + 1) / 3
    ve = (l + c + r + 1) // 3
    out[v_edge] = ve[v_edge]
    # horizontal (top/bottom) edges: vertical 3-tap
    he = (u + c + d + 1) // 3
    out[h_edge] = he[h_edge]
    # corners: plus-shaped 5-tap at float32, round-half-up, min 255
    s = (l + 2 * c + r + u + d).astype(np.float32)
    cv = np.floor(s * np.float32(1.0 / 6.0) + np.float32(0.5)).astype(np.int32)
    cv = np.minimum(cv, 255)
    out[corner] = cv[corner]
    return out.astype(np.uint8)
