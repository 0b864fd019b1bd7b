"""Copy of `basis_universal_tpu/codecs/astc/refine.py`.

Post-pack ASTC weight refinement under the true decode semantics.

The UASTC mode search scores candidates under UASTC's LDR decode
(endpoint expansion (v<<8)|v).  When its blocks are repacked and shipped
as plain ASTC (the astc_ldr_* tex formats and the XUASTC entropy layer),
the decoder may run in sRGB mode, which expands endpoints as (v<<8)|0x80
for ALL channels (reference: basisu_astc_helpers.h:3601-3612) — a ±1
reconstruction shift the search never saw.  The reference's own ASTC LDR
encoder optimizes against the real decode, so near-lossless content
(smooth alpha ramps) reconstructs exactly where ours was off by one
(measured: alpha0.png RGBA 60.2 dB vs the reference's 78.2 dB at 4x4).

Once the block is plain ASTC there is no UASTC constraint left, so the
weights are free: for full-resolution weight grids the per-texel,
per-plane weight choice is independent and the exact argmin over the
ISE levels is cheap.  This pass re-picks every weight under the actual
decode formula; error can only decrease.
"""

import numpy as np

from ..uastc import tables as T
from . import helpers as ah
from . import xuastc_cems as XC


def _endpoint16(v: np.ndarray, srgb: bool) -> np.ndarray:
    v = v.astype(np.int64)
    return (v << 8) | (0x80 if srgb else v)


def refine_log_block_weights(blk, src: np.ndarray, bw: int, bh: int,
                             srgb: bool) -> bool:
    """Re-pick `blk`'s weight ISE codes by exact per-texel argmin against
    `src` ((bh*bw, 4) uint8) under the true LDR decode.  Only blocks with
    a full-resolution weight grid and LDR CEMs are touched (infill
    couples texels otherwise).  Returns True if the block was refined."""
    if blk.solid_ldr or blk.solid_hdr:
        return False
    if blk.grid_width != bw or blk.grid_height != bh:
        return False
    if any(c in (2, 3, 7, 11, 14) for c in blk.cems):
        return False

    nt = bw * bh
    planes = 2 if blk.dual_plane else 1
    levels = np.array([ah.dequant_weight(c, blk.weight_ise_range)
                       for c in range(ah.ise_levels(blk.weight_ise_range))],
                      dtype=np.int64)                        # (L,)
    n_vals = ah.cem_num_values(blk.cems[0])
    subs = np.zeros(nt, dtype=np.int64)
    if blk.num_partitions > 1:
        small = nt < 31
        for y in range(bh):
            for x in range(bw):
                subs[y * bw + x] = T.astc_select_partition(
                    blk.partition_id, x, y, 0, blk.num_partitions, small)

    e0 = np.zeros((blk.num_partitions, 4), dtype=np.int64)
    e1 = np.zeros((blk.num_partitions, 4), dtype=np.int64)
    for s in range(blk.num_partitions):
        lo, hi = XC.decode_endpoints(
            blk.cems[s], blk.endpoints[s * n_vals:(s + 1) * n_vals],
            blk.endpoint_ise_range)
        e0[s] = lo
        e1[s] = hi

    l16 = _endpoint16(e0, srgb)                              # (S,4)
    h16 = _endpoint16(e1, srgb)
    # rec[l, s, c] for every weight level
    rec = ((l16[None] * (64 - levels)[:, None, None]
            + h16[None] * levels[:, None, None] + 32) >> 6) >> 8  # (L,S,4)

    srcf = src.astype(np.int64)                              # (nt,4)
    if not blk.dual_plane:
        diff = rec[:, subs, :] - srcf[None]                  # (L,nt,4)
        err = (diff * diff).sum(-1)                          # (L,nt)
        codes = err.argmin(0)                                # (nt,)
        blk.weights = [int(c) for c in codes]
        return True

    ccs = blk.ccs
    other = [c for c in range(4) if c != ccs]
    d0 = rec[:, subs][:, :, other] - srcf[None][:, :, other]
    codes0 = (d0 * d0).sum(-1).argmin(0)
    d1 = rec[:, subs, ccs] - srcf[None, :, ccs]
    codes1 = (d1 * d1).argmin(0)
    wts = [0] * (nt * 2)
    for t in range(nt):
        wts[2 * t] = int(codes0[t])
        wts[2 * t + 1] = int(codes1[t])
    blk.weights = wts
    return True


def refine_astc_blocks(blocks: np.ndarray, px: np.ndarray, bw: int, bh: int,
                       srgb: bool) -> np.ndarray:
    """(N,16) physical ASTC LDR blocks + (N, bh*bw, 4) source texels →
    (N,16) blocks with weights re-optimized for the actual decode."""
    from .hdr6x6_decode import pack_log_block

    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    out = blocks.copy()
    for i in range(blocks.shape[0]):
        blk = ah.unpack_block(blocks[i].tobytes(), bw, bh)
        if blk is None:
            continue
        if refine_log_block_weights(blk, px[i], bw, bh, srgb):
            out[i] = np.frombuffer(pack_log_block(blk), dtype=np.uint8)
    return out
