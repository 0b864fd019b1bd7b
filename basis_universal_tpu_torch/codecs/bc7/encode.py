"""bc7enc-class all-mode BC7 encoder: the batched search in PyTorch.

Counterpart of `basis_universal_tpu/codecs/bc7/encode.py` (behavioural
parity: encoder/basisu_bc7enc.h:42-131, bc7enc_compress_block; the all-mode
sweep of basisu_bc7e_scalar.cpp at effort 2). Every stage is a dense search
over (blocks x partitions x pbits) on the device of the pixels:

  - principal-axis endpoint seed per (block, partition, subset) by a
    covariance power iteration,
  - alternating least-squares refinement (weights -> 2x2 normal equations
    -> endpoints) with exact BC7 integer interpolation in the error,
  - per-endpoint pbit chosen by quantized-reconstruction error,
  - winner-take-all over the candidate modes, in float64 on the host.

The physical packers (`pack_mode*`), `_stack_subsets` and the winner pick of
`encode_blocks` are the reference's numpy code, unchanged.

Equivalences with the reference kept on purpose. Its search rounds float32
results to codes (an endpoint that is a whole number sits on a rounding tie
of the 7+1-bit quantizer), so the last bit of a sum can decide a block, and
the reference's bits are those of XLA's CPU code:
- every sum over the 16 pixels, the channels or the covariance is written
  out as additions in a fixed order, never a library reduction, so the CPU
  and the card give the same bits; the products inside a sum are fused
  multiply-adds (`_fma`, `_dot`), as XLA's CPU code contracts them, and so
  are `a*b - c*d` (the first product is the fused one), `mean + axis*t`,
  `1 - sel/levels` and `v*scale - pbit`;
- where one block's pixels meet all partitions the reference's product is
  a matrix product, summed in four interleaved accumulators (`_dot_mm`);
  its 16-long vector-vector product of the one-channel planes has an order
  of its own (`_dot_vec16`); the cross term of the least-squares solve is
  summed by a vector loop in the partition search (`_sum_tree16`) and with
  an unfused `1 - sel/levels` in the one-subset searches, because XLA
  compiles it together with the weights (`_ls_endpoints`);
- a division by a constant is the product with the float32 reciprocal, and
  two constant factors are one (`v * 127 / 255.0` is `v * (127 * (1/255))`
  in float32), as XLA's simplifier rewrites them;
- the square root is the correctly rounded one (`_sqrt`);
- `torch.round` and `jnp.round` both round half to even; `torch.argmin`
  takes the first minimum, as `jnp.argmin` does; the pbit search keeps the
  first combination on a tie;
- the integer quantizer and interpolation stay integer.
`tests/test_torch_bc7_encode.py` holds every function and `encode_blocks`
against the reference: with these the port gives the reference's blocks,
every one, and the card gives the CPU's.
"""

import functools

import numpy as np
import torch

from ...ops.etc1s_encode import exact_matmuls
from ...ops.xla_order import (_dot, _dot_mm, _dot_vec16, _fma, _sqrt, _sum,
                              _sum_tree16)
from ..etc1s.frontend import resolve_device
from . import logical as L

_T = L.tables()
_PARTITION2 = _T["partition2"].astype(np.int32)        # (64,16) subset ids
_ANCHOR2 = _T["anchor2"].astype(np.int32)              # (64,) subset-1 anchor
_PARTITION3 = _T["partition3"].astype(np.int32)        # (64,16) subset ids
_ANCHOR3A = _T["anchor3a"].astype(np.int32)            # (64,) subset-1 anchor
_ANCHOR3B = _T["anchor3b"].astype(np.int32)            # (64,) subset-2 anchor
_W2 = _T["weights2"].astype(np.int32)                  # (4,)
_W3 = _T["weights3"].astype(np.int32)                  # (8,)
_W4 = _T["weights4"].astype(np.int32)                  # (16,)

_INV255 = np.float32(1.0) / np.float32(255.0)


@functools.lru_cache(maxsize=None)
def _device_tables(device: str):
    """(partition2 (64,16), partition3 (64,16), weights2, weights3,
    weights4) as int64 tensors on `device`."""
    return tuple(torch.as_tensor(t.astype(np.int64), device=device)
                 for t in (_PARTITION2, _PARTITION3, _W2, _W3, _W4))


def _shared_pixels(px, mask):
    """True where one block's pixels serve many partitions (px (N,1,16,C)
    against mask (N,P,16)): the reference's products of such pixels with a
    per-partition vector are matrix products, summed as `_dot_mm` does."""
    return px.ndim == 4 and px.shape[1] == 1 and mask.shape[1] > 1


# --------------------------------------------------------------------------
# batched color-cell solver (the color_cell_compressor analog)
# --------------------------------------------------------------------------

def _principal_dir(px, mask):
    """(..., 16, C) pixels + (..., 16) mask -> (..., C) principal axis."""
    m = mask[..., None]
    cnt = torch.clamp(_sum(m, -2), min=1.0)
    mean = _sum(px * m, -2) / cnt
    d = (px - mean[..., None, :]) * m
    cov = _dot(d[..., :, None], d[..., None, :], -3)          # (..., C, C)
    # power iteration from the all-ones vector
    v = torch.ones(cov.shape[:-1], dtype=px.dtype, device=px.device)
    for _ in range(4):
        v = _dot(cov, v[..., None, :])
        norm = _sqrt(_dot(v, v))[..., None]
        v = v / torch.clamp(norm, min=1e-6)
    return v, mean


def _ls_endpoints(px, mask, t, one_minus_t=None):
    """Least-squares endpoints given soft weights t in [0,1]: the 2x2
    normal equations of min sum mask_i |px_i - ((1-t_i) lo + t_i hi)|^2."""
    dot_px = (_dot_mm if _shared_pixels(px, mask)
              else _dot_vec16 if px.shape[-1] == 1 else _dot)
    a = (1.0 - t if one_minus_t is None else one_minus_t) * mask
    b = t * mask
    saa = _dot(a, a)
    sbb = _dot(b, b)
    if one_minus_t is None:
        sab = _dot(a, b)
    elif _shared_pixels(px, mask):
        # inside the partition search the reference's compiler vectorizes
        # this one sum (its weights are computed in the same loop)
        sab = _sum_tree16(a * b)
    else:
        # inside the one-subset searches the same loop computes sel/levels
        # once for both factors, so 1 - sel/levels is not fused there
        sab = _dot((1.0 - t) * mask, b)
    sap = dot_px(a[..., None], px, -2)
    sbp = dot_px(b[..., None], px, -2)
    det = _fma(saa, sbb, -(sab * sab))
    safe = det.abs() > 1e-6
    det = torch.where(safe, det, 1.0)
    lo = _fma(sbb[..., None], sap, -(sab[..., None] * sbp)) / det[..., None]
    hi = _fma(saa[..., None], sbp, -(sab[..., None] * sap)) / det[..., None]
    # degenerate cell (all pixels one weight): keep the masked mean
    cnt = torch.clamp(_sum(mask, -1), min=1.0)
    mean = _sum(mask[..., None] * px, -2) / cnt[..., None]
    lo = torch.where(safe[..., None], lo, mean)
    hi = torch.where(safe[..., None], hi, mean)
    return torch.clamp(lo, 0.0, 255.0), torch.clamp(hi, 0.0, 255.0)


def _project_t(px, mask, lo, hi):
    axis = hi - lo
    len2 = torch.clamp(_dot(axis, axis), min=1e-6)
    dot_px = _dot_mm if _shared_pixels(px, mask) else _dot
    if px.shape[-1] == 1:
        # one channel: both products sit in one expression, and the first
        # is fused into the subtraction
        num = _fma(px[..., 0], axis, -(lo * axis))
    else:
        num = dot_px(px, axis[..., None, :]) - _dot(lo, axis)[..., None]
    t = num / len2[..., None]
    return torch.clamp(t, 0.0, 1.0) * mask


def _quant_channel(v, bits, pbit=None):
    """Quantize a 0-255 channel to `bits` (+ optional pbit); returns
    (code, reconstructed 0-255 value) with BC7's expand-to-8 dequant."""
    if pbit is None:
        scale = float(np.float32((1 << bits) - 1) * _INV255)
        q = torch.clamp(torch.round(v * scale), 0,
                        (1 << bits) - 1).to(torch.int32)
        total = bits
        x = q
    else:
        # value contributes bits+1 total; LSB is the shared/per-endpoint pbit
        scale = float(np.float32((1 << (bits + 1)) - 1) * _INV255)
        # v * scale - pbit is one fused multiply-add in the reference
        q = torch.clamp(torch.round(_fma(v, scale, -float(pbit)) * 0.5), 0,
                        (1 << bits) - 1).to(torch.int32)
        total = bits + 1
        x = (q << 1) | pbit
    if total >= 8:
        recon = x
    else:
        recon = (x << (8 - total)) | (x >> (2 * total - 8))
    return q, recon


def _interp(lo8, hi8, wsel, wtab):
    """Exact BC7 interpolation: (lo*(64-w) + hi*w + 32) >> 6."""
    w = wtab[wsel]
    return (lo8 * (64 - w[..., None]) + hi8 * w[..., None] + 32) >> 6


def _solve_cell(px, mask, nbits, iters=2):
    """Alternating LS solve for one weight width. Returns float endpoints
    and the final weight selectors (int32, 0..2^nbits-1)."""
    levels = (1 << nbits) - 1
    inv_levels = float(np.float32(1.0) / np.float32(levels))
    axis, mean = _principal_dir(px, mask)
    proj = _dot(px - mean[..., None, :], axis[..., None, :])
    inf = float("inf")
    tmin = torch.where(mask > 0, proj, inf).amin(-1)
    tmax = torch.where(mask > 0, proj, -inf).amax(-1)
    lo = torch.clamp(_fma(axis, tmin[..., None], mean), 0.0, 255.0)
    hi = torch.clamp(_fma(axis, tmax[..., None], mean), 0.0, 255.0)
    for _ in range(iters):
        t = _project_t(px, mask, lo, hi)
        sel = torch.round(t * levels)
        # 1 - sel/levels is one fused multiply-add in the reference
        lo, hi = _ls_endpoints(px, mask, sel * inv_levels,
                               _fma(-sel, inv_levels, 1.0))
    t = _project_t(px, mask, lo, hi)
    sel = torch.clamp(torch.round(t * levels), 0, levels).to(torch.int32)
    return lo, hi, sel


def _quant_cell(px, mask, lo, hi, sel0, cbits, nbits, wtab, pbit_mode,
                nchan, chan_w):
    """Quantize endpoints (searching pbits) + one selector reassignment
    against the EXACT reconstructed palette; returns
    (err, lo_codes, hi_codes, pbit_lo, pbit_hi, selectors).

    chan_w: (C,) channel weights, or (N, 1, 1, C) per block (mode 6)."""
    levels = (1 << nbits) - 1
    dev = px.device
    all_sel = torch.arange(levels + 1, device=dev)

    def recon_for(pl, ph):
        if pbit_mode == "none":
            ql, rl = _quant_channel(lo, cbits)
            qh, rh = _quant_channel(hi, cbits)
        elif pbit_mode == "shared":
            ql, rl = _quant_channel(lo, cbits, pl)
            qh, rh = _quant_channel(hi, cbits, pl)
        else:  # per-endpoint
            ql, rl = _quant_channel(lo, cbits, pl)
            qh, rh = _quant_channel(hi, cbits, ph)
        return ql, qh, rl, rh

    if pbit_mode == "none":
        combos = [(0, 0)]
    elif pbit_mode == "shared":
        combos = [(0, 0), (1, 1)]
    else:
        combos = [(0, 0), (0, 1), (1, 0), (1, 1)]

    best = None
    for pl, ph in combos:
        ql, qh, rl, rh = recon_for(pl, ph)
        pal = _interp(rl[..., None, :], rh[..., None, :], all_sel,
                      wtab).to(px.dtype)                      # (...,L+1,C)
        # reassign selectors against the exact palette; the squared
        # distances are summed channel by channel, so the largest
        # intermediate is (..., 16, L+1), not (..., 16, L+1, C)
        derr = None
        for c in range(px.shape[-1]):
            d = px[..., :, None, c] - pal[..., None, :, c]
            e = d * d * chan_w[..., c]
            derr = e if derr is None else derr + e
        sel = torch.argmin(derr, dim=-1)
        err = _sum(torch.gather(derr, -1, sel[..., None])[..., 0] * mask, -1)
        pack = (err, ql, qh,
                torch.full(err.shape, pl, dtype=torch.int32, device=dev),
                torch.full(err.shape, ph, dtype=torch.int32, device=dev),
                sel.to(torch.int32))
        if best is None:
            best = pack
        else:
            better = pack[0] < best[0]
            best = tuple(torch.where(
                better.reshape(better.shape + (1,) * (b.ndim - better.ndim)),
                p, b) for p, b in zip(pack, best))
    return best


# --------------------------------------------------------------------------
# per-mode searches (batched over N blocks)
# --------------------------------------------------------------------------

def _search_single_subset(px, cbits, abits, nbits, wtab, pbit_mode, chan_w):
    """Joint-RGBA single-subset search (mode 6). px (N,16,4). Mode 5's
    colour and alpha planes are solved separately by the caller."""
    mask = torch.ones(px.shape[:-1], dtype=px.dtype, device=px.device)
    lo, hi, sel = _solve_cell(px, mask, nbits)
    return _quant_cell(px, mask, lo, hi, sel, cbits, nbits, wtab,
                       pbit_mode, 4, chan_w)


def _search_two_subset(px, parts, cbits, nbits, wtab, pbit_mode, chan_w,
                       nchan):
    """Modes 1/7: search all 2-subset partitions (see _search_n_subset)."""
    return _search_n_subset(px, parts, 2, cbits, nbits, wtab, pbit_mode,
                            chan_w, nchan)


def _search_n_subset(px, parts, nsub, cbits, nbits, wtab, pbit_mode, chan_w,
                     nchan):
    """Modes 0/1/2/3/7: search all multi-subset partitions.

    px (N,16,C), parts (P,16) -> per-block best over (partition, subset
    solves). Returns (err, part_id, [per-subset (lo,hi,pbl,pbh,sel)],
    sel(16))."""
    px_b = px[:, None, :, :]                               # (N,1,16,C)
    errs = []
    packs = []
    for s in range(nsub):
        mask = (parts == s).to(px.dtype)[None]             # (1,P,16)
        mask = mask.expand((px.shape[0],) + mask.shape[1:])
        lo, hi, sel = _solve_cell(px_b, mask, nbits)
        err, ql, qh, pl, ph, sel = _quant_cell(
            px_b, mask, lo, hi, sel, cbits, nbits, wtab, pbit_mode,
            nchan, chan_w)
        errs.append(err)
        packs.append((ql, qh, pl, ph, sel))
    tot = _sum(torch.stack(errs, 0), 0)                    # (N,P)
    bp = torch.argmin(tot, dim=1)                          # (N,)
    berr = torch.gather(tot, 1, bp[:, None])[:, 0]

    def pick(x):
        idx = bp.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.gather(x, 1, idx.expand((-1, 1) + x.shape[2:]))[:, 0]

    out = []
    for s in range(nsub):
        out.append(tuple(pick(v) for v in packs[s]))
    # merge selectors by the winning partition's subset map
    submap = parts[bp]                                     # (N,16)
    sel = out[0][4]
    for s in range(1, nsub):
        sel = torch.where(submap == s, out[s][4], sel)
    return berr, bp.to(torch.int32), out, sel

# --------------------------------------------------------------------------
# host-side physical packing (vectorized per mode)
# --------------------------------------------------------------------------

class _VecPack:
    """128-bit LSB-first field packer over N blocks at once."""

    def __init__(self, n):
        self.lo = np.zeros(n, np.uint64)
        self.hi = np.zeros(n, np.uint64)
        self.pos = 0

    def put(self, value, nbits):
        v = np.asarray(value, np.uint64) & np.uint64((1 << nbits) - 1)
        p = self.pos
        if p < 64:
            self.lo |= v << np.uint64(p)
            if p + nbits > 64:
                self.hi |= v >> np.uint64(64 - p)
        else:
            self.hi |= v << np.uint64(p - 64)
        self.pos = p + nbits

    def bytes(self):
        assert self.pos == 128, self.pos
        out = np.empty((len(self.lo), 16), np.uint8)
        for b in range(8):
            out[:, b] = (self.lo >> np.uint64(8 * b)).astype(np.uint8)
            out[:, 8 + b] = (self.hi >> np.uint64(8 * b)).astype(np.uint8)
        return out


def _fix_anchors(sel, nbits, anchors, lo, hi, pbl, pbh, submap=None):
    """Flip (lo,hi, selectors) per subset where the anchor selector has its
    MSB set (BC7 spec: anchor weight MSB must be 0)."""
    n = sel.shape[0]
    levels = (1 << nbits) - 1
    nsub = lo.shape[1]
    for s in range(nsub):
        anchor_idx = anchors[s]                      # (N,)
        a_sel = sel[np.arange(n), anchor_idx]
        flip = a_sel >= (1 << (nbits - 1))
        if submap is None:
            in_sub = np.ones_like(sel, bool)
        else:
            in_sub = submap == s
        sel = np.where(flip[:, None] & in_sub, levels - sel, sel)
        lo[flip, s], hi[flip, s] = hi[flip, s].copy(), lo[flip, s].copy()
        pbl[flip, s], pbh[flip, s] = pbh[flip, s].copy(), pbl[flip, s].copy()
    return sel, lo, hi, pbl, pbh


def _put_weights_varpos(pk, sel, nbits, is_anchor):
    """Emit 16 selectors LSB-first where per-block anchor positions
    (is_anchor: (N,16) bool) use nbits-1 bits. Bit positions vary per
    block, so pack into a per-block big-int via numpy object-free math:
    accumulate into (lo,hi) manually with per-block shifts."""
    n = sel.shape[0]
    widths = np.where(is_anchor, nbits - 1, nbits).astype(np.uint64)
    start = np.zeros(n, np.uint64) + np.uint64(pk.pos)
    for i in range(16):
        v = sel[:, i].astype(np.uint64) & ((np.uint64(1) << widths[:, i])
                                           - np.uint64(1))
        p = start
        in_lo = p < 64
        sh = np.where(in_lo, p, np.uint64(0))
        pk.lo |= np.where(in_lo, v << sh, np.uint64(0))
        spill = in_lo & (p + widths[:, i] > 64)
        pk.lo = pk.lo  # no-op clarity
        pk.hi |= np.where(spill, v >> (np.uint64(64) - p), np.uint64(0))
        sh_hi = np.where(~in_lo, p - np.uint64(64), np.uint64(0))
        pk.hi |= np.where(~in_lo, v << sh_hi, np.uint64(0))
        start = p + widths[:, i]
    assert int(start.max()) <= 128 and int(start.min()) == int(start.max()), \
        "mode weight streams are fixed-length"
    pk.pos = int(start[0])


def pack_mode6(lo, hi, pbl, pbh, sel):
    """lo/hi (N,1,4) int codes 0..127, pbits (N,1), sel (N,16) 0..15."""
    n = lo.shape[0]
    sel, lo, hi, pbl, pbh = _fix_anchors(
        sel, 4, [np.zeros(n, np.int64)], lo, hi, pbl, pbh)
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 6, np.uint64), 7)           # mode 6 marker
    for c in range(4):
        pk.put(lo[:, 0, c], 7)
        pk.put(hi[:, 0, c], 7)
    pk.put(pbl[:, 0], 1)
    pk.put(pbh[:, 0], 1)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    _put_weights_varpos(pk, sel, 4, is_anchor)
    return pk.bytes()


def pack_mode1(part, lo, hi, pbl, pbh, sel):
    """part (N,), lo/hi (N,2,3) codes 0..63, shared pbit per subset in
    pbl (N,2), sel (N,16) 0..7."""
    n = lo.shape[0]
    submap = _PARTITION2[part]                         # (N,16)
    anchors = [np.zeros(n, np.int64), _ANCHOR2[part].astype(np.int64)]
    sel, lo, hi, pbl, pbh = _fix_anchors(sel, 3, anchors, lo, hi, pbl, pbh,
                                         submap)
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 1, np.uint64), 2)           # mode 1 marker
    pk.put(part, 6)
    for c in range(3):
        for s in (0, 1):
            pk.put(lo[:, s, c], 6)
            pk.put(hi[:, s, c], 6)
    pk.put(pbl[:, 0], 1)
    pk.put(pbl[:, 1], 1)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    is_anchor[np.arange(n), anchors[1]] = True
    _put_weights_varpos(pk, sel, 3, is_anchor)
    return pk.bytes()


def pack_mode7(part, lo, hi, pbl, pbh, sel):
    """part (N,), lo/hi (N,2,4) codes 0..31, per-endpoint pbits, sel 0..3."""
    n = lo.shape[0]
    submap = _PARTITION2[part]
    anchors = [np.zeros(n, np.int64), _ANCHOR2[part].astype(np.int64)]
    sel, lo, hi, pbl, pbh = _fix_anchors(sel, 2, anchors, lo, hi, pbl, pbh,
                                         submap)
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 7, np.uint64), 8)           # mode 7 marker
    pk.put(part, 6)
    for c in range(4):
        for s in (0, 1):
            pk.put(lo[:, s, c], 5)
            pk.put(hi[:, s, c], 5)
    for s in (0, 1):
        pk.put(pbl[:, s], 1)
        pk.put(pbh[:, s], 1)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    is_anchor[np.arange(n), anchors[1]] = True
    _put_weights_varpos(pk, sel, 2, is_anchor)
    return pk.bytes()


def pack_mode0(part, lo, hi, pbl, pbh, sel):
    """part (N,) 0..15, lo/hi (N,3,3) codes 0..15, per-endpoint pbits
    pbl/pbh (N,3), sel (N,16) 0..7."""
    n = lo.shape[0]
    submap = _PARTITION3[part]
    anchors = [np.zeros(n, np.int64), _ANCHOR3A[part].astype(np.int64),
               _ANCHOR3B[part].astype(np.int64)]
    sel, lo, hi, pbl, pbh = _fix_anchors(sel, 3, anchors, lo, hi, pbl, pbh,
                                         submap)
    pk = _VecPack(n)
    pk.put(np.full(n, 1, np.uint64), 1)                # mode 0 marker
    pk.put(part, 4)
    for c in range(3):
        for s in (0, 1, 2):
            pk.put(lo[:, s, c], 4)
            pk.put(hi[:, s, c], 4)
    for s in (0, 1, 2):
        pk.put(pbl[:, s], 1)
        pk.put(pbh[:, s], 1)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    is_anchor[np.arange(n), anchors[1]] = True
    is_anchor[np.arange(n), anchors[2]] = True
    _put_weights_varpos(pk, sel, 3, is_anchor)
    return pk.bytes()


def pack_mode2(part, lo, hi, sel):
    """part (N,) 0..63, lo/hi (N,3,3) codes 0..31, sel (N,16) 0..3."""
    n = lo.shape[0]
    submap = _PARTITION3[part]
    anchors = [np.zeros(n, np.int64), _ANCHOR3A[part].astype(np.int64),
               _ANCHOR3B[part].astype(np.int64)]
    z = np.zeros((n, 3), np.int64)
    sel, lo, hi, _, _ = _fix_anchors(sel, 2, anchors, lo, hi, z.copy(),
                                     z.copy(), submap)
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 2, np.uint64), 3)           # mode 2 marker
    pk.put(part, 6)
    for c in range(3):
        for s in (0, 1, 2):
            pk.put(lo[:, s, c], 5)
            pk.put(hi[:, s, c], 5)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    is_anchor[np.arange(n), anchors[1]] = True
    is_anchor[np.arange(n), anchors[2]] = True
    _put_weights_varpos(pk, sel, 2, is_anchor)
    return pk.bytes()


def pack_mode3(part, lo, hi, pbl, pbh, sel):
    """part (N,), lo/hi (N,2,3) codes 0..127, per-endpoint pbits, sel 0..3."""
    n = lo.shape[0]
    submap = _PARTITION2[part]
    anchors = [np.zeros(n, np.int64), _ANCHOR2[part].astype(np.int64)]
    sel, lo, hi, pbl, pbh = _fix_anchors(sel, 2, anchors, lo, hi, pbl, pbh,
                                         submap)
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 3, np.uint64), 4)           # mode 3 marker
    pk.put(part, 6)
    for c in range(3):
        for s in (0, 1):
            pk.put(lo[:, s, c], 7)
            pk.put(hi[:, s, c], 7)
    for s in (0, 1):
        pk.put(pbl[:, s], 1)
        pk.put(pbh[:, s], 1)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    is_anchor[np.arange(n), anchors[1]] = True
    _put_weights_varpos(pk, sel, 2, is_anchor)
    return pk.bytes()


def pack_mode4(idx_sel, lo, hi, alo, ahi, csel, asel):
    """Mode 4, rotation 0. lo/hi (N,1,3) codes 0..31, alo/ahi (N,) codes
    0..63; csel/asel are the color/alpha weight selectors. idx_sel (N,)
    chooses which plane rides the 3-bit index1 stream (0: alpha, 1: color);
    the corresponding selector array must already be 0..7, the other 0..3."""
    n = lo.shape[0]
    zero = np.zeros((n, 1), np.int64)
    cb = np.where(idx_sel == 1, 3, 2)
    ab = np.where(idx_sel == 1, 2, 3)
    # anchor-flip per plane (MSB of each plane's own bit width)
    a_csel = csel[:, 0]
    cflip = a_csel >= (1 << (cb - 1))
    csel = np.where(cflip[:, None], ((1 << cb) - 1)[:, None] - csel, csel)
    lo, hi = (np.where(cflip[:, None, None], hi, lo),
              np.where(cflip[:, None, None], lo, hi))
    a_asel = asel[:, 0]
    aflip = a_asel >= (1 << (ab - 1))
    asel = np.where(aflip[:, None], ((1 << ab) - 1)[:, None] - asel, asel)
    alo, ahi = np.where(aflip, ahi, alo), np.where(aflip, alo, ahi)
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 4, np.uint64), 5)           # mode 4 marker
    pk.put(np.zeros(n, np.uint64), 2)                  # rotation 0
    pk.put(idx_sel.astype(np.uint64), 1)
    for c in range(3):
        pk.put(lo[:, 0, c], 5)
        pk.put(hi[:, 0, c], 5)
    pk.put(alo, 6)
    pk.put(ahi, 6)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    sel0 = np.where(idx_sel[:, None] == 1, asel, csel)   # 2-bit stream
    sel1 = np.where(idx_sel[:, None] == 1, csel, asel)   # 3-bit stream
    _put_weights_varpos(pk, sel0, 2, is_anchor)
    _put_weights_varpos(pk, sel1, 3, is_anchor)
    return pk.bytes()


def pack_mode5(lo, hi, alo, ahi, csel, asel):
    """Color lo/hi (N,1,3) codes 0..127, alpha endpoints 0..255,
    csel/asel (N,16) 0..3. Rotation fixed at 0 (matches
    ops/transcode.rgba_blocks_to_bc7_m5)."""
    n = lo.shape[0]
    zero = np.zeros((n, 1), np.int64)
    csel, lo, hi, _, _ = _fix_anchors(
        csel, 2, [np.zeros(n, np.int64)], lo, hi, zero.copy(), zero.copy())
    a_lo = alo[:, None, None]
    a_hi = ahi[:, None, None]
    asel, a_lo, a_hi, _, _ = _fix_anchors(
        asel, 2, [np.zeros(n, np.int64)], a_lo, a_hi, zero.copy(),
        zero.copy())
    pk = _VecPack(n)
    pk.put(np.full(n, 1 << 5, np.uint64), 6)           # mode 5 marker
    pk.put(np.zeros(n, np.uint64), 2)                  # rotation 0
    for c in range(3):
        pk.put(lo[:, 0, c], 7)
        pk.put(hi[:, 0, c], 7)
    pk.put(a_lo[:, 0, 0], 8)
    pk.put(a_hi[:, 0, 0], 8)
    is_anchor = np.zeros((n, 16), bool)
    is_anchor[:, 0] = True
    _put_weights_varpos(pk, csel, 2, is_anchor)
    _put_weights_varpos(pk, asel, 2, is_anchor)
    return pk.bytes()


# --------------------------------------------------------------------------
# top level
# --------------------------------------------------------------------------

# blocks per pass of the device search. Every result is per block, so the
# size changes no bit. What bounds it is the memory of the 64-partition
# modes, whose largest live tensors are the (chunk, 64, 16, L+1) float32
# distances of `_quant_cell` and the float64 temporaries of the fused
# multiply-adds over (chunk, 64, 16, C): an NVIDIA H100 80GB HBM3 peaked at
# 1.67 GB for 8,192 blocks at effort 2 (`chip_smoke.py`), about 0.2 MB per
# block. 32,768 blocks keep a 768x512 image (24,576 blocks, ~5 GB) in one
# pass, which launches a third of the operators three passes would.
_CHUNK = 32768


def _search_impl(px, perceptual: bool, all_modes: bool, max_parts: int):
    """The candidate searches for (N,16,4) float32 pixels, in the
    reference's order: modes 6, 1, 7, 5, and with `all_modes` also 0, 2, 3
    and both index selectors of mode 4. Returns a tuple of per-mode tuples
    of tensors, each leading with the mode's error (N,)."""
    dev = px.device
    parts2, parts3, w2, w3, w4 = _device_tables(str(dev))
    parts, parts3 = parts2[:max_parts], parts3[:max_parts]
    chan_w = torch.tensor([0.5, 1.0, 0.25, 1.0] if perceptual
                          else [1.0, 1.0, 1.0, 1.0], device=dev)
    # mode 6: joint RGBA, 4-bit weights, per-endpoint pbits. Opaque blocks
    # must reconstruct A=255 exactly: a heavy alpha weight makes the pbit
    # search always land on the exact (1,1) combination there.
    opaque = torch.all(px[..., 3] == 255.0, dim=-1)
    heavy = chan_w.clone()
    heavy[3] = 4096.0
    chan_w6 = torch.where(opaque[:, None, None, None], heavy, chan_w)
    e6, l6, h6, pl6, ph6, s6 = _search_single_subset(
        px, 7, None, 4, w4, "per", chan_w6)
    # mode 1: RGB only, 3-bit weights, shared pbit
    rgb = px[..., :3]
    e1, p1, sub1, s1 = _search_two_subset(
        rgb, parts, 6, 3, w3, "shared", chan_w[:3], 3)
    # mode 1 ignores alpha: add the alpha error against 255 so the
    # winner-take-all stays honest on alpha blocks
    da = px[..., 3] - 255.0
    aerr = _sum(da * da * chan_w[3], -1)
    # mode 7: RGBA, 2-bit weights, per-endpoint pbits
    e7, p7, sub7, s7 = _search_two_subset(
        px, parts, 5, 2, w2, "per", chan_w, 4)
    # mode 5: separate colour (7 bpc) / alpha (8) planes, 2-bit weights
    mask1 = torch.ones(px.shape[:-1], dtype=px.dtype, device=dev)
    lo5, hi5, _ = _solve_cell(rgb, mask1, 2)
    ec5, ql5, qh5, _, _, cs5 = _quant_cell(
        rgb, mask1, lo5, hi5, None, 7, 2, w2, "none", 3, chan_w[:3])
    a = px[..., 3:]
    alo, ahi, _ = _solve_cell(a, mask1, 2)
    ea5, qal, qah, _, _, as5 = _quant_cell(
        a, mask1, alo, ahi, None, 8, 2, w2, "none", 1, chan_w[3:])
    e5 = ec5 + ea5
    out = [(e6, l6, h6, pl6, ph6, s6),
           (e1 + aerr, p1, sub1, s1),
           (e7, p7, sub7, s7),
           (e5, ql5, qh5, qal[..., 0], qah[..., 0], cs5, as5)]
    if not all_modes:
        return tuple(out)
    # mode 0: 3 subsets over the first 16 partitions, RGB 4+pbit per
    # endpoint, 3-bit weights
    e0, p0, sub0, s0 = _search_n_subset(
        rgb, parts3[:16], 3, 4, 3, w3, "per", chan_w[:3], 3)
    # mode 2: 3 subsets, RGB 5, no pbits, 2-bit weights
    e2, p2, sub2, s2 = _search_n_subset(
        rgb, parts3, 3, 5, 2, w2, "none", chan_w[:3], 3)
    # mode 3: 2 subsets, RGB 7+pbit per endpoint, 2-bit weights
    e3, p3, sub3, s3 = _search_n_subset(
        rgb, parts, 2, 7, 2, w2, "per", chan_w[:3], 3)
    # mode 4 (rotation 0): colour 5b / alpha 6b planes; both index
    # selectors tried (which plane rides the 3-bit stream)
    lo4a, hi4a, _ = _solve_cell(rgb, mask1, 2)
    ec4a, qc4al, qc4ah, _, _, cs4a = _quant_cell(
        rgb, mask1, lo4a, hi4a, None, 5, 2, w2, "none", 3, chan_w[:3])
    lo4b, hi4b, _ = _solve_cell(rgb, mask1, 3)
    ec4b, qc4bl, qc4bh, _, _, cs4b = _quant_cell(
        rgb, mask1, lo4b, hi4b, None, 5, 3, w3, "none", 3, chan_w[:3])
    alo4, ahi4, _ = _solve_cell(a, mask1, 3)
    ea4a, qa4al, qa4ah, _, _, as4a = _quant_cell(
        a, mask1, alo4, ahi4, None, 6, 3, w3, "none", 1, chan_w[3:])
    alo4b, ahi4b, _ = _solve_cell(a, mask1, 2)
    ea4b, qa4bl, qa4bh, _, _, as4b = _quant_cell(
        a, mask1, alo4b, ahi4b, None, 6, 2, w2, "none", 1, chan_w[3:])
    e4_s0 = ec4a + ea4a         # idx_sel 0: colour 2-bit, alpha 3-bit
    e4_s1 = ec4b + ea4b         # idx_sel 1: colour 3-bit, alpha 2-bit
    out += [(e0 + aerr, p0, sub0, s0), (e2 + aerr, p2, sub2, s2),
            (e3 + aerr, p3, sub3, s3),
            (e4_s0, qc4al, qc4ah, qa4al[..., 0], qa4ah[..., 0],
             cs4a, as4a),
            (e4_s1, qc4bl, qc4bh, qa4bl[..., 0], qa4bh[..., 0],
             cs4b, as4b)]
    return tuple(out)


def _flatten(tree, leaves):
    """Nested tuples/lists of tensors -> the same nesting of indices into
    `leaves`, which gains the tensors in order."""
    if isinstance(tree, (tuple, list)):
        return tuple(_flatten(v, leaves) for v in tree)
    leaves.append(tree)
    return len(leaves) - 1


def _search(px_u8: np.ndarray, perceptual: bool, all_modes: bool,
            max_parts: int, dev: torch.device):
    """Run the device search over all blocks in chunks and bring the
    results to the host: per chunk one float32 copy (the errors, one column
    per candidate) and one uint8 copy (every code, pbit, partition id and
    selector: all are below 256). Returns the reference's nesting of numpy
    arrays (float32 errors, int32 everything else)."""
    floats, ints = [], []
    spec = shapes = None
    with exact_matmuls():
        for ofs in range(0, px_u8.shape[0], _CHUNK):
            px = torch.as_tensor(px_u8[ofs:ofs + _CHUNK]).to(dev).float()
            leaves = []
            spec = _flatten(
                _search_impl(px, perceptual, all_modes, max_parts), leaves)
            n = px.shape[0]
            shapes = [(x.is_floating_point(), x.shape[1:]) for x in leaves]
            floats.append(torch.stack(
                [x for x in leaves if x.is_floating_point()], 1).cpu())
            ints.append(torch.cat(
                [x.reshape(n, -1).to(torch.uint8) for x in leaves
                 if not x.is_floating_point()], 1).cpu())
    fl = torch.cat(floats, 0).numpy()
    it = torch.cat(ints, 0).numpy().astype(np.int32)
    host, fi, ii = [], 0, 0
    for is_float, shape in shapes:
        if is_float:
            host.append(fl[:, fi])
            fi += 1
        else:
            width = int(np.prod(shape, dtype=np.int64))
            host.append(it[:, ii:ii + width].reshape((-1,) + tuple(shape)))
            ii += width

    def rebuild(s):
        return tuple(rebuild(v) for v in s) if isinstance(s, tuple) \
            else host[s]

    return rebuild(spec)


def _stack_subsets(sub, m, nsub, with_pbits=True):
    lo = np.stack([sub[s][0][m] for s in range(nsub)], 1)
    hi = np.stack([sub[s][1][m] for s in range(nsub)], 1)
    if not with_pbits:
        return lo, hi
    pbl = np.stack([sub[s][2][m] for s in range(nsub)], 1)
    pbh = np.stack([sub[s][3][m] for s in range(nsub)], 1)
    return lo, hi, pbl, pbh


def encode_blocks(pixels, effort: int = 2, perceptual: bool = False,
                  modes=None, device="cuda") -> np.ndarray:
    """(N,16,4) uint8 RGBA -> (N,16) uint8 physical BC7 blocks; the search
    runs on `device`.

    effort 0-1: modes 6+1(16 partitions) (+5/7 on alpha); 2+: the bc7e
    all-mode sweep, which adds modes 0/2/3/4 and the full 64-partition
    search (basisu_bc7e_scalar.cpp's per-mode trials as one batched pass)."""
    px = np.ascontiguousarray(np.asarray(pixels, np.uint8).reshape(-1, 16, 4))
    n = px.shape[0]
    all_modes = effort >= 2 if modes is None else bool(
        set(modes) & {0, 2, 3, 4})
    max_parts = 64 if effort >= 2 else 16
    outs = _search(px, bool(perceptual), all_modes, max_parts,
                   resolve_device(device))
    out6, out1, out7, out5 = outs[:4]
    has_alpha = (px[..., 3] != 255).any(-1)
    big = np.float64(1e30)

    # candidate order: [6, 1, 7, 5, 0, 2, 3, 4(idx0), 4(idx1)]
    errs = [out6[0], out1[0], out7[0], out5[0]]
    cand_mode = [6, 1, 7, 5]
    if all_modes:
        out0, out2, out3, out4a, out4b = outs[4:]
        errs += [out0[0], out2[0], out3[0], out4a[0], out4b[0]]
        cand_mode += [0, 2, 3, 4, 4]
    errs = [e.astype(np.float64).copy() for e in errs]
    if modes is not None:
        for i, m in enumerate(cand_mode):
            if m not in modes:
                errs[i][:] = big
    else:
        # opaque blocks stick to the RGB-only / pinned-alpha modes
        # (bc7enc_compress_block's opaque path, basisu_bc7enc.h:79):
        # modes 4/5/7 there could drift A off 255
        for i, m in enumerate(cand_mode):
            if m in (4, 5, 7):
                errs[i] = np.where(has_alpha, errs[i], big)
    cand = np.stack(errs, axis=0)
    pick = np.argmin(cand, axis=0)

    blocks = np.empty((n, 16), np.uint8)
    m = pick == 0
    if m.any():
        _, l6, h6, pl6, ph6, s6 = out6
        blocks[m] = pack_mode6(l6[m][:, None, :], h6[m][:, None, :],
                               pl6[m][:, None], ph6[m][:, None], s6[m])
    m = pick == 1
    if m.any():
        _, p1, sub1, s1 = out1
        lo, hi, pb, _ = _stack_subsets(sub1, m, 2)
        blocks[m] = pack_mode1(p1[m], lo, hi, pb, pb.copy(), s1[m])
    m = pick == 2
    if m.any():
        _, p7, sub7, s7 = out7
        lo, hi, pbl, pbh = _stack_subsets(sub7, m, 2)
        blocks[m] = pack_mode7(p7[m], lo, hi, pbl, pbh, s7[m])
    m = pick == 3
    if m.any():
        _, ql5, qh5, qal, qah, cs5, as5 = out5
        blocks[m] = pack_mode5(ql5[m][:, None, :], qh5[m][:, None, :],
                               qal[m], qah[m], cs5[m], as5[m])
    if all_modes:
        m = pick == 4
        if m.any():
            _, p0, sub0, s0 = out0
            lo, hi, pbl, pbh = _stack_subsets(sub0, m, 3)
            blocks[m] = pack_mode0(p0[m], lo, hi, pbl, pbh, s0[m])
        m = pick == 5
        if m.any():
            _, p2, sub2, s2 = out2
            lo, hi = _stack_subsets(sub2, m, 3, with_pbits=False)
            blocks[m] = pack_mode2(p2[m], lo, hi, s2[m])
        m = pick == 6
        if m.any():
            _, p3, sub3, s3 = out3
            lo, hi, pbl, pbh = _stack_subsets(sub3, m, 2)
            blocks[m] = pack_mode3(p3[m], lo, hi, pbl, pbh, s3[m])
        for pick_id, out4, isel in ((7, out4a, 0), (8, out4b, 1)):
            m = pick == pick_id
            if m.any():
                _, qcl, qch, qal4, qah4, cs4, as4 = out4
                blocks[m] = pack_mode4(
                    np.full(int(m.sum()), isel, np.int64),
                    qcl[m][:, None, :], qch[m][:, None, :],
                    qal4[m], qah4[m], cs4[m], as4[m])
    return blocks
