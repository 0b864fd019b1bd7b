"""UASTC LDR 4x4 encoder, device half: the batched mode search in PyTorch.

Counterpart of `basis_universal_tpu/codecs/uastc/encode.py`. Every candidate
mode is evaluated for every block as dense tensor math on the device of the
pixels (principal-axis endpoints, least-squares refinement, the argmin over
all weight levels), one argmin per block picks the winner on the device,
and `pack.uastc_pack` writes the blocks from its (B, 59) uint8 winner
buffer on the same device (a kernel on the card); only the (B, 16) blocks
come back to the host.

Equivalences with the reference kept on purpose:
- the float32 operations that decide a rounding are the reference's as XLA
  runs them: `_rec16` is `(acc*257 + 32) * (1/16384)`, and a mean over the
  three colour channels is their sum times float32(1/3) (XLA turns the
  division by the constant 3 into that product; `torch.mean` divides);
- the partition shortlists are a stable descending sort: `lax.top_k` keeps
  the lower index first at equal scores, and the scores are agreement
  counts, so ties are the norm; `torch.topk` promises no order;
- the sums that place the 1-D k-means centres of the partition search add
  the 16 pixels one after another, as XLA's CPU reduction does (`_sum16`):
  pixels nearly equidistant from two centres are common there, and a
  centre one ulp away moves them to the other side;
- argmins take the first minimum, as in JAX;
- no reduction whose result can round is left to a library call (their
  summation orders differ between the CPU and the card): the covariances,
  power iterations, projections and least-squares moments are fused
  multiply-add chains in index order (`xla_order._dot`), norms and the
  sums of non-integer errors add in index order (`_sum`), square roots are
  correctly rounded (`_sqrt`); sums of whole numbers are exact in any order
  and stay library reductions. So the card gives the CPU's bits;
- the products XLA's compiled search fuses into their sums are fused here
  too (`_fma`: the endpoints on the principal axis, `_rec16_fused` for
  unquantized endpoints, the least-squares solve), so the CPU gives the
  blocks of the reference as `compressor.compress` runs it, jitted (its
  eager, op-by-op run rounds otherwise);
- each mode trial is one launch on the card, a lane per pixel, the same
  roundings as its plain version's chains: a single-subset trial
  (`_mode_trial`: `uastc_mode_trial`), a 2- or 3-subset trial
  (`subset_trial`: `uastc_subset_trial`) and a dual-plane trial
  (`dualplane_trial`: `uastc_dualplane_trial`), all of
  `csrc/xla_order_kernels.cu`, whose fits are the masked line fit of
  `line_fit` (`uastc_line_fit`, no longer on the search's path);
- the ETC1 transcode hint is the port's ETC1S `encode_blocks` at radius 0
  (the hand-written `factorized_scan` and `palette_errs_packed` kernels);
- the search runs inside `exact_matmuls()` (no TF32).
"""

import functools

import numpy as np
import torch

from ...ops import etc1s_encode as etc1s_ops
from ...ops import xla_order
from ...ops.cuda_etc1s import LAUNCHES, THIRD, _raise_on
from ...ops.xla_order import _dot, _fma, _sqrt, _sum
from ..etc1s.frontend import resolve_device
from . import pack
from . import tables as T

_INV64 = 1.0 / 64.0


# ---------------------------------------------------------------------------
# the line fits, one launch each on the card
# ---------------------------------------------------------------------------

def line_fit(v, label, n_sub: int, levels, ls_iters: int):
    """The endpoints (lo, hi), (B, S, C) each, of `_fit_line_masked` on each
    subset s < n_sub (1..3) of the pixels v (B, 16, C), C 1..4, any strides:
    the pixels whose label (B, 16) int64 is s (None: every pixel is 0), the
    weight levels `levels` (L,), L <= 32, and ls_iters least-squares steps.
    A CUDA tensor launches `uastc_line_fit` (`csrc/xla_order_kernels.cu`), one
    launch for all subsets, a lane per pixel: one launch for the ~50
    operators of each subset's plain version (`line_fit_reference`)."""
    if not v.is_cuda:
        return line_fit_reference(v, label, n_sub, levels, ls_iters)
    b_n, p_n, n_ch = v.shape
    if p_n != 16 or not 1 <= n_ch <= 4 or v.dtype != torch.float32 \
            or not 1 <= n_sub <= 3:
        raise ValueError(f"line_fit: v (B, 16, 1..4) float32 and 1..3 "
                         f"subsets, got {tuple(v.shape)} {v.dtype}, {n_sub}")
    _check_levels(levels, v.device)
    if label is not None and (label.dtype != torch.int64
                              or tuple(label.shape) != (b_n, 16)
                              or label.device != v.device
                              or not label.is_contiguous()):
        raise ValueError(f"line_fit: label (B, 16) int64 contiguous on "
                         f"{v.device}, got {tuple(label.shape)} {label.dtype}")
    lo = torch.empty((b_n, n_sub, n_ch), dtype=torch.float32, device=v.device)
    hi = torch.empty_like(lo)
    status = xla_order.launch(
        "line_fit", v.device.index, v.data_ptr(), *v.stride(),
        None if label is None else label.data_ptr(), n_sub,
        levels.data_ptr(), levels.numel(), ls_iters, lo.data_ptr(),
        hi.data_ptr(), b_n, n_ch)
    LAUNCHES["uastc_line_fit"] += 1
    _raise_on(status, "uastc_line_fit")
    return lo, hi


def line_fit_reference(v, label, n_sub: int, levels, ls_iters: int):
    """Plain version of `line_fit`, on any device: `_fit_line_masked` of
    each subset (its mask label == s), the endpoints stacked."""
    if label is None:
        label = torch.zeros(v.shape[:2], dtype=torch.int64, device=v.device)
    fits = [_fit_line_masked(v, (label == s).float(), levels, ls_iters)
            for s in range(n_sub)]
    return (torch.stack([f[0] for f in fits], 1),
            torch.stack([f[1] for f in fits], 1))


def _check_levels(levels, dev):
    if levels.dtype != torch.float32 or levels.dim() != 1 \
            or not 1 <= levels.numel() <= 32 or levels.device != dev \
            or not levels.is_contiguous():
        raise ValueError(f"weight levels: (1..32,) float32 contiguous on "
                         f"{dev}, got {tuple(levels.shape)} {levels.dtype} "
                         f"on {levels.device}")


def principal_axis_reference(c, iters: int):
    """The power iteration of the line fits, on any device: the covariance
    of the centred pixels c (B, 16, C) as fused multiply-add chains over
    the pixels (`_dot`), then `iters` times axis = cov axis (`_dot`)
    divided by its norm (the squares rounded and added in index order,
    `_sum`; a correctly rounded square root, `_sqrt`) plus 1e-6, from the
    all-ones axis; the (B, C) axis and the (B, 16) projections of c on it
    as `_dot` chains, rounded as the reference's compiled line fits round
    them."""
    cov = _dot(c[:, :, :, None], c[:, :, None, :], 1)           # (B,C,C)
    axis = torch.ones((c.shape[0], c.shape[2]), dtype=torch.float32,
                      device=c.device)
    for _ in range(iters):
        axis = _dot(cov, axis[:, None, :])
        axis = axis / (_sqrt(_sum(axis * axis, -1))[:, None] + 1e-6)
    return axis, _dot(c, axis[:, None, :])


def ls_step_reference(wl, mask, v, lo, hi):
    """One least-squares step of the line fits, on any device: the
    endpoints (lo_n, hi_n), (B, C) each, clamped to 0..255, that fit v (B,
    16, C) best under the weights wl (B, 16), whole numbers 0..64 (the
    weight levels), with each pixel's share `mask` (B, 16) of 0 / 1 or None
    (all), and lo / hi where the 2x2 system is singular: the weights a =
    (64 - wl) / 64 and b = wl / 64 (times the mask), their moments A, B, C
    (sums of multiples of 1/4096: exact in any order), P = sum a v and Q =
    sum b v as `_dot` chains over the pixels, then the solve as XLA's CPU
    code rounds it, each difference of products a fused multiply-add."""
    a_k = (64.0 - wl) * _INV64
    b_k = wl * _INV64
    if mask is not None:
        a_k, b_k = a_k * mask, b_k * mask
    A = (a_k * a_k).sum(1)
    Bm = (a_k * b_k).sum(1)
    C = (b_k * b_k).sum(1)
    P = _dot(a_k[..., None], v, 1)
    Q = _dot(b_k[..., None], v, 1)
    det = _fma(A, C, -(Bm * Bm))
    ok = det.abs() > 1e-6
    dd = torch.where(ok, det, 1.0)[:, None]
    c, bm, a = C[:, None], Bm[:, None], A[:, None]
    lo_n = torch.where(ok[:, None], _fma(c, P, -(bm * Q)) / dd, lo)
    hi_n = torch.where(ok[:, None], _fma(a, Q, -(bm * P)) / dd, hi)
    return torch.clamp(lo_n, 0, 255), torch.clamp(hi_n, 0, 255)


def _rec16(acc):
    """Integer-exact reconstruction from acc = lo*(64-w) + hi*w: the
    decoder's ((lo*257)*(64-w) + (hi*257)*w + 32) >> 6 >> 8, exact in
    float32 written this way (acc*257 <= 2^22)."""
    return torch.floor((acc * 257.0 + 32.0) * (1.0 / 16384.0))


def _rec16_fused(lo, hi, levels):
    """`_rec16` of lo*(64-w) + hi*w for float (unquantized) endpoints, with
    the two fused multiply-adds XLA's CPU code makes of it: acc =
    fma(64-w, lo, hi*w), then fma(acc, 257, 32)."""
    acc = _fma(64.0 - levels, lo, hi * levels)
    return torch.floor(_fma(acc, 257.0, 32.0) * (1.0 / 16384.0))


def _mean3(x):
    """Mean over a trailing axis of 3, rounded as the reference's."""
    return x.sum(-1) * THIRD


def _sum16(x):
    """Sum over axis 1 (the 16 pixels), added in pixel order; keepdim."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc[:, None]


def _weight_levels(wb: int) -> np.ndarray:
    return T.weight_unquant_table(wb).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mode_consts(wb: int, ep_range: int, device: str):
    """(inverse LUT target->code (256,) int64, code->unquantized (N,) f32,
    weight levels (L,) f32) on `device`."""
    inv, unq = pack.quant_luts(ep_range)
    return (torch.as_tensor(inv, dtype=torch.int64, device=device),
            torch.as_tensor(unq.astype(np.float32), device=device),
            torch.as_tensor(_weight_levels(wb), device=device))


@functools.lru_cache(maxsize=None)
def _patterns(subsets: int, mode7: bool, device: str):
    """(P, 16) int64 common partition patterns of the 2- or 3-subset modes
    (mode 7 pairs its ASTC patterns with BC7 3-subset ones)."""
    if subsets == 3:
        seeds = [seed for (_b, seed, _i) in T.ASTC_BC7_COMMON_PARTITIONS3]
    elif mode7:
        seeds = pack._mode7_seeds()
    else:
        seeds = [seed for (_b, seed, _i) in T.ASTC_BC7_COMMON_PARTITIONS2]
    pats = np.array([T.partition_pattern(seed, subsets) for seed in seeds],
                    dtype=np.int64)
    return torch.as_tensor(pats, device=device)


def _quant(inv, x):
    """Endpoint codes of float endpoints: round, clip to 0..255, LUT."""
    return inv[torch.clamp(torch.round(x), 0, 255).long()]


def _shortlist_desc(score, k: int):
    """Indices of the k largest scores per row, equal scores by ascending
    index (the order of `lax.top_k`)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k]


def _alpha_err(px):
    return ((px[..., 3] - 255.0) ** 2).sum(-1)


def _la(px):
    """(luma, alpha) channels of the LA modes, (B, 16, 2)."""
    return torch.stack([(px[..., 0] + px[..., 1] + px[..., 2]) * THIRD,
                        px[..., 3]], -1)


def _mode_trial(px, wb: int, ep_range: int, comps: int, ls_iters: int):
    """Evaluate one single-subset single-plane mode for all blocks.

    px: (B,16,4) f32, whole numbers 0..255. Returns (err (B,), ep_codes (B,
    comps*2) int32, weights (B,16) int32). comps 3 -> RGB (alpha forced
    255), 4 -> RGBA, 2 -> LA. A CUDA tensor launches `uastc_mode_trial`
    (`csrc/xla_order_kernels.cu`), the whole trial in one launch, a lane per
    block for its serial work and a lane per pixel for the searches; a CPU
    tensor runs `mode_trial_reference`.
    """
    if not px.is_cuda:
        return mode_trial_reference(px, wb, ep_range, comps, ls_iters)
    b_n = px.shape[0]
    if tuple(px.shape[1:]) != (16, 4) or px.dtype != torch.float32 \
            or comps not in (2, 3, 4):
        raise ValueError(f"_mode_trial: px (B, 16, 4) float32 and comps "
                         f"2..4, got {tuple(px.shape)} {px.dtype}, {comps}")
    inv, unq, wlev = _mode_consts(wb, ep_range, str(px.device))
    _check_levels(wlev, px.device)
    err = torch.empty(b_n, dtype=torch.float32, device=px.device)
    ep = torch.empty((b_n, 2 * comps), dtype=torch.int32, device=px.device)
    w = torch.empty((b_n, 16), dtype=torch.int32, device=px.device)
    status = xla_order.launch(
        "mode_trial", px.device.index, px.data_ptr(), *px.stride(),
        inv.data_ptr(), unq.data_ptr(), unq.numel(), wlev.data_ptr(),
        wlev.numel(), comps, ls_iters, err.data_ptr(), ep.data_ptr(),
        w.data_ptr(), b_n)
    LAUNCHES["uastc_mode_trial"] += 1
    _raise_on(status, "uastc_mode_trial")
    return err, ep, w


def mode_trial_reference(px, wb: int, ep_range: int, comps: int,
                         ls_iters: int):
    """Plain version of `_mode_trial`, on any device."""
    b = px.shape[0]
    inv, unq, wlev = _mode_consts(wb, ep_range, str(px.device))
    v = _la(px) if comps == 2 else px[..., :comps]

    # principal axis by power iteration on the covariance
    mean = _sum(v, 1)[:, None] / 16.0
    c = v - mean
    axis, proj = principal_axis_reference(c, 6)                # (B,C), (B,16)
    lo_f = _fma(axis, proj.amin(1, keepdim=True), mean[:, 0])
    hi_f = _fma(axis, proj.amax(1, keepdim=True), mean[:, 0])

    def quant_pair(lo_f, hi_f):
        lo_c, hi_c = _quant(inv, lo_f), _quant(inv, hi_f)
        return lo_c, hi_c, unq[lo_c], unq[hi_c]

    def best_weights(lo_u, hi_u):
        # reconstruction for every weight level: (B,L,comps)
        rec = _rec16(lo_u[:, None, :] * (64.0 - wlev)[None, :, None]
                     + hi_u[:, None, :] * wlev[None, :, None])
        d = v[:, :, None, :] - rec[:, None, :, :]               # (B,16,L,C)
        e = _sum(d * d, -1)
        return torch.argmin(e, -1), _sum(e.amin(-1), -1)

    lo_c, hi_c, lo_u, hi_u = quant_pair(lo_f, hi_f)
    w, err = best_weights(lo_u, hi_u)

    for _ in range(ls_iters):
        # least-squares endpoints given the weights
        lo_c2, hi_c2, lo_u2, hi_u2 = quant_pair(
            *ls_step_reference(wlev[w], None, v, lo_f, hi_f))
        w2, err2 = best_weights(lo_u2, hi_u2)
        better = err2 < err
        bc = better[:, None]
        lo_c = torch.where(bc, lo_c2, lo_c)
        hi_c = torch.where(bc, hi_c2, hi_c)
        lo_u = torch.where(bc, lo_u2, lo_u)
        hi_u = torch.where(bc, hi_u2, hi_u)
        w = torch.where(bc, w2, w)
        err = torch.minimum(err, err2)

    # full-pixel error (the channels the mode cannot represent included)
    if comps == 3:
        err = err + _alpha_err(px)
    elif comps == 2:
        # gray reconstruction against the RGB channels, plus alpha
        wl = wlev[w]
        l_rec = _rec16(lo_u[:, 0][:, None] * (64.0 - wl)
                       + hi_u[:, 0][:, None] * wl)
        d_rgb = px[..., :3] - l_rec[..., None]
        a_rec = _rec16(lo_u[:, 1][:, None] * (64.0 - wl)
                       + hi_u[:, 1][:, None] * wl)
        d_a = px[..., 3] - a_rec
        err = (d_rgb * d_rgb).sum((1, 2)) + (d_a * d_a).sum(1)

    # interleave lo/hi codes: [c0lo, c0hi, c1lo, c1hi, ...]
    ep = torch.stack([lo_c, hi_c], -1).reshape(b, comps * 2)
    return err, ep.to(torch.int32), w.to(torch.int32)


def _fit_line_masked(v, mask, levels, ls_iters: int):
    """Line fit + weight quantization over a masked pixel subset (the body
    of `line_fit_reference`).

    v: (B,16,C); mask: (B,16) float 0/1; levels: (L,) factors.
    Returns (lo (B,C), hi (B,C), w (B,16) level idx, err (B,) masked SSE).
    """
    cnt = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    mean = _sum(v * mask[..., None], 1)[:, None] / cnt[..., None]
    c = (v - mean) * mask[..., None]
    d, proj = principal_axis_reference(c, 4)
    inside = mask > 0
    pmin = torch.where(inside, proj, 1e9).amin(1, keepdim=True)
    pmax = torch.where(inside, proj, -1e9).amax(1, keepdim=True)
    lo = torch.clamp(_fma(d, pmin, mean[:, 0]), 0, 255)
    hi = torch.clamp(_fma(d, pmax, mean[:, 0]), 0, 255)

    def weights_for(lo, hi):
        rec = _rec16_fused(lo[:, None, :], hi[:, None, :],
                           levels[None, :, None])
        e = _sum((v[:, :, None, :] - rec[:, None, :, :]) ** 2, -1)
        return torch.argmin(e, -1), _sum(e.amin(-1) * mask, -1)

    w, err = weights_for(lo, hi)
    for _ in range(ls_iters):
        lo2, hi2 = ls_step_reference(levels[w], mask, v, lo, hi)
        w2, err2 = weights_for(lo2, hi2)
        better = err2 < err
        lo = torch.where(better[:, None], lo2, lo)
        hi = torch.where(better[:, None], hi2, hi)
        w = torch.where(better[:, None], w2, w)
        err = torch.minimum(err, err2)
    return lo, hi, w, err


def _subset_rec_err(v, lo_px, hi_px, wlev):
    """Weights re-chosen through quantized per-pixel endpoints (B,16,C):
    (w (B,16), err (B,))."""
    rec = _rec16(lo_px[:, :, None, :] * (64.0 - wlev)[None, None, :, None]
                 + hi_px[:, :, None, :] * wlev[None, None, :, None])
    e_all = _sum((v[:, :, None, :] - rec) ** 2, -1)             # (B,16,L)
    return torch.argmin(e_all, -1), _sum(e_all.amin(-1), -1)


_SUBSET_INSTANCES = ((2, 2), (3, 2), (4, 2), (3, 3))   # (comps, subsets)


def subset_trial(px, wb: int, ep_range: int, comps: int, ls_iters: int,
                 n_sub: int = 2, pattern_list: int = 2, topk: int = 4):
    """A multi-subset mode trial for all blocks: shortlist the mode's
    common partitions of n_sub subsets (2: 30, or mode 7's 19 with
    pattern_list 7; 3: 11) by agreement with an ideal luma split, then fit
    each subset of the topk best, in shortlist order.

    px: (B,16,4) f32, whole numbers 0..255; (comps, n_sub) (2, 2) LA, (3, 2)
    RGB, (4, 2) RGBA or (3, 3) RGB. Returns (err (B,), eps (B, 2 n_sub
    comps) int32 codes, weights (B,16) int32, pattern (B,) int32). A CUDA
    tensor launches `uastc_subset_trial` (`csrc/xla_order_kernels.cu`), the
    whole trial in one launch, a lane per pixel; a CPU tensor runs
    `subset_trial_reference`."""
    if not px.is_cuda:
        return subset_trial_reference(px, wb, ep_range, comps, ls_iters,
                                      n_sub, pattern_list, topk)
    b_n = px.shape[0]
    if tuple(px.shape[1:]) != (16, 4) or px.dtype != torch.float32 \
            or (comps, n_sub) not in _SUBSET_INSTANCES:
        raise ValueError(f"subset_trial: px (B, 16, 4) float32 and (comps, "
                         f"subsets) one of {_SUBSET_INSTANCES}, got "
                         f"{tuple(px.shape)} {px.dtype}, ({comps}, {n_sub})")
    pats = _patterns(n_sub, pattern_list == 7, str(px.device))
    if not 1 <= topk <= min(8, len(pats)):
        raise ValueError(f"subset_trial: top-k 1..{min(8, len(pats))}, got "
                         f"{topk}")
    inv, unq, wlev = _mode_consts(wb, ep_range, str(px.device))
    _check_levels(wlev, px.device)
    err = torch.empty(b_n, dtype=torch.float32, device=px.device)
    ep = torch.empty((b_n, 2 * n_sub * comps), dtype=torch.int32,
                     device=px.device)
    w = torch.empty((b_n, 16), dtype=torch.int32, device=px.device)
    pat = torch.empty(b_n, dtype=torch.int32, device=px.device)
    status = xla_order.launch(
        "subset_trial", px.device.index, px.data_ptr(), *px.stride(),
        pats.data_ptr(), len(pats), inv.data_ptr(), unq.data_ptr(),
        unq.numel(), wlev.data_ptr(), wlev.numel(), comps, n_sub, ls_iters,
        topk, err.data_ptr(), ep.data_ptr(), w.data_ptr(), pat.data_ptr(),
        b_n)
    LAUNCHES["uastc_subset_trial"] += 1
    _raise_on(status, "uastc_subset_trial")
    return err, ep, w, pat


def subset_trial_reference(px, wb: int, ep_range: int, comps: int,
                           ls_iters: int, n_sub: int = 2,
                           pattern_list: int = 2, topk: int = 4):
    """Plain version of `subset_trial`, on any device."""
    if n_sub == 3:
        return _trial_3subset_reference(px, wb, ep_range, comps, ls_iters,
                                        topk)
    return _trial_2subset_reference(px, wb, ep_range, comps, ls_iters,
                                    pattern_list, topk)


def _mode_trial_2subset(px, wb: int, ep_range: int, comps: int,
                        ls_iters: int, pattern_list: int = 2, topk: int = 4):
    """2-subset mode trial (modes 2, 4, 7, 9, 16): `subset_trial`.

    Returns (err (B,), eps (B, comps*4) codes, weights (B,16), pattern (B,)).
    """
    return subset_trial(px, wb, ep_range, comps, ls_iters, 2, pattern_list,
                        topk)


def _trial_2subset_reference(px, wb: int, ep_range: int, comps: int,
                             ls_iters: int, pattern_list: int, topk: int):
    """2-subset mode trial: shortlist the mode's common partitions (30 for
    modes 2/4/9/16, 19 for mode 7) by agreement with an ideal 2-cluster luma
    split, then fit the top candidates.

    Returns (err (B,), eps (B, comps*4) codes, weights (B,16), pattern (B,)).
    """
    b = px.shape[0]
    dev = px.device
    inv, unq, wlev = _mode_consts(wb, ep_range, str(dev))
    v = _la(px) if comps == 2 else px[..., :comps]
    pats = _patterns(2, pattern_list == 7, str(dev))             # (P,16)

    # ideal split: 1-D 2-means on luma (three iterations)
    luma = v[..., 0] if comps == 2 else _mean3(v[..., :3])
    c0 = luma.amin(1, keepdim=True)
    c1 = luma.amax(1, keepdim=True)
    for _ in range(3):
        side = ((luma - c1).abs() < (luma - c0).abs()).float()
        n1 = torch.clamp(side.sum(1, keepdim=True), min=1.0)
        n0 = torch.clamp((1 - side).sum(1, keepdim=True), min=1.0)
        c1 = _sum16(luma * side) / n1
        c0 = _sum16(luma * (1 - side)) / n0
    ideal = ((luma - c1).abs() < (luma - c0).abs()).float()      # (B,16)

    # agreement with each pattern, either polarity
    pf = pats.float()
    agree = ideal @ pf.T + (1 - ideal) @ (1 - pf).T
    score = torch.maximum(agree, 16.0 - agree)
    cand = _shortlist_desc(score, topk)                          # (B,K)

    best_err = torch.full((b,), float("inf"), device=dev)
    best_eps = torch.zeros((b, comps * 4), dtype=torch.int64, device=dev)
    best_w = torch.zeros((b, 16), dtype=torch.int64, device=dev)
    best_p = torch.zeros(b, dtype=torch.int64, device=dev)
    for k in range(topk):
        pidx = cand[:, k]
        pat = pats[pidx]                                         # (B,16)
        lo, hi = line_fit(v, pat, 2, wlev, ls_iters)             # (B,2,C)
        q_lo, q_hi = _quant(inv, lo), _quant(inv, hi)
        eps = torch.stack([q_lo[:, 0], q_hi[:, 0], q_lo[:, 1], q_hi[:, 1]],
                          1)                                     # (B,4,C)
        # exact error + re-chosen weights through the QUANTIZED endpoints
        in1 = pat[..., None] == 1
        lo_px = torch.where(in1, unq[eps[:, 2]][:, None, :],
                            unq[eps[:, 0]][:, None, :])
        hi_px = torch.where(in1, unq[eps[:, 3]][:, None, :],
                            unq[eps[:, 1]][:, None, :])
        w, err = _subset_rec_err(v, lo_px, hi_px, wlev)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        # endpoint layout: subset 0's (lo, hi) per channel, then subset 1's
        e_cat = torch.cat([torch.stack([eps[:, 0], eps[:, 1]], -1).reshape(b, -1),
                           torch.stack([eps[:, 2], eps[:, 3]], -1).reshape(b, -1)],
                          -1)
        best_eps = torch.where(better[:, None], e_cat, best_eps)
        best_w = torch.where(better[:, None], w, best_w)
        best_p = torch.where(better, pidx, best_p)
    if comps == 3:
        best_err = best_err + _alpha_err(px)
    elif comps == 2:
        # the winner's error in full-pixel units (gray reconstruction against
        # RGB, plus alpha), so the cross-mode argmin is fair
        pat_b = pats[best_p] == 1                                # (B,16)
        wl = wlev[best_w]

        def ch(lo_i, hi_i):
            lo = torch.where(pat_b, unq[best_eps[:, 4 + lo_i]][:, None],
                             unq[best_eps[:, lo_i]][:, None])
            hi = torch.where(pat_b, unq[best_eps[:, 4 + hi_i]][:, None],
                             unq[best_eps[:, hi_i]][:, None])
            return (lo * (64.0 - wl) + hi * wl + 32.0) * _INV64

        d_rgb = px[..., :3] - ch(0, 1)[..., None]
        d_a = px[..., 3] - ch(2, 3)
        best_err = (_sum((d_rgb * d_rgb).reshape(b, 48), -1)
                    + _sum(d_a * d_a, -1))
    return (best_err, best_eps.to(torch.int32), best_w.to(torch.int32),
            best_p.to(torch.int32))


_PERMS3 = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _mode_trial_3subset(px, ls_iters: int):
    """Mode 3 (RGB, 3 subsets, 2-bit weights, endpoint range 7), the top two
    of its 11 partitions: `subset_trial`."""
    return subset_trial(px, 2, 7, 3, ls_iters, 3, 3, 2)


def _trial_3subset_reference(px, wb: int, ep_range: int, comps: int,
                             ls_iters: int, topk: int):
    """3-subset mode trial (mode 3: RGB, 2-bit weights, endpoint range 7):
    shortlist the 11 common 3-subset partitions by confusion-matrix
    agreement with a 3-means luma split, then fit the top topk (two)."""
    b = px.shape[0]
    dev = px.device
    inv, unq, wlev = _mode_consts(wb, ep_range, str(dev))
    v = px[..., :3]
    pats = _patterns(3, False, str(dev))                         # (11,16)

    luma = _mean3(v)                                             # (B,16)
    c = torch.stack([luma.amin(1), _sum(luma, 1) / 16.0, luma.amax(1)], -1)
    for _ in range(3):
        lab = torch.argmin((luma[..., None] - c[:, None, :]).abs(), -1)
        one = torch.nn.functional.one_hot(lab, 3).float()         # (B,16,3)
        cnt = torch.clamp(one.sum(1), min=1.0)
        c = _sum16(luma[..., None] * one)[:, 0] / cnt
    ideal = torch.nn.functional.one_hot(lab, 3).float()
    pat_oh = torch.nn.functional.one_hot(pats, 3).float()         # (11,16,3)
    conf = torch.einsum("bik,pij->bpkj", ideal, pat_oh)           # (B,11,3,3)
    score = torch.stack([conf[..., 0, p[0]] + conf[..., 1, p[1]]
                         + conf[..., 2, p[2]] for p in _PERMS3], -1).amax(-1)
    cand = _shortlist_desc(score, topk)

    best_err = torch.full((b,), float("inf"), device=dev)
    best_eps = torch.zeros((b, comps * 6), dtype=torch.int64, device=dev)
    best_w = torch.zeros((b, 16), dtype=torch.int64, device=dev)
    best_p = torch.zeros(b, dtype=torch.int64, device=dev)
    for k in range(topk):
        pidx = cand[:, k]
        pat = pats[pidx]                                         # (B,16)
        lo, hi = line_fit(v, pat, 3, wlev, ls_iters)             # (B,3,C)
        q_lo, q_hi = _quant(inv, lo), _quant(inv, hi)
        eps_s = [(q_lo[:, s], q_hi[:, s]) for s in range(3)]
        lo_px = torch.zeros((b, 16, comps), dtype=torch.float32, device=dev)
        hi_px = torch.zeros((b, 16, comps), dtype=torch.float32, device=dev)
        for s in range(3):
            m = (pat == s)[..., None]
            lo_px = torch.where(m, unq[eps_s[s][0]][:, None, :], lo_px)
            hi_px = torch.where(m, unq[eps_s[s][1]][:, None, :], hi_px)
        w, err = _subset_rec_err(v, lo_px, hi_px, wlev)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        e_cat = torch.cat([torch.stack([lo_c, hi_c], -1).reshape(b, comps * 2)
                           for lo_c, hi_c in eps_s], -1)         # (B,18)
        best_eps = torch.where(better[:, None], e_cat, best_eps)
        best_w = torch.where(better[:, None], w, best_w)
        best_p = torch.where(better, pidx, best_p)
    return (best_err + _alpha_err(px), best_eps.to(torch.int32),
            best_w.to(torch.int32), best_p.to(torch.int32))


def _interleave(w0, w1):
    """(B,16) plane-0 and plane-1 weights -> (B,32) interleaved."""
    return torch.stack([w0, w1], -1).reshape(w0.shape[0], 32)


def _dualplane_trials(px, wb: int, ep_range: int, ls_iters: int, n_ch: int):
    """Dual-plane modes with a selectable plane-1 channel (ccs) among the
    first n_ch channels: per ccs, plane 1 carries that channel and plane 0
    the others. Returns (err, eps codes (B, n_ch*2), weights interleaved
    (B,32), ccs (B,))."""
    b = px.shape[0]
    dev = px.device
    inv, unq, wlev = _mode_consts(wb, ep_range, str(dev))

    best_err = torch.full((b,), float("inf"), device=dev)
    best_eps = torch.zeros((b, n_ch * 2), dtype=torch.int64, device=dev)
    best_w = torch.zeros((b, 32), dtype=torch.int64, device=dev)
    best_ccs = torch.zeros(b, dtype=torch.int64, device=dev)
    for ccs in range(n_ch):
        others = [c for c in range(n_ch) if c != ccs]
        lo0, hi0 = line_fit(px[..., others], None, 1, wlev, ls_iters)
        lo1, hi1 = line_fit(px[..., ccs:ccs + 1], None, 1, wlev, ls_iters)
        lo = torch.zeros((b, n_ch), dtype=torch.float32, device=dev)
        hi = torch.zeros((b, n_ch), dtype=torch.float32, device=dev)
        lo[:, others] = lo0[:, 0]
        hi[:, others] = hi0[:, 0]
        lo[:, ccs] = lo1[:, 0, 0]
        hi[:, ccs] = hi1[:, 0, 0]
        codes_lo, codes_hi = _quant(inv, lo), _quant(inv, hi)
        eps = torch.stack([codes_lo, codes_hi], -1).reshape(b, n_ch * 2)
        # exact error + weights through the QUANTIZED endpoints
        lo_u, hi_u = unq[codes_lo], unq[codes_hi]
        rec = _rec16(lo_u[:, None, None, :] * (64.0 - wlev)[None, None, :, None]
                     + hi_u[:, None, None, :] * wlev[None, None, :, None])
        diff = px[..., :n_ch][:, :, None, :] - rec               # (B,16,L,n)
        e_p0 = 0
        for c in others:
            e_p0 = e_p0 + diff[..., c] ** 2
        e_p1 = diff[..., ccs] ** 2                               # (B,16,L)
        err = e_p0.amin(-1).sum(-1) + e_p1.amin(-1).sum(-1)
        w = _interleave(torch.argmin(e_p0, -1), torch.argmin(e_p1, -1))
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_eps = torch.where(better[:, None], eps, best_eps)
        best_w = torch.where(better[:, None], w, best_w)
        best_ccs = torch.where(better, ccs, best_ccs)
    return (best_err, best_eps.to(torch.int32), best_w.to(torch.int32),
            best_ccs.to(torch.int32))


def dualplane_trial(px, wb: int, ep_range: int, ls_iters: int, n_ch: int):
    """A dual-plane mode trial for all blocks: n_ch 3 (mode 6, RGB) or 4
    (modes 11 and 13, RGBA), each channel in turn (ccs) on plane 1 and the
    others on plane 0, the best ccs kept; n_ch 2 (mode 17, LA): the luma on
    plane 0, scored against R, G and B, the alpha on plane 1.

    px: (B,16,4) f32, whole numbers 0..255. Returns (err (B,), eps (B, 2
    n_ch) int32 codes, weights (B,32) int32 interleaved, ccs (B,) int32;
    LA: no ccs). A CUDA tensor launches `uastc_dualplane_trial`
    (`csrc/xla_order_kernels.cu`), the whole trial in one launch, a lane
    per pixel; a CPU tensor runs `dualplane_trial_reference`."""
    if not px.is_cuda:
        return dualplane_trial_reference(px, wb, ep_range, ls_iters, n_ch)
    b_n = px.shape[0]
    if tuple(px.shape[1:]) != (16, 4) or px.dtype != torch.float32 \
            or n_ch not in (2, 3, 4):
        raise ValueError(f"dualplane_trial: px (B, 16, 4) float32 and n_ch "
                         f"2..4, got {tuple(px.shape)} {px.dtype}, {n_ch}")
    inv, unq, wlev = _mode_consts(wb, ep_range, str(px.device))
    _check_levels(wlev, px.device)
    err = torch.empty(b_n, dtype=torch.float32, device=px.device)
    ep = torch.empty((b_n, 2 * n_ch), dtype=torch.int32, device=px.device)
    w = torch.empty((b_n, 32), dtype=torch.int32, device=px.device)
    ccs = torch.empty(b_n, dtype=torch.int32, device=px.device)
    status = xla_order.launch(
        "dualplane_trial", px.device.index, px.data_ptr(), *px.stride(),
        inv.data_ptr(), unq.data_ptr(), unq.numel(), wlev.data_ptr(),
        wlev.numel(), n_ch, ls_iters, err.data_ptr(), ep.data_ptr(),
        w.data_ptr(), ccs.data_ptr(), b_n)
    LAUNCHES["uastc_dualplane_trial"] += 1
    _raise_on(status, "uastc_dualplane_trial")
    return (err, ep, w) if n_ch == 2 else (err, ep, w, ccs)


def dualplane_trial_reference(px, wb: int, ep_range: int, ls_iters: int,
                              n_ch: int):
    """Plain version of `dualplane_trial`, on any device."""
    if n_ch == 2:
        return _dualplane_la_reference(px, wb, ep_range, ls_iters)
    err, eps, w, ccs = _dualplane_trials(px, wb, ep_range, ls_iters, n_ch)
    return (err + _alpha_err(px) if n_ch == 3 else err), eps, w, ccs


def _mode_trial_dualplane(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane RGB mode (6): per-ccs trial over R, G, B. Returns (err,
    eps codes (B,6), weights interleaved (B,32), ccs (B,))."""
    return dualplane_trial(px, wb, ep_range, ls_iters, 3)


def _mode_trial_dualplane4(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane RGBA modes 11/13: ccs selects one of 4 channels for plane
    1. Returns (err, eps codes (B,8), weights interleaved (B,32), ccs)."""
    return dualplane_trial(px, wb, ep_range, ls_iters, 4)


def _mode_trial_dualplane_la(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane LA mode 17: plane 0 carries luma (applied to RGB), plane 1
    alpha; CCS is fixed. Returns (err, eps codes (B,4) = [Llo, Lhi, Alo,
    Ahi], weights interleaved (B,32))."""
    return dualplane_trial(px, wb, ep_range, ls_iters, 2)


def _dualplane_la_reference(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane LA mode 17 (the body of `dualplane_trial_reference` for
    n_ch 2)."""
    b = px.shape[0]
    dev = px.device
    inv, unq, wlev = _mode_consts(wb, ep_range, str(dev))

    luma = _mean3(px[..., :3])[..., None]                        # (B,16,1)
    alpha = px[..., 3:]
    lo_l, hi_l = line_fit(luma, None, 1, wlev, ls_iters)
    lo_a, hi_a = line_fit(alpha, None, 1, wlev, ls_iters)
    cl, ch_ = _quant(inv, lo_l[:, 0, 0]), _quant(inv, hi_l[:, 0, 0])
    al, ah = _quant(inv, lo_a[:, 0, 0]), _quant(inv, hi_a[:, 0, 0])
    rec_l = _rec16(unq[cl][:, None, None] * (64.0 - wlev)[None, None, :]
                   + unq[ch_][:, None, None] * wlev[None, None, :])  # (B,1,L)
    e_l = ((px[..., :3][:, :, None, :] - rec_l[..., None]) ** 2).sum(-1)
    rec_a = _rec16(unq[al][:, None, None] * (64.0 - wlev)[None, None, :]
                   + unq[ah][:, None, None] * wlev[None, None, :])
    e_a = (alpha[:, :, None, 0] - rec_a) ** 2                   # (B,16,L)
    err = e_l.amin(-1).sum(-1) + e_a.amin(-1).sum(-1)
    w = _interleave(torch.argmin(e_l, -1), torch.argmin(e_a, -1))
    eps = torch.stack([cl, ch_, al, ah], -1)
    return err, eps.to(torch.int32), w.to(torch.int32)


def _search_impl(px, modes: tuple, ls_iters: int, extra: tuple = (),
                 topk: int = 4):
    """Full mode search for one image; the winner is chosen on the device.

    px: (B,16,4) float32. Returns one (B, 59) uint8 buffer [slot | ep(24) |
    w(32) | aux | etc1_inten], the only bytes that go back to the host.
    Each mode's temporaries are freed before the next mode runs."""
    b = px.shape[0]
    dev = px.device
    errs, eps24, ws32, auxs = [], [], [], []

    def _slot(e, ep, w, aux=None):
        errs.append(e)
        ep_full = torch.zeros((b, 24), dtype=torch.int32, device=dev)
        ep_full[:, :ep.shape[1]] = ep
        w_full = torch.zeros((b, 32), dtype=torch.int32, device=dev)
        w_full[:, :w.shape[1]] = w
        eps24.append(ep_full)
        ws32.append(w_full)
        auxs.append(torch.zeros(b, dtype=torch.int32, device=dev)
                    if aux is None else aux.to(torch.int32))

    for (_mode, wb, ep_range, comps) in modes:
        _slot(*_mode_trial(px, wb, ep_range, comps, ls_iters))
    # solid-colour candidate: the mean RGBA rides in the endpoint lanes
    mean = torch.clamp(torch.round(px.mean(1)), 0, 255)
    solid_err = ((px - mean[:, None, :]) ** 2).sum((1, 2))
    _slot(solid_err, mean.to(torch.int32),
          torch.zeros((b, 1), dtype=torch.int32, device=dev))

    for name in extra:
        if name == "mode2":
            _slot(*_mode_trial_2subset(px, 3, 8, 3, ls_iters, topk=topk))
        elif name == "mode4":
            _slot(*_mode_trial_2subset(px, 2, 12, 3, ls_iters, topk=topk))
        elif name == "mode6":
            _slot(*_mode_trial_dualplane(px, 2, 18, ls_iters))
        elif name == "mode9":
            _slot(*_mode_trial_2subset(px, 2, 8, 4, ls_iters, topk=topk))
        elif name == "mode7":
            _slot(*_mode_trial_2subset(px, 2, 12, 3, ls_iters,
                                       pattern_list=7, topk=topk))
        elif name == "mode16":
            _slot(*_mode_trial_2subset(px, 2, 20, 2, ls_iters, topk=topk))
        elif name == "mode3":
            _slot(*_mode_trial_3subset(px, ls_iters))
        elif name == "mode11":
            _slot(*_mode_trial_dualplane4(px, 2, 13, ls_iters))
        elif name == "mode13":
            _slot(*_mode_trial_dualplane4(px, 1, 20, ls_iters))
        elif name == "mode17":
            _slot(*_mode_trial_dualplane_la(px, 2, 20, ls_iters))

    best = torch.argmin(torch.stack(errs, 1), 1)                # (B,)
    rows = torch.arange(b, device=dev)
    ep_win = torch.stack(eps24, 1)[rows, best]                  # (B,24)
    w_win = torch.stack(ws32, 1)[rows, best]                    # (B,32)
    aux_win = torch.stack(auxs, 1)[rows, best]

    # ETC1 transcode hint: the intensity table of a radius-0 ETC1S fit
    etc1_inten = etc1s_ops.encode_blocks(px[..., :3].contiguous(),
                                         radius=0)["inten"]

    out = torch.cat([best.to(torch.int32)[:, None], ep_win, w_win,
                     aux_win[:, None], etc1_inten.to(torch.int32)[:, None]], 1)
    return out.to(torch.uint8)                                  # (B, 59)


def _search_device(px, modes, ls_iters, extra, topk):
    """The search's (B, 59) uint8 winner buffer, on the device of px."""
    with etc1s_ops.exact_matmuls():
        return _search_impl(px.float(), modes, ls_iters, extra, topk)


def _search(px, modes, ls_iters, extra, topk) -> np.ndarray:
    """`_search_device`'s buffer, fetched to the host."""
    return _search_device(px, modes, ls_iters, extra, topk).cpu().numpy()


def _search_and_pack(px, modes, ls_iters, extra, topk) -> np.ndarray:
    """Search and pack the (B, 16, 4) pixels px on their device; fetch the
    (B, 16) blocks. The solid colour's alpha is pixel 0's, truncated to an
    integer, as `pack._pack_from_compact` reads it."""
    compact = _search_device(px, modes, ls_iters, extra, topk)
    alpha0 = px[:, 0, 3].to(torch.int32)
    tables = pack.pack_tables(modes, extra, px.device)
    return pack.uastc_pack(compact, alpha0, tables).cpu().numpy()


def encode_blocks(px_rgba: np.ndarray, effort: int = 2,
                  has_alpha: bool = True, device="cuda") -> np.ndarray:
    """Encode (B,16,4) float32 RGBA pixels -> (B,16) uint8 UASTC blocks; the
    search and the packing run on `device`."""
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, has_alpha)
    dev = resolve_device(device)
    px = torch.as_tensor(np.ascontiguousarray(px_rgba, dtype=np.float32))
    return _search_and_pack(px.to(dev), modes, ls_iters, extra, topk)


def encode_blocks_batch(px_list, effort: int = 2, has_alpha: bool = True,
                        device="cuda"):
    """Encode N same-shaped (B,16,4) images; yields (B,16) uint8 per image.

    One image at a time runs on the device (uploaded as uint8, cast there):
    the search, then the packing, then one fetch of its blocks."""
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, has_alpha)
    dev = resolve_device(device)
    for px in px_list:
        up = torch.as_tensor(np.ascontiguousarray(px).astype(np.uint8))
        yield _search_and_pack(up.to(dev), modes, ls_iters, extra, topk)
