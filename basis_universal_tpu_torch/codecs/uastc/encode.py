"""UASTC LDR 4x4 encoder, device half: the batched mode search in PyTorch.

Counterpart of `basis_universal_tpu/codecs/uastc/encode.py`. Every candidate
mode is evaluated for every block as dense tensor math on the device of the
pixels (principal-axis endpoints, least-squares refinement, the argmin over
all weight levels), one argmin per block picks the winner on the device,
and one (B, 59) uint8 buffer per image comes back to the host, where
`pack.py` (copies of the reference's numpy packers) writes the blocks.

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
- the ETC1 transcode hint is the port's ETC1S `encode_blocks` at radius 0
  (the hand-written `factorized_scan` and `palette_errs_packed` kernels);
- the search runs inside `exact_matmuls()` (no TF32).
"""

import concurrent.futures as cf
import functools

import numpy as np
import torch

from basis_universal_tpu.codecs.uastc import tables as T

from ...ops import etc1s_encode as etc1s_ops
from ...ops.cuda_etc1s import THIRD
from ..etc1s.frontend import resolve_device
from . import pack

_INV64 = 1.0 / 64.0


def _rec16(acc):
    """Integer-exact reconstruction from acc = lo*(64-w) + hi*w: the
    decoder's ((lo*257)*(64-w) + (hi*257)*w + 32) >> 6 >> 8, exact in
    float32 written this way (acc*257 <= 2^22)."""
    return torch.floor((acc * 257.0 + 32.0) * (1.0 / 16384.0))


def _mean3(x):
    """Mean over a trailing axis of 3, rounded as the reference's."""
    return x.sum(-1) * THIRD


def _sum16(x):
    """Sum over axis 1 (the 16 pixels), added in pixel order; keepdim."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc[:, None]


def _norm(d):
    return torch.sqrt((d * d).sum(-1, keepdim=True))


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

    px: (B,16,4) f32. Returns (err (B,), ep_codes (B, comps*2) int32,
    weights (B,16) int32). comps 3 -> RGB (alpha forced 255), 4 -> RGBA,
    2 -> LA.
    """
    b = px.shape[0]
    inv, unq, wlev = _mode_consts(wb, ep_range, str(px.device))
    v = _la(px) if comps == 2 else px[..., :comps]

    # principal axis by power iteration on the covariance
    mean = v.mean(1, keepdim=True)
    c = v - mean
    cov = torch.einsum("bif,big->bfg", c, c)
    axis = torch.ones((b, comps), dtype=torch.float32, device=px.device)
    for _ in range(6):
        axis = torch.einsum("bfg,bg->bf", cov, axis)
        axis = axis / (_norm(axis) + 1e-6)
    proj = torch.einsum("bif,bf->bi", c, axis)                 # (B,16)
    lo_f = mean[:, 0] + axis * proj.amin(1, keepdim=True)
    hi_f = mean[:, 0] + axis * proj.amax(1, keepdim=True)

    def quant_pair(lo_f, hi_f):
        lo_c, hi_c = _quant(inv, lo_f), _quant(inv, hi_f)
        return lo_c, hi_c, unq[lo_c], unq[hi_c]

    def best_weights(lo_u, hi_u):
        # reconstruction for every weight level: (B,L,comps)
        rec = _rec16(lo_u[:, None, :] * (64.0 - wlev)[None, :, None]
                     + hi_u[:, None, :] * wlev[None, :, None])
        d = v[:, :, None, :] - rec[:, None, :, :]               # (B,16,L,C)
        e = (d * d).sum(-1)
        return torch.argmin(e, -1), e.amin(-1).sum(-1)

    lo_c, hi_c, lo_u, hi_u = quant_pair(lo_f, hi_f)
    w, err = best_weights(lo_u, hi_u)

    for _ in range(ls_iters):
        # least-squares endpoints given the weights
        a_k = (64.0 - wlev[w]) * _INV64                         # (B,16)
        b_k = wlev[w] * _INV64
        A = (a_k * a_k).sum(1)
        Bm = (a_k * b_k).sum(1)
        C = (b_k * b_k).sum(1)
        P = torch.einsum("bi,bic->bc", a_k, v)
        Q = torch.einsum("bi,bic->bc", b_k, v)
        det = A * C - Bm * Bm
        ok = det.abs() > 1e-6
        dd = torch.where(ok, det, 1.0)[:, None]
        lo_n = torch.where(ok[:, None], (C[:, None] * P - Bm[:, None] * Q) / dd,
                           lo_f)
        hi_n = torch.where(ok[:, None], (A[:, None] * Q - Bm[:, None] * P) / dd,
                           hi_f)
        lo_c2, hi_c2, lo_u2, hi_u2 = quant_pair(torch.clamp(lo_n, 0, 255),
                                                torch.clamp(hi_n, 0, 255))
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
    """Line fit + weight quantization over a masked pixel subset.

    v: (B,16,C); mask: (B,16) float 0/1; levels: (L,) factors.
    Returns (lo (B,C), hi (B,C), w (B,16) level idx, err (B,) masked SSE).
    """
    cnt = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    mean = (v * mask[..., None]).sum(1, keepdim=True) / cnt[..., None]
    c = (v - mean) * mask[..., None]
    cov = torch.einsum("bif,big->bfg", c, c)
    d = torch.ones((v.shape[0], v.shape[2]), dtype=torch.float32,
                   device=v.device)
    for _ in range(4):
        d = torch.einsum("bfg,bg->bf", cov, d)
        d = d / (_norm(d) + 1e-6)
    proj = torch.einsum("bif,bf->bi", c, d)
    inside = mask > 0
    pmin = torch.where(inside, proj, 1e9).amin(1, keepdim=True)
    pmax = torch.where(inside, proj, -1e9).amax(1, keepdim=True)
    lo = torch.clamp(mean[:, 0] + d * pmin, 0, 255)
    hi = torch.clamp(mean[:, 0] + d * pmax, 0, 255)

    def weights_for(lo, hi):
        rec = _rec16(lo[:, None, :] * (64.0 - levels)[None, :, None]
                     + hi[:, None, :] * levels[None, :, None])
        e = ((v[:, :, None, :] - rec[:, None, :, :]) ** 2).sum(-1)
        return torch.argmin(e, -1), (e.amin(-1) * mask).sum(-1)

    w, err = weights_for(lo, hi)
    for _ in range(ls_iters):
        a_k = (64.0 - levels[w]) * _INV64 * mask
        b_k = levels[w] * _INV64 * mask
        A = (a_k * a_k).sum(1)
        Bm = (a_k * b_k).sum(1)
        C = (b_k * b_k).sum(1)
        P = torch.einsum("bi,bic->bc", a_k, v)
        Q = torch.einsum("bi,bic->bc", b_k, v)
        det = A * C - Bm * Bm
        ok = det.abs() > 1e-6
        dd = torch.where(ok, det, 1.0)[:, None]
        lo2 = torch.clamp(torch.where(
            ok[:, None], (C[:, None] * P - Bm[:, None] * Q) / dd, lo), 0, 255)
        hi2 = torch.clamp(torch.where(
            ok[:, None], (A[:, None] * Q - Bm[:, None] * P) / dd, hi), 0, 255)
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
    e_all = ((v[:, :, None, :] - rec) ** 2).sum(-1)             # (B,16,L)
    return torch.argmin(e_all, -1), e_all.amin(-1).sum(-1)


def _mode_trial_2subset(px, wb: int, ep_range: int, comps: int,
                        ls_iters: int, pattern_list: int = 2, topk: int = 4):
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
        pat = pats[pidx].float()                                 # (B,16)
        lo0, hi0, _, _ = _fit_line_masked(v, 1.0 - pat, wlev, ls_iters)
        lo1, hi1, _, _ = _fit_line_masked(v, pat, wlev, ls_iters)
        eps = torch.stack([_quant(inv, lo0), _quant(inv, hi0),
                           _quant(inv, lo1), _quant(inv, hi1)], 1)  # (B,4,C)
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
        best_err = (d_rgb * d_rgb).sum((1, 2)) + (d_a * d_a).sum(1)
    return (best_err, best_eps.to(torch.int32), best_w.to(torch.int32),
            best_p.to(torch.int32))


_PERMS3 = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _mode_trial_3subset(px, ls_iters: int):
    """Mode 3 (RGB, 3 subsets, 2-bit weights, endpoint range 7): shortlist
    the 11 common 3-subset partitions by confusion-matrix agreement with a
    3-means luma split, then fit the top two."""
    wb, ep_range, comps = 2, 7, 3
    b = px.shape[0]
    dev = px.device
    inv, unq, wlev = _mode_consts(wb, ep_range, str(dev))
    v = px[..., :3]
    pats = _patterns(3, False, str(dev))                         # (11,16)

    luma = _mean3(v)                                             # (B,16)
    c = torch.stack([luma.amin(1), luma.sum(1) / 16.0, luma.amax(1)], -1)
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
    topk = 2
    cand = _shortlist_desc(score, topk)

    best_err = torch.full((b,), float("inf"), device=dev)
    best_eps = torch.zeros((b, comps * 6), dtype=torch.int64, device=dev)
    best_w = torch.zeros((b, 16), dtype=torch.int64, device=dev)
    best_p = torch.zeros(b, dtype=torch.int64, device=dev)
    for k in range(topk):
        pidx = cand[:, k]
        pat = pats[pidx]                                         # (B,16)
        eps_s = []
        for s in range(3):
            lo, hi, _, _ = _fit_line_masked(v, (pat == s).float(), wlev,
                                            ls_iters)
            eps_s.append((_quant(inv, lo), _quant(inv, hi)))
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
    ones = torch.ones((b, 16), dtype=torch.float32, device=dev)

    best_err = torch.full((b,), float("inf"), device=dev)
    best_eps = torch.zeros((b, n_ch * 2), dtype=torch.int64, device=dev)
    best_w = torch.zeros((b, 32), dtype=torch.int64, device=dev)
    best_ccs = torch.zeros(b, dtype=torch.int64, device=dev)
    for ccs in range(n_ch):
        others = [c for c in range(n_ch) if c != ccs]
        lo0, hi0, _, _ = _fit_line_masked(px[..., others], ones, wlev, ls_iters)
        lo1, hi1, _, _ = _fit_line_masked(px[..., ccs:ccs + 1], ones, wlev,
                                          ls_iters)
        lo = torch.zeros((b, n_ch), dtype=torch.float32, device=dev)
        hi = torch.zeros((b, n_ch), dtype=torch.float32, device=dev)
        lo[:, others] = lo0
        hi[:, others] = hi0
        lo[:, ccs] = lo1[:, 0]
        hi[:, ccs] = hi1[:, 0]
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


def _mode_trial_dualplane(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane RGB mode (6): per-ccs trial over R, G, B. Returns (err,
    eps codes (B,6), weights interleaved (B,32), ccs (B,))."""
    err, eps, w, ccs = _dualplane_trials(px, wb, ep_range, ls_iters, 3)
    return err + _alpha_err(px), eps, w, ccs


def _mode_trial_dualplane4(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane RGBA modes 11/13: ccs selects one of 4 channels for plane
    1. Returns (err, eps codes (B,8), weights interleaved (B,32), ccs)."""
    return _dualplane_trials(px, wb, ep_range, ls_iters, 4)


def _mode_trial_dualplane_la(px, wb: int, ep_range: int, ls_iters: int):
    """Dual-plane LA mode 17: plane 0 carries luma (applied to RGB), plane 1
    alpha; CCS is fixed. Returns (err, eps codes (B,4) = [Llo, Lhi, Alo,
    Ahi], weights interleaved (B,32))."""
    b = px.shape[0]
    dev = px.device
    inv, unq, wlev = _mode_consts(wb, ep_range, str(dev))
    ones = torch.ones((b, 16), dtype=torch.float32, device=dev)

    luma = _mean3(px[..., :3])[..., None]                        # (B,16,1)
    alpha = px[..., 3:]
    lo_l, hi_l, _, _ = _fit_line_masked(luma, ones, wlev, ls_iters)
    lo_a, hi_a, _, _ = _fit_line_masked(alpha, ones, wlev, ls_iters)
    cl, ch_ = _quant(inv, lo_l[:, 0]), _quant(inv, hi_l[:, 0])
    al, ah = _quant(inv, lo_a[:, 0]), _quant(inv, hi_a[:, 0])
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


def _search(px, modes, ls_iters, extra, topk) -> np.ndarray:
    with etc1s_ops.exact_matmuls():
        out = _search_impl(px.float(), modes, ls_iters, extra, topk)
    return out.cpu().numpy()


def encode_blocks(px_rgba: np.ndarray, effort: int = 2,
                  has_alpha: bool = True, device="cuda") -> np.ndarray:
    """Encode (B,16,4) float32 RGBA pixels -> (B,16) uint8 UASTC blocks; the
    search runs on `device`."""
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, has_alpha)
    dev = resolve_device(device)
    px = torch.as_tensor(np.ascontiguousarray(px_rgba, dtype=np.float32))
    compact = _search(px.to(dev), modes, ls_iters, extra, topk)
    return pack._pack_from_compact(compact, px_rgba, modes, extra)


def encode_blocks_batch(px_list, effort: int = 2, has_alpha: bool = True,
                        device="cuda"):
    """Encode N same-shaped (B,16,4) images; yields (B,16) uint8 per image.

    One image at a time runs on the device (uploaded as uint8, cast there);
    the host packing of image i runs in a thread pool while the device
    searches the images after it."""
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, has_alpha)
    dev = resolve_device(device)
    with cf.ThreadPoolExecutor(min(len(px_list), 8) or 1) as ex:
        futs = []
        for px in px_list:
            up = torch.as_tensor(np.ascontiguousarray(px).astype(np.uint8))
            compact = _search(up.to(dev), modes, ls_iters, extra, topk)
            futs.append(ex.submit(pack._pack_from_compact, compact, px, modes,
                                  extra))
        for f in futs:
            yield f.result()
