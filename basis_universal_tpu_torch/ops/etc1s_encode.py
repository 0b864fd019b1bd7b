"""Device-side ETC1S encoding ops in PyTorch.

Counterpart of `basis_universal_tpu/ops/etc1s_encode.py`, in its
kernel-shaped formulation: candidate scans go through `factorized_scan`
(per block, or per block against its cluster base followed by a segment-sum
to clusters), exact rescoring through `palette_errs_packed` on packed
candidate descriptors, and the selector search through
`find_best_selector_patterns`. Those three run as CUDA kernels on CUDA
tensors and as their plain PyTorch versions on CPU tensors
(`ops/cuda_etc1s.py`); everything else here is plain PyTorch on the device
of its inputs.

Equivalences with the reference kept on purpose:
- shortlists use a stable ascending sort, so ties keep the lower index
  first, as `lax.top_k` does;
- the k-means cross term rounds its operands to bf16 when the codebook has
  >= 1024 entries and multiplies in float32, as the reference's bf16 matmul
  with float32 accumulation does;
- float32 matmuls that rank distances must not run in TF32: the frontend
  runs them under `exact_matmuls()`;
- segment sums go through `segment_sum`, which sums each segment in row
  order on every device, so a card run gives the same bits every time (an
  `index_add_` of floats on CUDA sums with atomics, in an order that
  changes from run to run).
"""

import contextlib

import numpy as np
import torch

from basis_universal_tpu.ops.etc1 import ETC1_INTEN_TABLES

from . import cuda_etc1s
from .cuda_etc1s import _INTEN_MID, C31_255

# Perceptual (luma-weighted) colour metric, factored as ||P d||^2 and scaled
# so P @ (1,1,1) = (sqrt(3), 0, 0): see the reference module for the
# derivation (the reference's color_distance(perceptual=true)).
_PERC_A = np.array([[14., 45., 5.], [50., -45., -5.], [-14., -45., 59.]])
_PERC_W = np.array([128., 26., 3.])
PERC_P = (np.sqrt(_PERC_W * (3.0 / 524288.0))[:, None]
          * _PERC_A).astype(np.float32)                     # (3,3)


@contextlib.contextmanager
def exact_matmuls():
    """float32 matmuls inside run without TF32 (it would reorder the
    argmins over ranked distances); the caller's setting is restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def segment_sum(data, segment_ids, num_segments: int):
    """out[s] = sum of the rows data[i] with segment_ids[i] == s, shape
    (num_segments, *data.shape[1:]), the same bits on every run.

    Float rows are stably sorted by segment and each segment is summed in
    row order (`torch.segment_reduce`): the order of a sequential
    `index_add_`, whose result it equals bit for bit on the CPU. The
    segment offsets come from a search in the sorted ids, which needs no
    device-to-host copy (a `bincount` on CUDA waits for one). Integer sums
    are exact in any order and stay an `index_add_`."""
    ids = segment_ids.long()
    if not data.is_floating_point():
        return torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                           device=data.device).index_add_(0, ids, data)
    sorted_ids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(sorted_ids, torch.arange(
        num_segments + 1, dtype=torch.int64, device=ids.device))
    return torch.segment_reduce(data[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)


def _inten(device):
    return torch.as_tensor(ETC1_INTEN_TABLES, dtype=torch.float32,
                           device=device)


def perceptual_transform(x):
    """y = P x over the trailing RGB axis."""
    return x @ torch.as_tensor(PERC_P, device=x.device).T


def _candidate_deltas(radius: int) -> np.ndarray:
    """Integer 5-bit perturbations around the mean colour, (D, 3) int32,
    ordered by L1 norm (radius 1 -> 27, radius 2 -> 125)."""
    r = np.arange(-radius, radius + 1)
    d = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    d = d[np.argsort(np.abs(d).sum(1), kind="stable")]
    return d.astype(np.int32)


def expand5(c5):
    return (c5 << 3) | (c5 >> 2)


def _gray_axis_minterm(u):
    """sum_i min_k (t_k - u_i)^2 per intensity table, for u (..., 16)
    gray-axis offsets. Returns (..., 8)."""
    mids = torch.as_tensor(_INTEN_MID, dtype=torch.float32, device=u.device)
    tabs = _inten(u.device)
    uu = u[..., None, :]                                      # (...,1,16)
    k = ((uu > mids[:, 0, None]).to(torch.int32)
         + (uu > mids[:, 1, None]) + (uu > mids[:, 2, None]))  # (...,8,16)
    t0, t1, t2, t3 = (tabs[:, j, None] for j in range(4))
    tk = torch.where(k == 0, t0,
                     torch.where(k == 1, t1, torch.where(k == 2, t2, t3)))
    d = tk - uu
    return (d * d).sum(-1)


def _block_moments(pixels, gvec=None):
    """Per-block sufficient statistics of the factorized scan; gvec is the
    gray axis in pixel space (None: uniform RGB)."""
    luma = pixels.sum(-1) if gvec is None else pixels @ gvec
    return dict(
        luma=luma,
        sum_l=luma.sum(-1),
        sum_l2=(luma * luma).sum(-1),
        sum_x=pixels.sum(1),
        sum_x2=(pixels * pixels).sum((1, 2)),
    )


def _pack(c5, inten):
    """(..., 3) 5-bit colours + (...,) tables -> packed int32 descriptors."""
    c5 = c5.to(torch.int32)
    return (c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
            | (inten.to(torch.int32) << 15)).contiguous()


def _unpack(pk):
    color5 = torch.stack([pk & 31, (pk >> 5) & 31, (pk >> 10) & 31], -1)
    return color5.to(torch.int32), ((pk >> 15) & 7).to(torch.int32)


def _shortlist(flat, k: int):
    """Indices of the k smallest entries per row, ascending, equal values by
    ascending index, also at the k-th place: the order of `lax.top_k(-flat,
    k)` and of the reference's exact `approx_min_k` on the CPU. torch.topk
    promises no tie order; a stable sort does, and on the H100 it is also
    the faster of the two (PERF.md, PR 1)."""
    return torch.sort(flat, dim=-1, stable=True).indices[:, :k]


def encode_blocks(pixels, radius: int = 1, perceptual: bool = False):
    """Per-block ETC1S encode.

    pixels: (B, 16, 3) float32 in [0, 255]. Returns a dict with color5
    (B,3) int32, inten (B,) int32, err (B,) f32, selectors (B,16) int32 and
    low/high (B,3) f32 (the palette's ends, RGB).
    """
    dev = pixels.device
    deltas = torch.as_tensor(_candidate_deltas(radius), device=dev)
    base5 = torch.clamp(torch.round(pixels.mean(1) * C31_255).to(torch.int32),
                        0, 31)
    flat = cuda_etc1s.factorized_scan(pixels, radius=radius,
                                      perceptual=perceptual)    # (B,D*8)
    # the unclipped scores shortlist; the exact clipped rescore picks
    cand = _shortlist(flat, min(16, flat.shape[1]))             # (B,K)
    c5k = torch.clamp(base5[:, None, :] + deltas[cand // 8], 0, 31)
    packed = _pack(c5k, cand % 8)
    cerr = cuda_etc1s.palette_errs_packed(pixels, packed,
                                          perceptual=perceptual)
    kbest = torch.argmin(cerr, dim=-1)
    b = torch.arange(pixels.shape[0], device=dev)
    err = cerr[b, kbest]
    color5, inten = _unpack(packed[b, kbest])

    base8 = expand5(color5).float()
    pal = torch.clamp(base8[:, None, :] + _inten(dev)[inten.long()][:, :, None],
                      0.0, 255.0)                               # (B,4,3)
    pal_m = perceptual_transform(pal) if perceptual else pal
    px_m = perceptual_transform(pixels) if perceptual else pixels
    cross = torch.einsum("bic,bkc->bik", px_m, pal_m)           # (B,16,4)
    d = (pal_m * pal_m).sum(-1)[:, None, :] - 2.0 * cross
    selectors = torch.argmin(d, dim=-1).to(torch.int32)
    return {
        "color5": color5,
        "inten": inten,
        "err": err,
        "selectors": selectors,
        "low": pal[:, 0, :],
        "high": pal[:, 3, :],
    }


def optimize_cluster_endpoints(pixels, cluster_ids, cluster_means,
                               num_clusters: int, radius: int = 1,
                               perceptual: bool = False):
    """Optimal (color5 (C,3) int32, inten (C,) int32) per endpoint cluster.

    Per-block factorized errors against each block's CLUSTER base are
    segment-summed to clusters (q and su2 are linear in the block moments,
    so the sum is exact), shortlisted, and the shortlist is rescored exactly
    over the member pixels.
    """
    dev = pixels.device
    ids = cluster_ids.long()
    deltas = torch.as_tensor(_candidate_deltas(radius), device=dev)
    base5 = torch.clamp(
        torch.round(cluster_means * C31_255).to(torch.int32), 0, 31)  # (C,3)
    blk_err = cuda_etc1s.factorized_scan(
        pixels, base5=base5[ids].float().contiguous(), radius=radius,
        perceptual=perceptual)                                  # (B,D*8)
    flat = segment_sum(blk_err, ids, num_clusters)
    cand = _shortlist(flat, min(16, flat.shape[1]))             # (C,K)
    c5k = torch.clamp(base5[:, None, :] + deltas[cand // 8], 0, 31)
    packed_c = _pack(c5k, cand % 8)                             # (C,K)
    berr = cuda_etc1s.palette_errs_packed(
        pixels, packed_c[ids].contiguous(), perceptual=perceptual)
    cerr = segment_sum(berr, ids, num_clusters)
    kbest = torch.argmin(cerr, dim=-1)
    c = torch.arange(num_clusters, device=dev)
    return _unpack(packed_c[c, kbest])


def kmeans(vecs, weights, init_centroids, num_clusters: int, iters: int = 4):
    """Weighted Lloyd iterations with |a|^2 - 2ab + |b|^2 distances.

    vecs (N, F) f32, weights (N,), init_centroids (C, F).
    Returns (centroids (C, F), assignment (N,) int64).
    """
    w = weights[:, None]
    wv = vecs * w
    # the reference's bf16 cross term (>= 1024 clusters): bf16-rounded
    # operands, float32 product
    bf16 = num_clusters >= 1024
    vecs_h = vecs.to(torch.bfloat16).float() if bf16 else vecs
    centroids = init_centroids
    assign = None
    for _ in range(iters):
        c_h = centroids.to(torch.bfloat16).float() if bf16 else centroids
        cross = vecs_h @ c_h.T                                  # (N,C)
        d = (centroids * centroids).sum(-1)[None, :] - 2.0 * cross
        assign = torch.argmin(d, dim=-1)
        sums = segment_sum(wv, assign, num_clusters)
        cnts = segment_sum(w[:, 0], assign, num_clusters)
        centroids = torch.where(cnts[:, None] > 0,
                                sums / torch.clamp(cnts[:, None], min=1e-9),
                                centroids)
    return centroids, assign


def bisecting_init(vecs, weights, num_clusters: int, generator=None,
                   fill=None):
    """Top-down bisecting split init: split every cluster along its
    principal axis for ceil(log2(C)) rounds, keep the C most populated
    leaves' means as seeds.

    Empty seeds are replaced by training vectors drawn uniformly with
    replacement: `fill` (C, F) when given (tests pass the reference's
    draw), else drawn with `generator`.
    """
    n, f = vecs.shape
    dev = vecs.device
    rounds = max(1, int(np.ceil(np.log2(num_clusters))))
    c_max = 1 << rounds
    assign = torch.zeros(n, dtype=torch.int64, device=dev)
    w = weights
    outer = (vecs[:, :, None] * vecs[:, None, :]).reshape(n, f * f)
    feats = torch.cat([w[:, None], vecs * w[:, None], outer * w[:, None]], -1)

    for _ in range(rounds):
        m = segment_sum(feats, assign, c_max)
        cnt = m[:, 0]
        mean = m[:, 1:1 + f] / torch.clamp(cnt, min=1e-9)[:, None]
        m2 = m[:, 1 + f:].reshape(c_max, f, f)
        cov = m2 - cnt[:, None, None] * mean[:, :, None] * mean[:, None, :]
        axis = torch.ones((c_max, f), dtype=vecs.dtype, device=dev)
        for _ in range(4):
            axis = torch.einsum("cfg,cg->cf", cov, axis)
            axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-9)
        thr = (mean * axis).sum(-1)
        ga = torch.cat([axis, thr[:, None]], -1)[assign]        # (N,F+1)
        proj = (vecs * ga[:, :f]).sum(-1) - ga[:, f]
        assign = assign * 2 + (proj > 0).to(torch.int64)

    m = segment_sum(feats[:, :1 + f], assign, c_max)
    cnt = m[:, 0]
    mean = m[:, 1:] / torch.clamp(cnt, min=1e-9)[:, None]
    top = torch.argsort(-cnt, stable=True)[:num_clusters]
    seeds = mean[top]
    need = cnt[top] <= 0
    if fill is None:
        idx = torch.randint(0, n, (num_clusters,), generator=generator,
                            device=dev)
        fill = vecs[idx]
    return torch.where(need[:, None], fill, seeds)


def refine_endpoint_assignment(pixels, blk_vec6, cb_vec6, cb_color5, cb_inten,
                               topk: int = 8, perceptual: bool = False):
    """Reassign each block to its best endpoint cluster by exact error:
    a shortlist by 6D codebook distance, then the exact clipped rescore.
    Returns (assignment (B,) int64, err (B,) f32)."""
    d6 = ((blk_vec6 * blk_vec6).sum(-1, keepdim=True)
          - (2.0 * blk_vec6) @ cb_vec6.T
          + (cb_vec6 * cb_vec6).sum(-1)[None, :])              # (B,C)
    cand = _shortlist(d6, topk)                                 # (B,K)
    ptab = _pack(cb_color5, cb_inten)                           # (C,)
    err_k = cuda_etc1s.palette_errs_packed(
        pixels, ptab[cand].contiguous(), perceptual=perceptual)
    best = torch.argmin(err_k, dim=-1)
    b = torch.arange(pixels.shape[0], device=pixels.device)
    return cand[b, best], err_k[b, best]


def block_selector_distances(pixels, pal):
    """d[b, i, k] = ||pixel_bi - pal_bk||^2, (B, 16, 4)."""
    diff = pixels[:, :, None, :] - pal[:, None, :, :]
    return (diff * diff).sum(-1)


def find_best_selector_patterns(dists, patterns, num_patterns: int):
    """Per block, the codebook selector pattern of least error:
    (best (B,) int32, min_err (B,) f32)."""
    return cuda_etc1s.find_best_selector_patterns(
        dists.contiguous(), patterns, num_patterns)


def update_selector_patterns(dists, assign, num_patterns: int):
    """Each selector cluster's optimal pattern: per pixel position,
    argmin_k of the members' summed distances. Returns (S, 16) int32."""
    sums = segment_sum(dists, assign, num_patterns)
    return torch.argmin(sums, dim=-1).to(torch.int32)


def rdo_neighbor_copy(px, assign, sel_assign, cb_pal, patterns,
                      left_idx, up_idx, e_thresh, s_thresh):
    """Rate-distortion neighbour reuse: copy the left/up neighbour's
    endpoint cluster (then selector pattern) when the block error stays
    under thresh x the current error. left_idx/up_idx are flat neighbour
    indices (-1 = none). Returns (assign, sel_assign), int64."""
    assign = assign.long()
    sel_assign = sel_assign.long()
    left_idx = left_idx.long()
    up_idx = up_idx.long()
    sel_pat = patterns[sel_assign].long()                      # (B,16)
    lv, uv = torch.clamp(left_idx, min=0), torch.clamp(up_idx, min=0)

    # err(e) = sum|x|^2 - 2 sum_k y_k.pal[e,k] + sum_k m_k |pal[e,k]|^2
    one = torch.nn.functional.one_hot(sel_pat, 4).to(px.dtype)  # (B,16,4)
    y = torch.einsum("bik,bic->bkc", one, px)                  # (B,4,3)
    m = one.sum(1)                                             # (B,4)
    zfeat = torch.cat([y.reshape(-1, 12), m], -1)              # (B,16)
    efeat = torch.cat([-2.0 * cb_pal.reshape(-1, 12),
                       (cb_pal * cb_pal).sum(-1)], -1)         # (C,16)
    sx2 = (px * px).sum((1, 2))

    e_cand = torch.stack([assign, assign[lv], assign[uv]], 1)  # (B,3)
    e_err = sx2[:, None] + torch.einsum("bf,bjf->bj", zfeat, efeat[e_cand])
    cur = e_err[:, 0]
    ok_l = ((e_err[:, 1] <= cur * e_thresh) & (left_idx >= 0) & (cur > 0)
            & (e_cand[:, 1] != assign))
    ok_u = ((e_err[:, 2] <= cur * e_thresh) & (up_idx >= 0) & (cur > 0)
            & (e_cand[:, 2] != assign))
    pick_u = ok_u & (~ok_l | (e_err[:, 2] < e_err[:, 1]))
    pick_l = ok_l & ~pick_u
    assign = torch.where(pick_l, e_cand[:, 1],
                         torch.where(pick_u, e_cand[:, 2], assign))

    dists = block_selector_distances(px, cb_pal[assign])       # (B,16,4)
    s_cand = torch.stack([sel_assign, sel_assign[lv], sel_assign[uv]], 1)
    s_pat = patterns[s_cand].long()                            # (B,3,16)
    d0, d1, d2, d3 = (dists[:, None, :, k] for k in range(4))
    dsel = torch.where(s_pat == 0, d0,
                       torch.where(s_pat == 1, d1,
                                   torch.where(s_pat == 2, d2, d3)))
    s_err = dsel.sum(-1)                                       # (B,3)
    cur = s_err[:, 0]
    ok_l = ((s_err[:, 1] <= cur * s_thresh) & (left_idx >= 0) & (cur > 0)
            & (s_cand[:, 1] != sel_assign))
    ok_u = ((s_err[:, 2] <= cur * s_thresh) & (up_idx >= 0) & (cur > 0)
            & (s_cand[:, 2] != sel_assign))
    pick_u = ok_u & (~ok_l | (s_err[:, 2] < s_err[:, 1]))
    pick_l = ok_l & ~pick_u
    sel_assign = torch.where(pick_l, s_cand[:, 1],
                             torch.where(pick_u, s_cand[:, 2], sel_assign))
    return assign, sel_assign
