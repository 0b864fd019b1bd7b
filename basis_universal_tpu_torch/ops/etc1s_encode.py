"""Device-side ETC1S encoding ops in PyTorch.

Counterpart of `basis_universal_tpu/ops/etc1s_encode.py`, in its
kernel-shaped formulation: the per-block candidate scan and its shortlist
are one kernel, `factorized_scan_shortlist`; the gray-axis sums of the
scan against each block's cluster base (`factorized_scan`) are
summed to clusters with the blocks' moments and assembled into errors
(`cluster_scan_assemble`) before their shortlist; exact rescoring goes
through `palette_errs_packed` on packed candidate descriptors, the
selector search through
`find_best_selector_patterns`, the k-means and refine distances through
`cross6_argmin` / `cross6_distances`, the bisecting init's rounds through
`bisect_rows` / `bisect_round` and the refine's shortlist through
`xla_cpu_min_k`. Those run as CUDA kernels on CUDA tensors
and as their plain PyTorch versions on CPU tensors (`ops/cuda_etc1s.py`);
everything else here is plain PyTorch on the device of its inputs.

Equivalences with the reference kept on purpose:
- shortlists are in ascending order with ties to the lower index first, as
  `lax.top_k` gives them: a stable ascending sort (`_shortlist`), or for
  the per-block scan the same order selected inside its kernel; the
  refine's shortlist, `approx_min_k` in the reference, orders ties as
  XLA-CPU's `std::sort` does (`_refine_shortlist`, `xla_cpu_min_k`);
- the k-means cross term rounds its operands to bf16 when the codebook has
  >= 1024 entries and multiplies in float32, as the reference's bf16 matmul
  with float32 accumulation does;
- float32 matmuls that rank distances must not run in TF32: the frontend
  runs them under `exact_matmuls()`;
- every operator that ranks rounds as the reference's compiled frontend
  does on the CPU (XLA's fused multiply-adds and summation orders, read
  from its LLVM IR, spelled out with `ops/xla_order.py` and in the kernels:
  the scan's gray-axis sum, the cluster scan's assembly, the bisecting
  power iteration, the 6-D cross terms and norms of the `cross6_*`
  kernels), and empty k-means seeds take the training vectors
  `jax.random.choice` draws (`ops/threefry.py`), so the CPU gives the
  reference's codebooks;
- segment sums go through `segment_sum` (and the cluster scan's kernel),
  which sum each segment in row order on every device, so a card run gives
  the same bits every time (an `index_add_` of floats on CUDA sums with
  atomics, in an order that changes from run to run); sums over the same
  ids share one `segment_order`.
"""

import contextlib

import numpy as np
import torch

from . import cuda_etc1s, threefry
from .cuda_etc1s import _INTEN_MID, C31_255
from .etc1 import ETC1_INTEN_TABLES
from .xla_order import _dot, _fma, _sum, _sum_sq_tree16, _tree8

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


def segment_order(segment_ids, num_segments: int):
    """(order (N,), offsets (num_segments + 1,)) int64: the rows in a stable
    order of their segment ids, and each segment's first place in it, the
    order that `segment_sum` sums in. The offsets come from a search in the
    sorted ids, which needs no device-to-host copy (a `bincount` on CUDA
    waits for one). Sums over the same ids can share one order."""
    ids = segment_ids.long()
    sorted_ids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(sorted_ids, torch.arange(
        num_segments + 1, dtype=torch.int64, device=ids.device))
    return order, offsets


def segment_sum(data, segment_ids, num_segments: int, order=None):
    """out[s] = sum of the rows data[i] with segment_ids[i] == s, shape
    (num_segments, *data.shape[1:]), the same bits on every run.

    Float rows are stably sorted by segment and each segment is summed in
    row order (`torch.segment_reduce`): the order of a sequential
    `index_add_`, whose result it equals bit for bit on the CPU. order, if
    given, is `segment_order(segment_ids, num_segments)`, built once for
    sums that share the ids (segment_ids is then not read); the bits are
    those of the sum that sorts. Integer sums are exact in any order and
    stay an `index_add_`."""
    if not data.is_floating_point():
        return torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                           device=data.device).index_add_(
                               0, segment_ids.long(), data)
    order, offsets = (segment_order(segment_ids, num_segments)
                      if order is None else order)
    return torch.segment_reduce(data[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)


GVEC = (PERC_P @ np.ones(3, np.float32)).astype(np.float32)  # P (1,1,1)
PERC_TAIL_BIT = 1 << 18          # in a packed candidate: see `_perc_rows`

# The small constant tables of the ETC1S ops, by name: made on a device once
# and kept (`constant`), so that no call copies them from the host again and
# a frontend call can be captured in a CUDA graph (`frontend._Graph`).
_TABLES = {
    "inten": lambda: ETC1_INTEN_TABLES.astype(np.float32),      # (8, 4)
    "inten_mid": lambda: _INTEN_MID.astype(np.float32),         # (8, 3)
    "perc_p": lambda: PERC_P,                                   # (3, 3)
    "gvec": lambda: GVEC,                                       # (3,)
    "perc_lanes": lambda: np.array([True, True, False]),        # `_perc_rows`
    **{f"deltas{r}": (lambda r=r: _candidate_deltas(r)) for r in (0, 1, 2)},
}
_CONSTANTS = {}


def constant(name: str, device) -> torch.Tensor:
    """The constant table `name` of `_TABLES` on device: one tensor per
    (table, device), made at its first use. Callers do not write to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _CONSTANTS.get((name, dev))
    if t is None:
        t = _CONSTANTS[(name, dev)] = torch.as_tensor(_TABLES[name](),
                                                      device=dev)
    return t


def perceptual_transform(x):
    """y = P x over the trailing RGB axis, rounded as XLA-CPU rounds the
    reference's product of x, its leading axes flattened to M rows, with
    the constant P^T (`_perc_rows`)."""
    flat = x.reshape(-1, 3)
    vector = torch.arange(flat.shape[0], device=x.device) < _perc_vector_rows(
        flat.shape[0])
    return _perc_rows(flat, vector).reshape(x.shape)


def _perc_vector_rows(m: int) -> int:
    """How many leading rows of an (m, 3) product with P^T XLA-CPU computes
    in its vector loop (`_perc_rows`): whole 8-row blocks, none below 16
    rows or at 20-23 and 28-31 (measured at m 1..160 and beyond)."""
    if m < 16 or 20 <= m < 24 or 28 <= m < 32:
        return 0
    return m - m % 8


def _perc_rows(flat, vector):
    """The rows of flat (M, 3) times P^T in XLA-CPU's order: a row of a whole
    8-row block (`vector`, (M,) bool) takes its first two channels j as
    (x0 P_j0 + x1 P_j1) + x2 P_j2 from rounded products and its third as
    the fused multiply-add chain fma(x2, P_22, fma(x1, P_21, x0 P_20)); the
    other rows (`_perc_vector_rows`) take the chain in all three (measured
    against the reference's jitted product at M 1..1,572,864 on an x86-64
    Intel Xeon with AVX-512, as `_cross6`'s rule; `tests/
    test_torch_etc1s_encode.py` holds it against the host that runs it). A
    packed candidate whose palette the reference transforms among those
    other rows (the refine's codebook of an odd size) carries
    `PERC_TAIL_BIT`."""
    pm = constant("perc_p", flat.device)                        # (3,3) P[j,k]
    prod = [flat[:, k, None] * pm[:, k] for k in range(3)]      # (M,3) each
    chain = _fma(flat[:, 2, None], pm[:, 2],
                 _fma(flat[:, 1, None], pm[:, 1], prod[0]))
    summed = (prod[0] + prod[1]) + prod[2]
    lanes = constant("perc_lanes", flat.device)
    return torch.where(vector[:, None] & lanes, summed, chain)


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
    gray-axis offsets. Returns (..., 8), summed in the order of the
    reference's compiled scan (`xla_order._sum_sq_tree16`)."""
    mids = constant("inten_mid", u.device)
    tabs = constant("inten", u.device)
    uu = u[..., None, :]                                      # (...,1,16)
    k = ((uu > mids[:, 0, None]).to(torch.int32)
         + (uu > mids[:, 1, None]) + (uu > mids[:, 2, None]))  # (...,8,16)
    t0, t1, t2, t3 = (tabs[:, j, None] for j in range(4))
    tk = torch.where(k == 0, t0,
                     torch.where(k == 1, t1, torch.where(k == 2, t2, t3)))
    return _sum_sq_tree16(tk - uu)


def _block_moments(pixels, gvec=None):
    """Per-block sufficient statistics of the factorized scan; gvec is the
    gray axis in pixel space (None: uniform RGB, whole numbers, every sum
    exact). With gvec (the perceptual metric) each sum rounds as XLA-CPU
    rounds the reference's: the luma a fused multiply-add chain over the
    channels, sum_l and sum_x added pixel by pixel, sum_l2 a fused
    multiply-add chain, sum_x2 an 8-lane vector loop over the pixels
    (`_sum_sq_pixels`)."""
    if gvec is None:
        luma = pixels.sum(-1)
        return dict(luma=luma, sum_l=luma.sum(-1),
                    sum_l2=(luma * luma).sum(-1), sum_x=pixels.sum(1),
                    sum_x2=(pixels * pixels).sum((1, 2)))
    luma = _dot(pixels, gvec)
    return dict(luma=luma, sum_l=_sum(luma, -1), sum_l2=_dot(luma, luma),
                sum_x=_sum(pixels, 1), sum_x2=_sum_sq_pixels(pixels))


def _sum_sq_pixels(x):
    """sum over a block's 16 pixels and 3 channels of x^2, (B,), in the
    order of XLA's 8-lane vector loop: lane j chains fma(v, v, acc) over
    the channels of pixel j, then of pixel j + 8; the lanes pairwise."""
    lane = x[:, :8, 0] * x[:, :8, 0]
    for half in (0, 8):
        for ch in range(3):
            if half or ch:
                v = x[:, half:half + 8, ch]
                lane = _fma(v, v, lane)
    return _tree8(lane)


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
    k)`. torch.topk promises no tie order; a stable sort does, and on the
    H100 it is also the faster of the two (PERF.md)."""
    return torch.sort(flat, dim=-1, stable=True).indices[:, :k]


def _refine_shortlist(d6, k: int):
    """The refine's shortlist, (B, min(k, C)) int64: the columns of each
    row's k smallest distances in the order the reference's `approx_min_k`
    gives them on the CPU, where it is a full sort of each row by
    `std::sort` with a comparator on the value alone (XLA-CPU's ApproxTopK
    fallback): `cuda_etc1s.xla_cpu_min_k`, on the card and on the host."""
    return cuda_etc1s.xla_cpu_min_k(d6, min(k, d6.shape[1]))


def encode_blocks(pixels, radius: int = 1, perceptual: bool = False):
    """Per-block ETC1S encode.

    pixels: (B, 16, 3) float32 in [0, 255]. Returns a dict with color5
    (B,3) int32, inten (B,) int32, err (B,) f32, selectors (B,16) int32 and
    low/high (B,3) f32 (the palette's ends, RGB).
    """
    dev = pixels.device
    deltas = constant(f"deltas{radius}", dev)
    base5 = torch.clamp(torch.round(pixels.mean(1) * C31_255).to(torch.int32),
                        0, 31)
    # the unclipped scores shortlist; the exact clipped rescore picks
    cand = cuda_etc1s.factorized_scan_shortlist(
        pixels, radius=radius, perceptual=perceptual)           # (B,K)
    c5k = torch.clamp(base5[:, None, :] + deltas[cand // 8], 0, 31)
    packed = _pack(c5k, cand % 8)
    cerr = cuda_etc1s.palette_errs_packed(pixels, packed,
                                          perceptual=perceptual)
    kbest = torch.argmin(cerr, dim=-1)
    b = torch.arange(pixels.shape[0], device=dev)
    err = cerr[b, kbest]
    color5, inten = _unpack(packed[b, kbest])

    base8 = expand5(color5).float()
    pal = torch.clamp(base8[:, None, :]
                      + constant("inten", dev)[inten.long()][:, :, None],
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
                               perceptual: bool = False, order=None):
    """Optimal (color5 (C,3) int32, inten (C,) int32) per endpoint cluster.

    The reference's formulation: each block's gray-axis sums against its
    CLUSTER base (`factorized_scan`) are summed per cluster with its block
    moments, and each cluster's constant part added (`_cluster_scan`); the
    shortlist of the cluster errors is then rescored exactly over the member
    pixels. order is `segment_order(cluster_ids, num_clusters)` where the
    caller has it (else it is built here); the cluster scan and the rescore's
    sum both read it.
    """
    dev = pixels.device
    ids = cluster_ids.long()
    if order is None:
        order = segment_order(ids, num_clusters)
    deltas = constant(f"deltas{radius}", dev)
    base5 = torch.clamp(
        torch.round(cluster_means * C31_255).to(torch.int32), 0, 31)  # (C,3)
    base8 = expand5(torch.clamp(base5[None] + deltas[:, None, :], 0,
                                31)).float()                    # (D,C,3)
    lb = None
    if perceptual:
        # the reference's gray-axis levels of the cluster bases, (D, C),
        # each block's taken by its cluster's (row d * C + c of the
        # transform, not one of the block's own)
        base8 = perceptual_transform(base8)
        lb = _dot(base8, constant("gvec", dev))
    mt = cuda_etc1s.factorized_scan(
        pixels, base5=base5[ids].float().contiguous(), radius=radius,
        perceptual=perceptual,
        lb=None if lb is None else lb[:, ids].T.contiguous())  # (B,D*8)
    flat = _cluster_scan(pixels, ids, base8, lb, mt, perceptual, order)
    cand = _shortlist(flat, min(16, flat.shape[1]))             # (C,K)
    c5k = torch.clamp(base5[:, None, :] + deltas[cand // 8], 0, 31)
    packed_c = _pack(c5k, cand % 8)                             # (C,K)
    berr = cuda_etc1s.palette_errs_packed(
        pixels, packed_c[ids].contiguous(), perceptual=perceptual)
    cerr = segment_sum(berr, ids, num_clusters, order=order)
    kbest = torch.argmin(cerr, dim=-1)
    c = torch.arange(num_clusters, device=dev)
    return _unpack(packed_c[c, kbest])


def _cluster_scan(pixels, ids, base8, lb, mt, perceptual: bool, order=None):
    """(C, D*8) unclipped cluster errors from the blocks' gray-axis terms mt
    (B, D*8): `cuda_etc1s.cluster_scan_assemble` sums each cluster's
    members' moments and terms in row order and adds each (delta, cluster)'s
    constant part, rounded as XLA's CPU code rounds the reference's. base8
    (D, C, 3) are the cluster bases (perceptually transformed with the
    metric), lb (D, C) their gray-axis levels under the metric (None: their
    sums); order is `segment_order(ids, C)` (built here when None). Without
    the metric the kernel computes the block moments from the pixels (whole
    numbers); with it they are `_block_moments`' of the transformed
    pixels."""
    if order is None:
        order = segment_order(ids, base8.shape[1])
    if not perceptual:
        return cuda_etc1s.cluster_scan_assemble(mt, *order, base8,
                                                pixels=pixels)
    mom = _block_moments(perceptual_transform(pixels),
                         constant("gvec", pixels.device))
    return cuda_etc1s.cluster_scan_assemble(
        mt, *order, base8, lb,
        moments=(mom["sum_x"], mom["sum_x2"], mom["sum_l"], mom["sum_l2"]))


def kmeans_assign(vecs, centroids, num_clusters: int):
    """Each vector's nearest centroid by |b|^2 - 2ab, (N,) int64, the first
    on ties (`cuda_etc1s.cross6_argmin`, which also takes the reference's
    bf16 cross term at >= 1024 clusters: bf16-rounded operands, float32
    product). centroids holds the num_clusters rows."""
    if centroids.shape[0] != num_clusters:
        raise ValueError(f"kmeans_assign: {centroids.shape[0]} centroids for "
                         f"{num_clusters} clusters")
    return cuda_etc1s.cross6_argmin(vecs.contiguous(), centroids.contiguous())


def kmeans_update(sums, cnts, centroids):
    """New centroids from the members' weighted sums and weights; a
    cluster without members keeps its centroid."""
    return torch.where(cnts[:, None] > 0,
                       sums / torch.clamp(cnts[:, None], min=1e-9),
                       centroids)


def kmeans(vecs, weights, init_centroids, num_clusters: int, iters: int = 4):
    """Weighted Lloyd iterations with |a|^2 - 2ab + |b|^2 distances.

    vecs (N, F) f32, weights (N,), init_centroids (C, F).
    Returns (centroids (C, F), assignment (N,) int64).
    """
    wv = vecs * weights[:, None]
    centroids = init_centroids
    assign = None
    for _ in range(iters):
        assign = kmeans_assign(vecs, centroids, num_clusters)
        centroids = kmeans_update(segment_sum(wv, assign, num_clusters),
                                  segment_sum(weights, assign, num_clusters),
                                  centroids)
    return centroids, assign


def bisecting_init(vecs, weights, num_clusters: int, generator=None,
                   fill=None):
    """Top-down bisecting split init: split every cluster along its
    principal axis for ceil(log2(C)) rounds, keep the C most populated
    leaves' means as seeds.

    Empty seeds are replaced by training vectors drawn uniformly with
    replacement: `fill` (C, F) when given, else the vectors the reference
    draws, `jax.random.choice(PRNGKey(seed), vecs, (C,))` with `seed` the
    generator's (`threefry.choice_indices`, drawn on the host).
    """
    n = vecs.shape[0]
    leaves = bisect_leaves(vecs, weights, num_clusters)
    cnt = leaves[:, 0]
    top = torch.argsort(-cnt, stable=True)[:num_clusters]
    seeds = leaves[top, 1:]
    need = cnt[top] <= 0
    if fill is None:
        seed = 0 if generator is None else generator.initial_seed()
        idx = threefry.choice_indices(seed, n, num_clusters)
        fill = vecs[torch.as_tensor(idx, device=vecs.device)]
    return torch.where(need[:, None], fill, seeds)


def bisect_leaves(vecs, weights, num_clusters: int):
    """The bisecting rounds of `bisecting_init`: (2^R, 7) count and mean of
    every leaf after R = max(1, ceil(log2(C))) rounds (the reference's
    `round_body` R times, then its leaf sums). The members of each cluster
    stay contiguous and in row order (`cuda_etc1s.bisect_rows`), and each
    round is one `cuda_etc1s.bisect_round`."""
    rounds = max(1, int(np.ceil(np.log2(num_clusters))))
    members, starts = cuda_etc1s.bisect_rows(vecs.contiguous(),
                                             weights.contiguous())
    for r in range(rounds):
        members, starts, leaves = cuda_etc1s.bisect_round(
            members, starts, last=r == rounds - 1)
    return leaves


def refine_endpoint_assignment(pixels, blk_vec6, cb_vec6, cb_color5, cb_inten,
                               topk: int = 8, perceptual: bool = False):
    """Reassign each block to its best endpoint cluster by exact error:
    a shortlist by 6D codebook distance, then the exact clipped rescore.
    Returns (assignment (B,) int64, err (B,) f32)."""
    d6 = cuda_etc1s.cross6_distances(blk_vec6.contiguous(),
                                     cb_vec6.contiguous())      # (B,C)
    cand = _refine_shortlist(d6, topk)                          # (B,K)
    ptab = _pack(cb_color5, cb_inten)                           # (C,)
    if perceptual:
        # the reference transforms the (C, 4, 3) palettes as 4C rows: those
        # past its vector loop's rows (the last 4 where C is odd) flagged
        first = -(-_perc_vector_rows(4 * ptab.shape[0]) // 4)
        if first < ptab.shape[0]:
            ptab = ptab.clone()
            ptab[first:] |= PERC_TAIL_BIT
    err_k = cuda_etc1s.palette_errs_packed(
        pixels, ptab[cand].contiguous(), perceptual=perceptual)
    best = torch.argmin(err_k, dim=-1)
    b = torch.arange(pixels.shape[0], device=pixels.device)
    return cand[b, best], err_k[b, best]


def block_selector_distances(pixels, pal):
    """d[b, i, k] = ||pixel_bi - pal_bk||^2, (B, 16, 4), the squares a
    fused multiply-add chain over the channels, as XLA-CPU sums them."""
    diff = pixels[:, :, None, :] - pal[:, None, :, :]
    return _dot(diff, diff)


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
