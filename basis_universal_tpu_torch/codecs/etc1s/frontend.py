"""ETC1S frontend: global endpoint/selector codebook generation in PyTorch.

Counterpart of `basis_universal_tpu/codecs/etc1s/frontend.py`. One image
runs as one sequence of device work on one device (`_frontend_impl`):
per-block encode, bisecting k-means init, Lloyd iterations, the endpoint
refine pass, the selector-codebook init and the selector loop. Its results
come back to the host once per image, where `_host_finalize` drops empty
clusters, deduplicates entries and remaps block indices.

`FrontendParams`, `FrontendOutput` and `_host_finalize` are copies of the
reference's (that module imports jax at the top).
"""

import dataclasses

import numpy as np
import torch

from ...ops import etc1s_encode as ops
from ...ops.etc1 import ETC1_INTEN_TABLES


@dataclasses.dataclass
class FrontendParams:
    max_endpoint_clusters: int = 512
    max_selector_clusters: int = 512
    # effort 0-10 scales candidate radii and refinement iterations
    effort: int = 3
    # luma-weighted error metric in every device scan
    perceptual: bool = True
    # neighbour-copy RDO thresholds (1.0 disables)
    endpoint_rdo_thresh: float = 1.0
    selector_rdo_thresh: float = 1.0
    # torch device the frontend runs on ("cuda", "cuda:1", "cpu")
    device: str = "cuda"


@dataclasses.dataclass
class FrontendOutput:
    endpoint_color5: np.ndarray   # (E, 3) uint8
    endpoint_inten5: np.ndarray   # (E,) uint8
    selectors: np.ndarray         # (S, 16) uint8
    block_endpoints: np.ndarray   # (B,) int32
    block_selectors: np.ndarray   # (B,) int32


def resolve_device(device) -> torch.device:
    """The torch device to run on; a CUDA device without CUDA raises
    (the port never silently runs a CUDA request on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _effort_knobs(effort: int):
    radius = 1 if effort <= 4 else 2
    kmeans_iters = 2 + min(effort, 6)
    refine_iters = 1 if effort <= 1 else (2 if effort <= 2 else 3)
    sel_iters = 2 + min(effort, 4)
    topk = 16 if effort <= 5 else 32
    return radius, kmeans_iters, refine_iters, sel_iters, topk


def _palette(color5, inten):
    base8 = ops.expand5(color5).float()
    tabs = torch.as_tensor(ETC1_INTEN_TABLES, dtype=torch.float32,
                           device=color5.device)
    return torch.clamp(base8[:, None, :] + tabs[inten.long()][:, :, None],
                       0.0, 255.0)


def _vec6(pal):
    """The 6D clustering vector (low, high palette ends) in [0, 1]."""
    return torch.cat([pal[:, 0, :], pal[:, 3, :]], -1) * (1.0 / 255.0)


def _init_selector_patterns(opt_sel, num_s: int):
    """'Most frequent optimal patterns' init: pack each block's 16 selectors
    into an int32 key, sort, run-length count, take the num_s most frequent
    (ties: the smaller key first). Returns (num_s, 16) int32."""
    b = opt_sel.shape[0]
    dev = opt_sel.device
    shifts = torch.arange(16, dtype=torch.int64, device=dev) * 2
    words = ((opt_sel.to(torch.int64) & 3) << shifts).sum(1)
    packed = words - ((words >> 31) << 32)                  # int32 value range
    skeys = torch.sort(packed).values
    is_new = torch.ones(b, dtype=torch.int64, device=dev)
    is_new[1:] = (skeys[1:] != skeys[:-1]).to(torch.int64)
    group = torch.cumsum(is_new, 0) - 1
    counts = ops.segment_sum(torch.ones(b, dtype=torch.int64, device=dev),
                             group, b)
    # empty groups keep the int32 minimum, as an empty segment_max does
    values = torch.full((b,), -(1 << 31), dtype=torch.int64, device=dev)
    values[group] = skeys
    top = torch.sort(counts, descending=True, stable=True).indices[:num_s]
    keys = values[top]
    return ((keys[:, None] >> shifts[None, :]) & 3).to(torch.int32)


def _frontend_impl(px, generator, left_idx, up_idx, e_thresh, s_thresh, *,
                   num_e: int, num_s: int, radius: int, kmeans_iters: int,
                   refine_iters: int, sel_iters: int, topk: int, rdo: bool,
                   perceptual: bool = False):
    """The per-image device pipeline. px: (B, 16, 3) on the target device.
    Returns (assign, color5, inten, patterns, sel_assign) tensors on it."""
    px = px.float()
    nblocks = px.shape[0]
    dev = px.device

    def to_metric(x):
        return ops.perceptual_transform(x) if perceptual else x

    px_m = to_metric(px)
    init = ops.encode_blocks(px, radius=radius, perceptual=perceptual)
    # the 6D clustering vectors stay RGB, as in the reference
    vec6 = torch.cat([init["low"], init["high"]], -1) * (1.0 / 255.0)
    weights = torch.ones(nblocks, dtype=torch.float32, device=dev)
    seeds = ops.bisecting_init(vec6, weights, num_e, generator=generator)
    _, assign = ops.kmeans(vec6, weights, seeds, num_e, iters=kmeans_iters)

    color5 = torch.zeros((num_e, 3), dtype=torch.int32, device=dev)
    inten = torch.zeros(num_e, dtype=torch.int32, device=dev)
    blk_mean = px.mean(1)
    for _ in range(refine_iters):
        # one order of the assignment for every sum of the pass
        order = ops.segment_order(assign, num_e)
        cnt = ops.segment_sum(weights, assign, num_e, order=order)
        mean_px = ops.segment_sum(blk_mean, assign, num_e, order=order)
        cluster_means = mean_px / torch.clamp(cnt, min=1.0)[:, None]
        color5, inten = ops.optimize_cluster_endpoints(
            px, assign, cluster_means, num_e, radius=radius,
            perceptual=perceptual, order=order)
        cb_vec6 = _vec6(_palette(color5, inten))
        assign, _ = ops.refine_endpoint_assignment(
            px, vec6, cb_vec6, color5, inten, topk=topk,
            perceptual=perceptual)
    cb_pal_m = to_metric(_palette(color5, inten))

    dists = ops.block_selector_distances(px_m, cb_pal_m[assign])  # (B,16,4)
    opt_sel = torch.argmin(dists, dim=-1)
    patterns = _init_selector_patterns(opt_sel, num_s)
    for _ in range(sel_iters):
        sel_assign, _ = ops.find_best_selector_patterns(dists, patterns, num_s)
        patterns = ops.update_selector_patterns(dists, sel_assign, num_s)
    sel_assign, _ = ops.find_best_selector_patterns(dists, patterns, num_s)

    if rdo:
        assign, sel_assign = ops.rdo_neighbor_copy(
            px_m, assign, sel_assign, cb_pal_m, patterns,
            left_idx, up_idx, e_thresh, s_thresh)
    return assign, color5, inten, patterns, sel_assign


def _knobs_and_neighbors(pixels_shape_b: int, params: FrontendParams,
                         neighbors):
    """The frontend's static knobs for B blocks, plus (left, up) numpy
    neighbour index arrays (-1 = none)."""
    radius, kmeans_iters, refine_iters, sel_iters, topk = _effort_knobs(
        params.effort)
    num_e = int(min(params.max_endpoint_clusters, pixels_shape_b))
    num_s = int(min(params.max_selector_clusters, pixels_shape_b))
    # wide codebooks need a wider exact-reassign shortlist
    if num_e > 4096:
        topk = max(topk, min(64, num_e // 128))
    topk = min(topk, num_e)
    rdo = (neighbors is not None
           and (params.endpoint_rdo_thresh > 1.0
                or params.selector_rdo_thresh > 1.0))
    if neighbors is None:
        left = np.full(pixels_shape_b, -1, dtype=np.int32)
        up = left
    else:
        left, up = neighbors
    # effort-1 iteration trim on sparse codebooks (blocks >> clusters)
    if params.effort <= 1 and pixels_shape_b >= 4 * num_e:
        kmeans_iters = min(kmeans_iters, 2)
        sel_iters = min(sel_iters, 2)
    knobs = dict(num_e=num_e, num_s=num_s, radius=radius,
                 kmeans_iters=kmeans_iters, refine_iters=refine_iters,
                 sel_iters=sel_iters, topk=topk, rdo=rdo,
                 perceptual=bool(params.perceptual))
    return knobs, np.asarray(left), np.asarray(up)


def _run_one(pixels, params: FrontendParams, knobs, left, up, seed: int,
             dev) -> FrontendOutput:
    px = torch.as_tensor(np.ascontiguousarray(pixels)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with ops.exact_matmuls():
        outs = _frontend_impl(
            px, gen, torch.as_tensor(left).to(dev),
            torch.as_tensor(up).to(dev), float(params.endpoint_rdo_thresh),
            float(params.selector_rdo_thresh), **knobs)
    assign, color5, inten, patterns, sel = (t.cpu().numpy() for t in outs)
    return _host_finalize(assign, color5, inten, patterns, sel,
                          knobs["num_e"], knobs["num_s"])


def compress(pixels: np.ndarray, params: FrontendParams, seed: int = 0,
             neighbors=None) -> FrontendOutput:
    """pixels: (B, 16, 3) uint8 or float32 RGB in [0, 255], one entry per
    4x4 block. neighbors: optional (left_idx, up_idx) flat int32 arrays."""
    pixels = np.asarray(pixels)
    if pixels.ndim != 3 or pixels.shape[1:] != (16, 3):
        raise ValueError(f"pixels must be (B, 16, 3), got {pixels.shape}")
    dev = resolve_device(params.device)
    knobs, left, up = _knobs_and_neighbors(pixels.shape[0], params, neighbors)
    return _run_one(pixels, params, knobs, left, up, seed, dev)


def compress_batch_iter(pixels, params: FrontendParams, seed: int = 0,
                        neighbors=None):
    """Generator over N same-shaped block arrays (N, B, 16, 3), one image at
    a time; image i uses seed + i. neighbors: optional list of per-image
    (left_idx, up_idx) pairs, or one shared pair."""
    dev = resolve_device(params.device)
    n = len(pixels)
    if neighbors is not None and isinstance(neighbors, tuple):
        neighbors = [neighbors] * n
    knobs, left0, up0 = _knobs_and_neighbors(
        np.asarray(pixels[0]).shape[0], params,
        neighbors[0] if neighbors else None)
    for i in range(n):
        left, up = (np.asarray(neighbors[i][0]), np.asarray(neighbors[i][1])) \
            if neighbors else (left0, up0)
        yield _run_one(np.asarray(pixels[i]), params, knobs, left, up,
                       seed + i, dev)


def _assign_global(px, cb_color5, cb_inten, patterns, topk: int, num_s: int,
                   perceptual: bool = False):
    """Global-codebooks mode: one nearest-neighbour assignment pass against
    fixed codebooks. Returns (assign, sel_assign) tensors."""
    def to_metric(x):
        return ops.perceptual_transform(x) if perceptual else x

    enc = ops.encode_blocks(px, radius=0, perceptual=perceptual)
    vec6 = torch.cat([enc["low"], enc["high"]], -1) * (1.0 / 255.0)
    cb_pal = _palette(cb_color5, cb_inten)
    assign, _ = ops.refine_endpoint_assignment(
        px, vec6, _vec6(cb_pal), cb_color5, cb_inten, topk=topk,
        perceptual=perceptual)
    dists = ops.block_selector_distances(to_metric(px),
                                         to_metric(cb_pal)[assign])
    sel_assign, _ = ops.find_best_selector_patterns(dists, patterns, num_s)
    return assign, sel_assign


def compress_with_global_codebooks(pixels: np.ndarray, color5, inten5,
                                   selectors, effort: int = 1,
                                   perceptual: bool = True,
                                   device="cuda") -> FrontendOutput:
    """Assign blocks to externally provided (shared) codebooks."""
    dev = resolve_device(device)
    topk = 8 if effort <= 5 else 16
    selectors = np.asarray(selectors)
    with ops.exact_matmuls():
        assign, sel = _assign_global(
            torch.as_tensor(np.asarray(pixels, dtype=np.float32)).to(dev),
            torch.as_tensor(np.asarray(color5, dtype=np.int32)).to(dev),
            torch.as_tensor(np.asarray(inten5, dtype=np.int32)).to(dev),
            torch.as_tensor(selectors.astype(np.int32)).to(dev),
            topk, int(selectors.shape[0]), bool(perceptual))
    return FrontendOutput(
        endpoint_color5=np.asarray(color5, dtype=np.uint8),
        endpoint_inten5=np.asarray(inten5, dtype=np.uint8),
        selectors=np.asarray(selectors, dtype=np.uint8),
        block_endpoints=assign.cpu().numpy().astype(np.int32),
        block_selectors=sel.cpu().numpy().astype(np.int32),
    )


def _host_finalize(assign_np, color5_np, inten_np, pat_np, sel_np,
                   num_e: int, num_s: int) -> FrontendOutput:
    """Drop empty clusters, dedup identical entries, remap block indices."""
    pat_np = pat_np.astype(np.uint8)

    used = np.zeros(num_e, dtype=bool)
    used[np.unique(assign_np)] = True
    packed = (color5_np[:, 0].astype(np.int64) << 16) \
        | (color5_np[:, 1].astype(np.int64) << 11) \
        | (color5_np[:, 2].astype(np.int64) << 6) | inten_np.astype(np.int64)
    packed[~used] = -1
    uniq, remap_to_uniq = np.unique(packed, return_inverse=True)
    keep = uniq >= 0
    new_index = np.full(uniq.shape, -1, dtype=np.int64)
    new_index[keep] = np.arange(keep.sum())
    block_endpoints = new_index[remap_to_uniq[assign_np]].astype(np.int32)
    if not (block_endpoints >= 0).all():
        raise AssertionError("a block references a dropped endpoint")
    kept_vals = uniq[keep]
    e_color5 = np.zeros((int(keep.sum()), 3), dtype=np.uint8)
    e_color5[:, 0] = (kept_vals >> 16) & 31
    e_color5[:, 1] = (kept_vals >> 11) & 31
    e_color5[:, 2] = (kept_vals >> 6) & 31
    e_inten = (kept_vals & 7).astype(np.uint8)

    used_s = np.zeros(num_s, dtype=bool)
    used_s[np.unique(sel_np)] = True
    key_s = pat_np.astype(np.int64) @ (np.int64(4) ** np.arange(16, dtype=np.int64))
    key_s[~used_s] = -1
    uniq_s, first_idx, inv_s = np.unique(key_s, return_index=True,
                                         return_inverse=True)
    keep_s = uniq_s >= 0
    new_s = np.full(uniq_s.shape, -1, dtype=np.int64)
    new_s[keep_s] = np.arange(keep_s.sum())
    block_selectors = new_s[inv_s[sel_np]].astype(np.int32)
    if not (block_selectors >= 0).all():
        raise AssertionError("a block references a dropped selector")
    sel_cb = pat_np[first_idx[keep_s]]

    return FrontendOutput(
        endpoint_color5=e_color5,
        endpoint_inten5=e_inten,
        selectors=sel_cb,
        block_endpoints=block_endpoints,
        block_selectors=block_selectors,
    )
