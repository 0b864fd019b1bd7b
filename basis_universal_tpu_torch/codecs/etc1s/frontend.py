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

import collections
import contextlib
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from ...ops import threefry
from ...ops import etc1s_encode as ops
from ...utils import telemetry


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
    tabs = ops.constant("inten", color5.device)
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


def _frontend_impl(px, fill_idx, left_idx, up_idx, e_thresh, s_thresh, *,
                   num_e: int, num_s: int, radius: int, kmeans_iters: int,
                   refine_iters: int, sel_iters: int, topk: int, rdo: bool,
                   perceptual: bool = False, generator=None):
    """The per-image device pipeline. px: (B, 16, 3) on the target device;
    fill_idx (num_e,) int64 on it, the blocks whose vectors fill empty
    k-means seeds (`fill_indices`), or None to draw them from `generator`'s
    seed inside (`ops.bisecting_init`). Returns (assign, color5, inten,
    patterns, sel_assign) tensors on the device.

    It reads nothing back from the card and copies nothing from the host
    (the constant tables come from `ops.constant`), so on a CUDA device it
    can be captured as one graph (`_Graph`)."""
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
    fill = None if fill_idx is None else vec6[fill_idx]
    seeds = ops.bisecting_init(vec6, weights, num_e, generator=generator,
                               fill=fill)
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


def upload(array: np.ndarray, dev) -> torch.Tensor:
    """A host array on dev, counted in the `upload_bytes` counter."""
    telemetry.count("upload_bytes", array.nbytes)
    return torch.as_tensor(array).to(dev)


def fill_indices(seeds, num_blocks: int, num_e: int) -> np.ndarray:
    """(len(seeds), num_e) int64: for each seed, the blocks whose vectors
    fill empty k-means seeds, drawn on the host in one pass over all the
    seeds: the reference's `jax.random.choice(PRNGKey(seed), ...)`, which
    `ops.bisecting_init` draws from a generator seeded with seed
    (`threefry.choice_indices`)."""
    return threefry.choice_indices_many(seeds, num_blocks, num_e)


# --- one CUDA graph per key ---------------------------------------------------
#
# On a CUDA device `_frontend_impl` is ~340 launches a Kodak-sized texture,
# each issued through Python. From the second texture of a key (device,
# input shapes and dtypes, thresholds, knobs) in a batch, the call is
# captured once as a CUDA graph and replayed for each texture of that key
# after: the same launches with the same arguments in the same order, so
# the same bits. The first texture of the batch runs eagerly on a side
# stream, the warm-up a capture wants. A lone `compress` replays a key that
# is cached and otherwise runs eagerly. The cache keeps the `_MAX_GRAPHS`
# keys used last.

_MAX_GRAPHS = 4
_GRAPHS = collections.OrderedDict()     # key -> _Graph, least recent first
_GRAPHS_LOCK = threading.Lock()         # the cache, and each capture


def _capturable(dev) -> bool:
    return dev.type == "cuda"


def _graph_key(dev, inputs, thresholds, knobs):
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return ((dev.type, index), tuple((a.dtype.str, a.shape) for a in inputs),
            thresholds, tuple(sorted(knobs.items())))


class _Graph:
    """`_frontend_impl` captured once on a CUDA device: static device
    inputs (pixels, fill indices, left, up), filled for each texture from
    pinned staging, and the five static outputs, valid until the next
    replay. Its kernels' launches are in no wrapper's count
    (`cuda_etc1s.LAUNCHES`), only in a device trace. Use it under `lock`;
    `released` is set once the cache has dropped it."""

    def __init__(self, dev, inputs, thresholds, knobs):
        self.dev = dev
        self.lock = threading.Lock()
        self.released = False
        self.stage = [torch.from_numpy(a).pin_memory() for a in inputs]
        self.static = [torch.zeros(t.shape, dtype=t.dtype, device=dev)
                       for t in self.stage]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), ops.exact_matmuls(), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(dev),
                capture_error_mode="thread_local"):
            self.outs = _frontend_impl(*self.static, *thresholds, **knobs)

    def run(self, inputs):
        """This texture's inputs copied in (counted in `upload_bytes`), then
        one replay on the device's current stream; returns the outputs."""
        with torch.cuda.device(self.dev):
            for stage, static, a in zip(self.stage, self.static, inputs):
                telemetry.count("upload_bytes", a.nbytes)
                stage.numpy()[...] = a
                static.copy_(stage, non_blocking=True)
            self.graph.replay()
        return self.outs

    def release(self):
        """The graph, its memory pool and its buffers freed."""
        with self.lock:
            self.released = True
            self.graph.reset()
            self.graph = self.outs = self.static = self.stage = None


def _graph(dev, inputs, thresholds, knobs, capture: bool):
    """The graph this texture replays, or None to run it eagerly: the
    cached graph of its key, else, where `capture`, one captured now; never
    on the CPU. Beyond `_MAX_GRAPHS` keys the least recently used is
    dropped, with its graph and memory pool."""
    if not _capturable(dev):
        return None
    key = _graph_key(dev, inputs, thresholds, knobs)
    with _GRAPHS_LOCK:
        graph = _GRAPHS.get(key)
        if graph is not None:
            _GRAPHS.move_to_end(key)
        elif capture:
            graph = _GRAPHS[key] = _Graph(dev, inputs, thresholds, knobs)
            telemetry.count("etc1s.frontend.graph_captures", 1)
            while len(_GRAPHS) > _MAX_GRAPHS:
                _GRAPHS.popitem(last=False)[1].release()
        return graph


def drop_graphs():
    """Free every captured graph and its memory pool: the frontend runs
    eagerly again until a batch captures anew."""
    with _GRAPHS_LOCK:
        while _GRAPHS:
            _GRAPHS.popitem(last=False)[1].release()


@contextlib.contextmanager
def _side_stream(dev):
    """The work inside on a side stream of dev, after the device's work
    before it and before its work after."""
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def _run_one(pixels, params: FrontendParams, knobs, left, up, fill, dev,
             texture: Optional[int] = None, capture: bool = False,
             warm_up: bool = False) -> FrontendOutput:
    """One image's frontend: its uploads and launches, or one replay of its
    key's graph (`_graph`), then the wait for its five results and the
    host's finalize, each a span of `texture`. fill: its seed's row of
    `fill_indices`. capture: the texture repeats its key in a batch, so a
    key not cached is captured now; warm_up: it is the first of a batch,
    whose eager run is a capture's warm-up."""
    thresholds = (float(params.endpoint_rdo_thresh),
                  float(params.selector_rdo_thresh))
    with contextlib.ExitStack() as held:
        with telemetry.span("etc1s.frontend.dispatch", texture=texture):
            inputs = (np.ascontiguousarray(pixels), fill,
                      np.ascontiguousarray(left), np.ascontiguousarray(up))
            graph = _graph(dev, inputs, thresholds, knobs, capture)
            if graph is not None:
                held.enter_context(graph.lock)
                if graph.released:              # dropped by another thread
                    graph = None
            if graph is not None:
                outs = graph.run(inputs)
                telemetry.count("etc1s.frontend.graph_replays", 1)
            else:
                if warm_up and _capturable(dev):
                    held.enter_context(_side_stream(dev))
                with ops.exact_matmuls():
                    outs = _frontend_impl(*(upload(a, dev) for a in inputs),
                                          *thresholds, **knobs)
        with telemetry.span("etc1s.frontend.wait", texture=texture):
            assign, color5, inten, patterns, sel = (t.cpu().numpy()
                                                    for t in outs)
    with telemetry.span("etc1s.frontend.finalize", texture=texture):
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
    (fill,) = fill_indices([seed], pixels.shape[0], knobs["num_e"])
    return _run_one(pixels, params, knobs, left, up, fill, dev)


def compress_batch_iter(pixels, params: FrontendParams, seed: int = 0,
                        neighbors=None):
    """Generator over N same-shaped block arrays (N, B, 16, 3), one image at
    a time; image i uses seed + i. neighbors: optional list of per-image
    (left_idx, up_idx) pairs, or one shared pair. From the second image on
    a CUDA device replays one captured graph (`_graph`)."""
    dev = resolve_device(params.device)
    n = len(pixels)
    if neighbors is not None and isinstance(neighbors, tuple):
        neighbors = [neighbors] * n
    num_blocks = np.asarray(pixels[0]).shape[0]
    knobs, left0, up0 = _knobs_and_neighbors(
        num_blocks, params, neighbors[0] if neighbors else None)
    # every image's fill in one draw: a draw a texture would hand the
    # interpreter lock to the assembly threads hundreds of times
    fills = fill_indices([seed + i for i in range(n)], num_blocks,
                         knobs["num_e"])
    for i in range(n):
        left, up = (np.asarray(neighbors[i][0]), np.asarray(neighbors[i][1])) \
            if neighbors else (left0, up0)
        yield _run_one(np.asarray(pixels[i]), params, knobs, left, up,
                       fills[i], dev, texture=i, capture=i > 0,
                       warm_up=i == 0 and n > 1)


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
