"""CUDA kernels of the ETC1S encoder, with their plain versions.

Counterpart of `basis_universal_tpu/ops/pallas_etc1s.py`, all four of its
kernels: the ETC1S frontend's scan, packed rescore and selector search (the
UASTC encoder's ETC1 hint and the transcoder's ETC1 re-encode run the scan
and the packed rescore too), and `palette_errs`, which no path of either
package calls; and the kernels for operators that are XLA's in the
reference and whose CPU rounding decides the codebooks: the 6-D codebook
distances (`cross6_argmin` for the k-means assignment, `cross6_distances`
for the refine's shortlist), the cluster scan's segment sums and assembly
(`cluster_scan_assemble`), the bisecting init's rounds (`bisect_rows`,
`bisect_round`), and the refine shortlist in the tie order of the
reference's `approx_min_k` on the CPU (`xla_cpu_min_k`, whose plain version
is the same sort on the host, `csrc/host_sort.cpp`: no PyTorch operator
orders ties that way). The scan has two variants: `factorized_scan`, the full
(B, D*8) gray-axis sums that the cluster scan assembles into errors, and
`factorized_scan_shortlist`, which returns only each block's shortlist of
error columns. Each wrapper checks its inputs, then dispatches on the
device of the tensors it was given:

- a CUDA tensor launches the hand-written kernel of `csrc/etc1s_kernels.cu`
  (or of `csrc/etc1s_codebook.h`, which it includes) on the current stream
  (and raises if the launch is refused);
- a CPU tensor runs the plain PyTorch version kept beside it (`*_reference`).

The plain version never runs for a CUDA tensor. `LAUNCHES` counts the kernel
launches of each wrapper (here, in `ops/xla_order.py`, in
`codecs/uastc/encode.py` and in `codecs/uastc/pack.py`) that run when the
wrapper is called; `reset_launch_counts()` zeroes it. A launch recorded into a
CUDA graph under capture is not counted, and a replay of the graph launches
its kernels without a wrapper call: only the device trace sees those
(`testing/launches.py`).
"""

import numpy as np
import torch

from .etc1 import ETC1_INTEN_TABLES

LAUNCHES = {
    "factorized_scan": 0,
    "factorized_scan_shortlist": 0,
    "palette_errs_packed": 0,
    "palette_errs": 0,
    "find_best_selector_patterns": 0,
    "cross6_argmin": 0,
    "cross6_distances": 0,
    "cluster_scan_assemble": 0,
    "bisect_rows": 0,
    "bisect_round": 0,
    "xla_cpu_min_k": 0,
    # XLA-CPU's float32 orders (`ops/xla_order.py`)
    "xla_fma": 0,
    "xla_reduce": 0,
    # the UASTC search's line fits and mode trials (`codecs/uastc/encode.py`)
    "uastc_line_fit": 0,
    "uastc_mode_trial": 0,
    "uastc_subset_trial": 0,
    "uastc_dualplane_trial": 0,
    # the UASTC block packing (`codecs/uastc/pack.py`)
    "uastc_pack": 0,
}

# float32 constants of the kernels, as Python floats holding the exact f32
# value (so `tensor * const` rounds the same way on every device)
THIRD = float(np.float32(1.0 / 3.0))
C31_255 = float(np.float32(31.0 / 255.0))
# the k-means cross term takes bf16 operands from this many centroids on
# (`kCross6Bf16Clusters`), as the reference's `kmeans` does
CROSS6_BF16_CLUSTERS = 1024
_INTEN_MID = (ETC1_INTEN_TABLES[:, :-1] + ETC1_INTEN_TABLES[:, 1:]) / 2.0


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(name: str):
    """One launch of wrapper `name`'s kernel counted, unless this thread's
    stream is capturing a CUDA graph (the launch then runs only in the
    graph's replays). No stream captures before CUDA is initialised (the
    host builds of the kernels launch without it)."""
    if not (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        LAUNCHES[name] += 1


def _check(t, name, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _same_device(*ts):
    dev = ts[0].device
    for t in ts[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(status: int, kernel: str):
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _n_deltas(radius: int) -> int:
    if radius not in (0, 1, 2):
        raise ValueError(f"radius must be 0, 1 or 2, got {radius}")
    return (2 * radius + 1) ** 3


# ---------------------------------------------------------------------------
# factorized_scan
# ---------------------------------------------------------------------------

def _scan_inputs(pixels, base5):
    """Checks the scan's inputs; returns (device, pixels) with the pixels
    16-byte aligned for the kernel's float4 staging loads."""
    _check(pixels, "pixels", torch.float32, (None, 16, 3))
    if base5 is not None:
        _check(base5, "base5", torch.float32, (pixels.shape[0], 3))
    dev = _same_device(pixels, base5)
    if dev.type == "cuda" and pixels.data_ptr() % 16:
        pixels = pixels.clone()
    return dev, pixels


def factorized_scan(pixels, base5=None, radius: int = 1,
                    perceptual: bool = False, lb=None):
    """Gray-axis sums of the factorized ETC1S scan, (B, D*8) float32.

    Replaces `pallas_etc1s.factorized_scan` (`_fscan_kernel`) where the
    reference's errors are summed over clusters. Its unclipped error of
    candidate delta d (`_candidate_deltas(radius)`) with intensity table t
    is err = q - su2/3 + 3 * sum_i min_k (t_k - u_i)^2; column d*8 + t holds
    the gray-axis sum sum_i min_k (t_k - u_i)^2, which
    `optimize_cluster_endpoints` sums over a cluster's blocks before it adds
    the cluster's constant part (q - su2/3 from the cluster's moments), as
    the reference's formulation does. The per-block errors themselves are
    `factorized_scan_shortlist`'s, which keeps only their shortlist. The
    base colour is the block mean rounded to 5 bits, or `base5` (B, 3)
    float32 when given (the cluster base of `optimize_cluster_endpoints`).
    With the perceptual metric, lb (B, D) float32 gives each block's
    gray-axis level of each candidate (its cluster's, transformed as the
    reference transforms the (D, C, 3) cluster bases) in place of the one
    its own base would give.

    On the H100 the scan is bound by its arithmetic, 16 pixels x (a compare,
    a select, two multiply-adds) per column, not by its bytes (PERF.md has
    both beside the measured times). The kernel stages a tile of blocks in
    shared memory, computes each block's moments once and loops over the
    deltas inside the CTA, one warp per block; a warp writes its block's
    row of the row-major (B, D*8) result, whose rows the segment sum of
    `optimize_cluster_endpoints` gathers whole.
    """
    n_d = _n_deltas(radius)
    dev, pixels = _scan_inputs(pixels, base5)
    if lb is not None:
        _check(lb, "lb", torch.float32, (pixels.shape[0], n_d))
        _same_device(pixels, lb)
    if dev.type == "cpu":
        return factorized_scan_reference(pixels, base5, radius, perceptual,
                                         lb)
    from ._build import get_lib

    b_n = pixels.shape[0]
    out = torch.empty((b_n, n_d * 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_factorized_scan(
            pixels.data_ptr(), None if base5 is None else base5.data_ptr(),
            None if lb is None else lb.data_ptr(), out.data_ptr(), b_n,
            radius, int(bool(perceptual)), _stream(dev))
    _launched("factorized_scan")
    _raise_on(status, "factorized_scan")
    return out


def factorized_scan_shortlist(pixels, base5=None, radius: int = 1,
                              perceptual: bool = False, k=None):
    """The columns of the k smallest unclipped scan errors of each block,
    (B, k) int64, ascending, equal errors by ascending column (also at the
    k-th place): `_shortlist` of `factorized_scan_errors_reference`, the
    order of `lax.top_k(-flat, k)` after the reference's scan. k defaults to
    min(16, D*8).

    The errors never reach device memory: the kernel runs the full scan's
    arithmetic (the same device function, so the same gray-axis sums per
    column), assembles each error and each warp selects its block's k
    smallest columns from registers.
    """
    n_cols = _n_deltas(radius) * 8
    k = min(16, n_cols) if k is None else k
    if not 1 <= k <= min(16, n_cols):
        raise ValueError(f"k must be in 1..{min(16, n_cols)} at radius "
                         f"{radius}, got {k}")
    dev, pixels = _scan_inputs(pixels, base5)
    if dev.type == "cpu":
        return factorized_scan_shortlist_reference(pixels, base5, radius,
                                                   perceptual, k)
    from ._build import get_lib

    b_n = pixels.shape[0]
    out = torch.empty((b_n, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_factorized_scan_shortlist(
            pixels.data_ptr(), None if base5 is None else base5.data_ptr(),
            out.data_ptr(), b_n, radius, int(bool(perceptual)), k,
            _stream(dev))
    _launched("factorized_scan_shortlist")
    _raise_on(status, "factorized_scan_shortlist")
    return out


def factorized_scan_shortlist_reference(pixels, base5=None, radius: int = 1,
                                        perceptual: bool = False, k=None):
    """Plain PyTorch version of `factorized_scan_shortlist`: the plain
    errors, then a stable sort (`etc1s_encode._shortlist`)."""
    from .etc1s_encode import _shortlist

    flat = factorized_scan_errors_reference(pixels, base5, radius, perceptual)
    return _shortlist(flat, min(16, flat.shape[1]) if k is None else k)


def factorized_scan_reference(pixels, base5=None, radius: int = 1,
                              perceptual: bool = False, lb=None):
    """Plain PyTorch version of `factorized_scan`: the gray-axis sums of
    `factorized_scan_errors_reference`, (B, D*8)."""
    mt, _ = _scan_terms(pixels, base5, radius, perceptual, lb)
    return mt.permute(1, 0, 2).reshape(pixels.shape[0], -1)


def factorized_scan_errors_reference(pixels, base5=None, radius: int = 1,
                                     perceptual: bool = False):
    """The unclipped errors of every column, (B, D*8) float32, in the
    reference's XLA formulation (`etc1s_encode._scan_block_errs`, with the
    kernel's base): what `pallas_etc1s.factorized_scan` returns, and what
    `factorized_scan_shortlist` ranks.

    The assembly is rounded as XLA's CPU code rounds the reference's scan
    (read from its LLVM IR): su2 = fma(lb, 16 lb, fma(-2 lb, sum_l,
    sum_l2)), the constant part fma(-su2, 1/3, q), the gray-axis sum over
    the 16 pixels in 8-lane vector order (`xla_order._sum_sq_tree16`) and
    err = fma(sum, 3, constant). For whole-numbered pixels without the
    perceptual metric the moments are exact integers, so the result is the
    reference's to the bit; the kernel computes the same operations."""
    from .xla_order import _fma

    mt, cst = _scan_terms(pixels, base5, radius, perceptual)
    err = _fma(mt, 3.0, cst[..., None])
    return err.permute(1, 0, 2).reshape(pixels.shape[0], -1)


def _scan_terms(pixels, base5, radius: int, perceptual: bool, lb=None):
    """The scan's two parts, (D, B, 8) gray-axis sums and (D, B) constant
    parts q - su2/3, rounded as the docstring above says; with the
    perceptual metric the moments, the transforms (the candidate bases as
    the (D, B, 3) array of the reference's scan) and the dot products are
    XLA-CPU's too (`etc1s_encode._block_moments`, `perceptual_transform`,
    `xla_order._dot`), and lb (B, D), where given, replaces the gray-axis
    levels of the bases in the gray-axis sums (a cluster's, in the cluster
    scan)."""
    from .etc1s_encode import (_block_moments, _gray_axis_minterm, constant,
                               perceptual_transform)
    from .xla_order import _dot, _fma

    dev = pixels.device
    px = pixels.float()
    deltas = constant(f"deltas{radius}", dev)
    if base5 is None:
        b5 = torch.clamp(torch.round(px.sum(1) / 16.0 * C31_255), 0.0, 31.0)
    else:
        b5 = base5.float()
    c5 = torch.clamp(b5[None] + deltas[:, None, :].float(), 0.0, 31.0)
    base8 = c5 * 8.0 + torch.floor(c5 * 0.25)                    # (D,B,3)
    if perceptual:
        gvec = constant("gvec", dev)
        px = perceptual_transform(px)
        base8 = perceptual_transform(base8)
        lb_base = _dot(base8, gvec)                              # (D,B)
    else:
        gvec = None
        lb_base = base8.sum(-1)
    mom = _block_moments(px, gvec)
    q = ((mom["sum_x2"][None] - 2.0 * _dot(base8, mom["sum_x"][None]))
         + 16.0 * _dot(base8, base8))
    su2 = _fma(lb_base, 16.0 * lb_base, _fma(-2.0 * lb_base, mom["sum_l"][None],
                                             mom["sum_l2"][None]))
    cst = _fma(-su2, THIRD, q)
    lb_u = lb_base if lb is None else lb.T
    u = (mom["luma"][None] - lb_u[..., None]) * THIRD            # (D,B,16)
    return _gray_axis_minterm(u), cst


# ---------------------------------------------------------------------------
# palette_errs_packed
# ---------------------------------------------------------------------------

def palette_errs_packed(pixels, packed, perceptual: bool = False):
    """Exact gamut-clipped ETC1S errors from packed candidates, (B, K) f32.

    Replaces `pallas_etc1s.palette_errs_packed` (`_rescore_kernel`).
    packed: (B, K) int32, r5 | g5<<5 | b5<<10 | inten<<15. err[b, k] =
    sum_i min_sel ||x_bi - clip(expand5(c5) + t_sel)||^2; with
    `perceptual` the pixels and the palette are transformed apart and the
    distance rounds as the reference's (`palette_errs_packed_reference`;
    bit 18, `etc1s_encode.PERC_TAIL_BIT`, flags a palette that the
    reference transforms past its vector loop).

    On the H100 this is a small compute-bound pass (4 palette entries x 16
    pixels x 7 float32 operations per output, in an order that must not
    change): a CTA stages its blocks' pixels in shared memory once and runs
    one thread per (block, candidate) on a 2-D grid of threads, which
    rebuilds its palette in registers from the packed word, so no (B, K, 4,
    3) palette ever reaches device memory; the perceptual variant is a
    template flag with the matrix baked in. K is at most 256.
    """
    _check(pixels, "pixels", torch.float32, (None, 16, 3))
    _check(packed, "packed", torch.int32, (pixels.shape[0], None))
    if not 1 <= packed.shape[1] <= 256:
        raise ValueError(f"packed: 1 to 256 candidates per block, got "
                         f"{packed.shape[1]}")
    dev = _same_device(pixels, packed)
    if dev.type == "cpu":
        return palette_errs_packed_reference(pixels, packed, perceptual)
    from ._build import get_lib

    b_n, k_n = packed.shape
    out = torch.empty((b_n, k_n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_palette_errs_packed(
            pixels.data_ptr(), packed.data_ptr(), out.data_ptr(), b_n, k_n,
            int(bool(perceptual)), _stream(dev))
    _launched("palette_errs_packed")
    _raise_on(status, "palette_errs_packed")
    return out


def palette_errs_packed_reference(pixels, packed, perceptual: bool = False):
    """Plain PyTorch version of `palette_errs_packed`. With the perceptual
    metric it is the reference's XLA formulation, rounded as XLA-CPU
    rounds it: the pixels and the palettes transformed apart
    (`etc1s_encode.perceptual_transform`; a palette flagged
    `PERC_TAIL_BIT` as the reference's last rows), the squared distances
    fused multiply-add chains over the channels, the 16 minima added in
    pixel order."""
    from .etc1s_encode import (PERC_TAIL_BIT, _perc_rows, constant,
                               perceptual_transform)
    from .xla_order import _dot, _sum

    dev = pixels.device
    v = packed.to(torch.int32)
    c5 = torch.stack([v & 31, (v >> 5) & 31, (v >> 10) & 31], -1).float()
    tabs = constant("inten", dev)
    tsel = tabs[((v >> 15) & 7).long()]                          # (B,K,4)
    b8 = c5 * 8.0 + torch.floor(c5 * 0.25)                       # (B,K,3)
    pal = torch.clamp(b8[:, :, None, :] + tsel[..., None], 0.0, 255.0)
    if not perceptual:
        diff = pixels.float()[:, None, None, :, :] - pal[:, :, :, None, :]
        dist = (diff * diff).sum(-1)                             # (B,K,4,16)
        return dist.min(dim=2).values.sum(-1)
    vector = ((v & PERC_TAIL_BIT) == 0)[..., None].expand(
        *v.shape, 4).reshape(-1)
    pal = _perc_rows(pal.reshape(-1, 3), vector).reshape(pal.shape)
    px = perceptual_transform(pixels.float())
    diff = pal[:, :, :, None, :] - px[:, None, None, :, :]
    return _sum(_dot(diff, diff).min(dim=2).values, -1)


# ---------------------------------------------------------------------------
# palette_errs
# ---------------------------------------------------------------------------

def palette_errs(pixels, palettes):
    """Exact ETC1S errors against explicit palettes, (B, K) float32.

    Replaces `pallas_etc1s.palette_errs` (`_errs_kernel`). pixels: (B, 16,
    3) float32; palettes: (B, K, 4, 3) float32 (already clipped, and
    perceptually transformed with the pixels where the caller scores in that
    metric). err[b, k] = sum_i min_sel ||x_bi - pal_bk,sel||^2.

    The packed rescore's function with the palette read instead of rebuilt:
    one thread per (block, candidate) loads its palette's 12 floats (48
    contiguous bytes) and the block's 16 pixels, ~200 FLOPs per output, so
    like `palette_errs_packed` it is a small pass; what it adds over that
    kernel is the palette traffic, 48 bytes per output against 4. No path of
    the port calls it, as none of the reference does.
    """
    _check(pixels, "pixels", torch.float32, (None, 16, 3))
    _check(palettes, "palettes", torch.float32, (pixels.shape[0], None, 4, 3))
    dev = _same_device(pixels, palettes)
    if dev.type == "cpu":
        return palette_errs_reference(pixels, palettes)
    from ._build import get_lib

    b_n, k_n = palettes.shape[:2]
    out = torch.empty((b_n, k_n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_palette_errs(
            pixels.data_ptr(), palettes.data_ptr(), out.data_ptr(), b_n, k_n,
            _stream(dev))
    _launched("palette_errs")
    _raise_on(status, "palette_errs")
    return out


def palette_errs_reference(pixels, palettes):
    """Plain PyTorch version of `palette_errs`: the reference's XLA broadcast
    (`etc1s_encode._palette_errs`)."""
    diff = palettes[:, :, :, None, :] - pixels[:, None, None, :, :]
    d = (diff * diff).sum(-1)                                    # (B,K,4,16)
    return d.min(dim=2).values.sum(-1)


# ---------------------------------------------------------------------------
# cross6_argmin / cross6_distances
# ---------------------------------------------------------------------------

def _cross6_inputs(a, c):
    _check(a, "a", torch.float32, (None, 6))
    _check(c, "c", torch.float32, (None, 6))
    if c.shape[0] < 1:
        raise ValueError("c: at least one centroid")
    return _same_device(a, c)


def cross6_argmin(a, c):
    """argmin_j (q[j] - 2 a[n].c[j]) per row, (N,) int64, the first index on
    ties: the k-means assignment of the vectors a (N, 6) to the centroids c
    (C, 6), float32, q the centroids' squared norms.

    The reference's `kmeans` step (`basis_universal_tpu/ops/
    etc1s_encode.py:357`, which has no Pallas kernel) in its CPU rounding:
    q = `_sum(c * c, -1)` of the centroids as given, and at C >=
    `CROSS6_BF16_CLUSTERS` the cross term of the bf16-rounded operands (the
    reference's bf16 matmul with float32 accumulation); the product summed
    in the order of XLA's CPU matrix product for C columns
    (`xla_order._cross6`). The kernel (`cross6_argmin_kernel`,
    `csrc/etc1s_codebook.h`) spells every rounding out: the thread that
    stages a centroid sums its q and rounds its coordinates, q - 2x is one
    fused multiply-add (-2x is exact, so the bits are the same), and a
    running argmin of 16 rows per warp stays in registers, so no (N, C)
    matrix reaches device memory. At the main path's shape (24,576 x 2,416)
    it is bound by its instructions, 9 per (row, centroid) pair.
    """
    dev = _cross6_inputs(a, c)
    if dev.type == "cpu":
        return cross6_argmin_reference(a, c)
    from ._build import get_lib

    out = torch.empty(a.shape[0], dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_cross6_argmin(
            a.data_ptr(), c.data_ptr(), out.data_ptr(), a.shape[0],
            c.shape[0], _stream(dev))
    _launched("cross6_argmin")
    _raise_on(status, "cross6_argmin")
    return out


def cross6_argmin_reference(a, c):
    """Plain PyTorch version of `cross6_argmin`."""
    from .xla_order import _cross6, _sum

    q = _sum(c * c, -1)
    if c.shape[0] >= CROSS6_BF16_CLUSTERS:
        a = a.to(torch.bfloat16).float()
        c = c.to(torch.bfloat16).float()
    return torch.argmin(q[None, :] - 2.0 * _cross6(a, c), dim=-1)


def cross6_distances(a, c):
    """(r[n] - 2 a[n].c[j]) + q[j], (N, C) float32: the refine's 6-D
    codebook distances of the blocks' vectors a (N, 6) to the codebook's c
    (C, 6), r and q their squared norms, each `_dot(v, v)` (a fused
    multiply-add chain).

    The product is summed as in `cross6_argmin`; this is the reference's
    `d6` of `refine_endpoint_assignment` (`basis_universal_tpu/ops/
    etc1s_encode.py:452`, an XLA matrix product) with its 2 x taken out of
    the product (exact). The kernel (`cross6_kernel<false>`) computes r from
    the rows a warp holds and q as it stages the codebook, and writes the
    matrix row-major, 237 MB at the main path's shape, which bounds it.
    """
    dev = _cross6_inputs(a, c)
    if dev.type == "cpu":
        return cross6_distances_reference(a, c)
    from ._build import get_lib

    out = torch.empty((a.shape[0], c.shape[0]), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_cross6_distances(
            a.data_ptr(), c.data_ptr(), out.data_ptr(), a.shape[0],
            c.shape[0], _stream(dev))
    _launched("cross6_distances")
    _raise_on(status, "cross6_distances")
    return out


def cross6_distances_reference(a, c):
    """Plain PyTorch version of `cross6_distances`."""
    from .xla_order import _cross6, _dot

    return (_dot(a, a)[:, None] - 2.0 * _cross6(a, c)) + _dot(c, c)[None, :]


# ---------------------------------------------------------------------------
# cluster_scan_assemble
# ---------------------------------------------------------------------------

def cluster_scan_assemble(mt, order, offsets, base8, lb=None, *, pixels=None,
                          moments=None):
    """The cluster scan's unclipped errors, (C, D*8) float32: column d*8 + t
    of cluster c is the error of its base plus delta d with table t.

    The clusters' sums of their members' block moments and gray-axis terms,
    then their assembly: mt (B, D*8) float32 are the blocks' gray-axis sums
    against their cluster bases (`factorized_scan`); order (B,) and offsets
    (C + 1,) int64 the stable order of the blocks' cluster ids and each
    cluster's first place in it (`etc1s_encode.segment_order`); base8 (D, C,
    3) the cluster bases (perceptually transformed with that metric). The
    block moments: without the perceptual metric the pixels (B, 16, 3),
    whole numbers in [0, 255] as the frontend gives them (every moment
    exact, so the kernel computes them); with it `moments` = (sum_x (B, 3),
    sum_x2, sum_l, sum_l2 (B,)) of `etc1s_encode._block_moments` and lb (D,
    C) the bases' gray-axis levels under the metric. Each sum is one chain
    of adds over the cluster's members in row order from +0.0 (`segment_sum`'s
    order); the assembly rounds as XLA's CPU code rounds the reference's
    (`basis_universal_tpu/ops/etc1s_encode.py:284-306`, no Pallas kernel):
    q = fma(16n, b.b, sum_x2 - 2 b.sum_x), su2 = fma(lb, 16n lb, fma(-2 sum_l,
    lb, sum_l2)), err = fma(mt, 3, fma(-su2, 1/3, q)), the dot products fused
    multiply-add chains (`cluster_scan_assemble_reference`).

    The kernel (`cluster_scan_assemble_kernel`, `csrc/etc1s_codebook.h`)
    runs a CTA of 8 warps per cluster, a lane per column, and reads every
    member's row where it lies: one launch where the composition took a
    `torch.cat`, a sort, a gather and a segment reduction before the
    assembly. It is bound by its bytes (~29 MB at B 24,576, C 2,416, D 27).
    """
    _check(base8, "base8", torch.float32, (None, None, 3))
    d_n, c_n = base8.shape[:2]
    _check(mt, "mt", torch.float32, (None, 8 * d_n))
    b_n = mt.shape[0]
    _check(order, "order", torch.int64, (b_n,))
    _check(offsets, "offsets", torch.int64, (c_n + 1,))
    if (pixels is None) == (moments is None):
        raise ValueError("cluster_scan_assemble: give the pixels (RGB) or the "
                         "moments (perceptual), not both")
    if pixels is not None:
        if lb is not None:
            raise ValueError("cluster_scan_assemble: lb goes with the "
                             "perceptual moments")
        _check(pixels, "pixels", torch.float32, (b_n, 16, 3))
        moments = (None,) * 4
    else:
        if lb is None:
            raise ValueError("cluster_scan_assemble: the perceptual moments "
                             "need lb")
        _check(lb, "lb", torch.float32, (d_n, c_n))
        if len(moments) != 4:
            raise ValueError("cluster_scan_assemble: moments are (sum_x, "
                             "sum_x2, sum_l, sum_l2)")
        _check(moments[0], "sum_x", torch.float32, (b_n, 3))
        for name, m in zip(("sum_x2", "sum_l", "sum_l2"), moments[1:]):
            _check(m, name, torch.float32, (b_n,))
    dev = _same_device(mt, order, offsets, base8, lb, pixels, *moments)
    if dev.type == "cpu":
        return cluster_scan_assemble_reference(
            mt, order, offsets, base8, lb, pixels=pixels,
            moments=None if pixels is not None else moments)
    if b_n >= 1 << 31:
        raise ValueError(f"cluster_scan_assemble: {b_n} blocks, at most "
                         "2^31 - 1")
    if pixels is not None and pixels.data_ptr() % 16:
        pixels = pixels.clone()
    from ._build import get_lib

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty((c_n, d_n * 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_cluster_scan_assemble(
            mt.data_ptr(), order.data_ptr(), offsets.data_ptr(), ptr(pixels),
            *(ptr(m) for m in moments), base8.data_ptr(), ptr(lb),
            out.data_ptr(), c_n, d_n, _stream(dev))
    _launched("cluster_scan_assemble")
    _raise_on(status, "cluster_scan_assemble")
    return out


def cluster_scan_assemble_reference(mt, order, offsets, base8, lb=None, *,
                                    pixels=None, moments=None):
    """Plain PyTorch version of `cluster_scan_assemble`: the port's
    composition before the kernel, the block moments (`_block_moments` of
    the pixels, or the given ones) and terms summed per cluster in one
    segment sum over the given order, then `_assemble_reference`."""
    from .etc1s_encode import _block_moments, segment_sum

    if moments is None:
        mom = _block_moments(pixels)
        moments = mom["sum_x"], mom["sum_x2"], mom["sum_l"], mom["sum_l2"]
    sum_x, sum_x2, sum_l, sum_l2 = moments
    ones = torch.ones(mt.shape[0], dtype=torch.float32, device=mt.device)
    sums = segment_sum(torch.cat([
        ones[:, None], sum_x, sum_x2[:, None], sum_l[:, None], sum_l2[:, None],
        mt], 1), None, base8.shape[1], order=(order, offsets))
    return _assemble_reference(sums, base8, lb)


def _assemble_reference(sums, base8, lb=None):
    """The assembly of the cluster scan's errors from the clusters' sums
    (C, 7 + D*8): n, sum_x (3), sum_x2, sum_l, sum_l2, then the D*8 gray-axis
    sums; in `ops/xla_order.py`'s roundings."""
    from .xla_order import _dot, _fma, _sum

    d_n, c_n = base8.shape[:2]
    npix = 16.0 * sums[:, 0]                                    # (C,)
    c_sum_x = sums[:, 1:4]
    c_sum_x2, c_sum_l, c_sum_l2 = sums[:, 4], sums[:, 5], sums[:, 6]
    if lb is None:
        lb = _sum(base8, -1)                                    # (D,C)
    q = _fma(npix, _dot(base8, base8),
             c_sum_x2 - 2.0 * _dot(base8, c_sum_x[None]))
    su2 = _fma(lb, npix * lb, _fma(-(2.0 * c_sum_l), lb, c_sum_l2))
    cst = _fma(-su2, THIRD, q)                                  # (D,C)
    err = _fma(sums[:, 7:].reshape(c_n, d_n, 8), 3.0, cst.T[..., None])
    return err.reshape(c_n, d_n * 8)


# ---------------------------------------------------------------------------
# bisect_rows / bisect_round
# ---------------------------------------------------------------------------

# a member row of the bisecting init: v, w, 0
BISECT_M = 8


def bisect_rows(vecs, weights):
    """The first round of the bisecting init: the member rows (N, 8)
    float32, row i holding v_i, w_i, 0 (the one cluster of all, in row
    order), and its offsets (0, N), (2,) int32. The kernel
    (`bisect_rows_kernel`) writes a float per thread."""
    _check(vecs, "vecs", torch.float32, (None, 6))
    _check(weights, "weights", torch.float32, (vecs.shape[0],))
    if vecs.shape[0] < 1:
        raise ValueError("bisect_rows: at least one vector")
    dev = _same_device(vecs, weights)
    if dev.type == "cpu":
        return bisect_rows_reference(vecs, weights)
    from ._build import get_lib

    n = vecs.shape[0]
    members = torch.empty((n, BISECT_M), dtype=torch.float32, device=dev)
    starts = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_bisect_rows(
            vecs.data_ptr(), weights.data_ptr(), members.data_ptr(),
            starts.data_ptr(), n, _stream(dev))
    _launched("bisect_rows")
    _raise_on(status, "bisect_rows")
    return members, starts


def bisect_rows_reference(vecs, weights):
    """Plain PyTorch version of `bisect_rows`."""
    n, dev = vecs.shape[0], vecs.device
    members = torch.cat([vecs, weights[:, None], torch.zeros(
        (n, 1), dtype=torch.float32, device=dev)], 1)
    return members, torch.tensor([0, n], dtype=torch.int32, device=dev)


def bisect_round(members, starts, last: bool = False):
    """One round of the bisecting init: every cluster split in two along
    its principal axis. members (N, 8) float32 and starts (C + 1,) int32
    are the member rows and cluster offsets of `bisect_rows` or of the
    round before (cluster s holds members starts[s] .. starts[s + 1] - 1,
    in ascending row order). Returns the next round's (members, starts),
    2C clusters: cluster s's members with a projection <= 0 on its axis as
    cluster 2s, the others as 2s + 1, each in the order they had; and with
    `last` the children's (2C, 7) counts and means (count, then the 6
    means), else None.

    Replaces the reference's `round_body` (basis_universal_tpu/ops/
    etc1s_encode.py:403-420; with `last` also its leaf sums, :425-427),
    XLA code with no Pallas kernel, whose CPU rounding decides every split;
    the plain version (`bisect_round_reference`) is the port's composition
    of it, and the kernel (`bisect_round_kernel`) computes the same moment
    columns, sums, power iterations and projections in the same order per
    value, and the partition that the plain version's stable sort makes:
    one launch where the composition runs ~25 operators, and no segment
    reduction (each cluster's members are contiguous, so its first warp
    sums each moment column in row order as one chain of adds, fed by
    producer warps through shared memory)."""
    _check(members, "members", torch.float32, (None, BISECT_M))
    _check(starts, "starts", torch.int32, (None,))
    n_c = starts.shape[0] - 1
    if n_c < 1:
        raise ValueError("bisect_round: starts holds at least one cluster")
    dev = _same_device(members, starts)
    if dev.type == "cpu":
        return bisect_round_reference(members, starts, last)
    from ._build import get_lib

    # the kernel reads the member rows as 16-byte pieces
    if members.data_ptr() % 16:
        members = members.clone()
    out = torch.empty_like(members)
    starts_out = torch.empty(2 * n_c + 1, dtype=torch.int32, device=dev)
    leaves = (torch.empty((2 * n_c, 7), dtype=torch.float32, device=dev)
              if last else None)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_bisect_round(
            members.data_ptr(), out.data_ptr(), starts.data_ptr(),
            starts_out.data_ptr(),
            None if leaves is None else leaves.data_ptr(), n_c, _stream(dev))
    _launched("bisect_round")
    _raise_on(status, "bisect_round")
    return out, starts_out, leaves


def bisect_moments(members):
    """The reference's 43 moment columns of each member row, (N, 43): w,
    v w and the 36 (v_f v_g) w in row-major order (`bisecting_init`'s
    `feats`, basis_universal_tpu/ops/etc1s_encode.py:394-395: the product
    of two coordinates, then by the weight)."""
    v, w = members[:, :6], members[:, 6:7]
    outer = (v[:, :, None] * v[:, None, :]).reshape(-1, 36)
    return torch.cat([w, v * w, outer * w], 1)


def bisect_round_reference(members, starts, last: bool = False):
    """Plain PyTorch version of `bisect_round`: the port's composition of
    the reference's round, on the member rows: one segment sum of the 43
    moment columns (`bisect_moments`; each cluster's members in ascending
    row order, so every column sums in row order), the mean, the
    covariance fma(-(cnt mean_f), mean_g, M2) (`xla_order._fma`), the power
    iteration (`bisect_power_axis`), the threshold `_sum(mean * axis)` and
    the projections `_dot(v, axis) - thr`; then a stable sort by child. The
    leaves: a segment sum of w and v w, the means divided by max(count,
    1e-9)."""
    from .etc1s_encode import segment_sum
    from .xla_order import _dot, _fma, _sum

    dev, n, n_c = members.device, members.shape[0], starts.shape[0] - 1
    ids = torch.repeat_interleave(
        torch.arange(n_c, device=dev), (starts[1:] - starts[:-1]).long(),
        output_size=n)
    m = segment_sum(bisect_moments(members), ids, n_c)
    cnt = m[:, 0]
    mean = m[:, 1:7] / torch.clamp(cnt, min=1e-9)[:, None]
    cov = _fma(-(cnt[:, None, None] * mean[:, :, None]), mean[:, None, :],
               m[:, 7:].reshape(n_c, 6, 6))
    axis = bisect_power_axis(cov)
    thr = _sum(mean * axis, -1)
    proj = _dot(members[:, :6], axis[ids]) - thr[ids]
    child = ids * 2 + (proj > 0).to(torch.int64)
    order = torch.sort(child, stable=True).indices
    child = child[order]
    starts_out = torch.searchsorted(child, torch.arange(
        2 * n_c + 1, device=dev)).to(torch.int32)
    out = members[order]
    leaves = None
    if last:
        lm = segment_sum(bisect_moments(out)[:, :7], child, 2 * n_c)
        leaves = torch.cat([lm[:, :1], lm[:, 1:] / torch.clamp(
            lm[:, :1], min=1e-9)], 1)
    return out, starts_out, leaves


def bisect_power_axis(cov):
    """Each cluster's principal axis, (C, 6), from its (C, 6, 6) covariance:
    four power iterations from (1, ..., 1), v <- cov v, then v / (|v| +
    1e-9), rounded as the reference's compiled bisecting init rounds them:
    the products of w = cov v as a fused multiply-add chain
    (`xla_order._dot`), the squares rounded and summed in index order
    (`_sum`), a correctly rounded square root."""
    from .xla_order import _dot, _sqrt, _sum

    axis = torch.ones(cov.shape[:2], dtype=cov.dtype, device=cov.device)
    for _ in range(4):
        axis = _dot(cov, axis[:, None, :])                      # cfg,cg->cf
        axis = axis / (_sqrt(_sum(axis * axis, -1))[:, None] + 1e-9)
    return axis


# ---------------------------------------------------------------------------
# xla_cpu_min_k
# ---------------------------------------------------------------------------

# rows up to this long are sorted in shared memory (`kMinKSmemN`); longer
# ones in scratch the wrapper allocates
_MIN_K_SMEM_N = 8192


def xla_cpu_min_k(d, k: int, depth_cap: int = -1, *, stage: int = 2):
    """The columns of the k smallest values of each row of d (R, n) float32,
    (R, k) int64, in the order the reference's `jax.lax.approx_min_k` gives
    them on the CPU: the first k of libstdc++'s `std::sort` of the row's
    (value, column) pairs by value alone, so equal values (-0.0 and +0.0
    too) come out in its introsort's order, which depends on the whole row.

    Replaces XLA's ApproxTopK in the reference's `refine_endpoint_assignment`
    (`basis_universal_tpu/ops/etc1s_encode.py:457`), which has no Pallas
    kernel. The kernel (`min_k_kernel`) runs `csrc/xla_cpu_sort.h`'s
    introsort, pruned to the first k places, one warp a row in shared
    memory, each Hoare partition across the warp's lanes as its swap pairs
    and the final insertion sort as stable ranks; the plain version runs
    the same source sequentially on the host. k >= 2 where n > 1: at k = 1
    `approx_min_k` is another operator. `depth_cap` >= 0 replaces the
    introsort's depth limit (2 lg n), to reach its heap fallback in tests.
    For measurement on the card, `stage` 0 stops the kernel after loading
    the rows and 1 after the partitions (the columns are then not the
    sort's).
    """
    _check(d, "d", torch.float32, (None, None))
    dev = _same_device(d)
    n = d.shape[1]
    if not 1 <= k <= n or (k == 1 and n > 1):
        raise ValueError(f"xla_cpu_min_k: k {k} for rows of {n}")
    if not -1 <= depth_cap <= 62:
        raise ValueError(f"xla_cpu_min_k: depth_cap {depth_cap}")
    if dev.type == "cpu":
        if stage != 2:
            raise ValueError("xla_cpu_min_k: stages are the kernel's")
        return xla_cpu_min_k_reference(d, k, depth_cap=depth_cap)
    from ._build import get_lib

    lib = get_lib()
    out = torch.empty((d.shape[0], k), dtype=torch.int64, device=dev)
    scratch = None
    if n > _MIN_K_SMEM_N:
        scratch = torch.empty((d.shape[0], lib.etc1s_min_k_scratch_bytes(n)),
                              dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        status = lib.etc1s_xla_cpu_min_k(
            d.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), d.shape[0], n, k, depth_cap, stage, _stream(dev))
    _launched("xla_cpu_min_k")
    _raise_on(status, "xla_cpu_min_k")
    return out


# the host library's ways through a row (`csrc/host_sort.cpp`)
_HOST_SORT_MODES = {"pruned": 0, "std_sort": 1, "heap": 2,
                    "std_partial_sort": 3, "pairs": 4, "final_insertion": 5}


def xla_cpu_min_k_reference(d, k: int, mode: str = "pruned",
                            depth_cap: int = -1, visits=None):
    """Plain version of `xla_cpu_min_k`, on the host, for a CPU tensor d:
    the same introsort (`csrc/xla_cpu_sort.h`) over the rows, split over
    the cores (`depth_cap` as there). `mode` "std_sort" takes the first k
    of libstdc++'s `std::sort` itself; "pairs" runs the card's algorithm
    sequentially (each partition as its swap pairs, the final step as
    stable ranks); "heap", "std_partial_sort" and "final_insertion" the
    first k of the introsort's heap fallback, of libstdc++'s
    `std::partial_sort` and of the final insertion sort over the whole row
    (whose least value must lie in its first 16 places), for tests.
    `visits`, an (R,) int64 CPU tensor, receives in mode "pruned" the
    number of entries each row's partitions visited."""
    from .. import native

    d = d.to(torch.float32).contiguous()
    if visits is not None:
        _check(visits, "visits", torch.int64, (d.shape[0],))
        if visits.device.type != "cpu" or mode != "pruned":
            raise ValueError("xla_cpu_min_k: visits is a CPU tensor, counted "
                             "in mode 'pruned'")
    out = torch.empty((d.shape[0], k), dtype=torch.int64)
    status = native.get_host_sort().xla_cpu_min_k_rows(
        d.data_ptr(), d.shape[0], d.shape[1], k, out.data_ptr(),
        _HOST_SORT_MODES[mode], depth_cap,
        None if visits is None else visits.data_ptr())
    if status == -2:
        raise ValueError("xla_cpu_min_k: final_insertion needs each row's "
                         "least value in its first 16 places")
    if status != 0:
        raise ValueError(f"xla_cpu_min_k: bad sizes {tuple(d.shape)}, k {k}")
    return out


# ---------------------------------------------------------------------------
# find_best_selector_patterns
# ---------------------------------------------------------------------------

def find_best_selector_patterns(dists, patterns, num_patterns: int):
    """Per block, the selector pattern of least error: (best (B,) int32,
    min_err (B,) float32), with err[b, s] = sum_i bf16(d[b, i, pat_s[i]])
    accumulated in float32; ties go to the lowest pattern index.

    Replaces `pallas_etc1s.find_best_selector_patterns` (`_selbest_kernel`).
    dists: (B, 16, 4) float32; patterns: (S, 16) integer, S = num_patterns.

    The error matrix is a one-hot product, D_bf16 (B, 64) . Onehot (S, 64)^T,
    as on the TPU's matrix unit; the kernel (`selbest_wgmma_kernel`) runs
    it on Hopper's warpgroup tensor-core instruction (wgmma m64n128k16, bf16
    in, fp32 accumulate, the four 16-deep k-steps chained in pixel order)
    fused with a running argmin, so the (B, S) matrix (~270 MB at 24,576
    blocks x 2,731 patterns) is never materialised. Its bound there is the
    8.6 GFLOP of bf16 products (~9 us). A CTA takes 192 rows: three
    warpgroups keep their 64 rows' bf16 distances in registers as the A
    operand, and a fourth builds the one-hot of 128 patterns at a time in
    shared memory (wgmma's K-major layout, 128-byte swizzle) straight from
    the int32 patterns, into a ring of 4 tiles, so nothing is prepared
    before the launch. The tensor core may round the fp32 sum of the 16
    exact products of a k-step differently from a sequential sum, by ulps,
    so an index may differ from the plain version where two patterns'
    errors are that close.
    """
    _check(dists, "dists", torch.float32, (None, 16, 4))
    if patterns.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"patterns: expected int32/int64, got {patterns.dtype}")
    if tuple(patterns.shape) != (num_patterns, 16):
        raise ValueError(f"patterns: expected shape ({num_patterns}, 16), "
                         f"got {tuple(patterns.shape)}")
    dev = _same_device(dists, patterns)
    if dev.type == "cpu":
        return find_best_selector_patterns_reference(dists, patterns,
                                                     num_patterns)
    from ._build import get_lib

    # the kernel reads float2 distance pairs and 16-byte pattern quarters
    if dists.data_ptr() % 8:
        dists = dists.clone()
    if (patterns.dtype != torch.int32 or not patterns.is_contiguous()
            or patterns.data_ptr() % 16):
        patterns = patterns.to(torch.int32).contiguous().clone()
    b_n = dists.shape[0]
    best = torch.empty(b_n, dtype=torch.int32, device=dev)
    val = torch.empty(b_n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_find_best_selector_patterns(
            dists.data_ptr(), patterns.data_ptr(), best.data_ptr(),
            val.data_ptr(), b_n, num_patterns, _stream(dev))
    _launched("find_best_selector_patterns")
    _raise_on(status, "find_best_selector_patterns")
    return best, val


def find_best_selector_patterns_reference(dists, patterns, num_patterns: int):
    """Plain PyTorch version: the (B, 64) @ one-hot (64, S) product of the
    reference's XLA formulation, bf16-rounded operands, float32 product
    (exact only without TF32, see `etc1s_encode.exact_matmuls`)."""
    b_n = dists.shape[0]
    d = dists.reshape(b_n, 64).to(torch.bfloat16).float()
    one = torch.nn.functional.one_hot(patterns.long(), 4).reshape(
        num_patterns, 64).float()
    err = d @ one.T                                              # (B,S)
    val, best = err.min(dim=-1)
    return best.to(torch.int32), val
