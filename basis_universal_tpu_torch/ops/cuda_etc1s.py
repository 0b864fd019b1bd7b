"""CUDA kernels of the ETC1S encoder, with their plain versions.

Counterpart of `basis_universal_tpu/ops/pallas_etc1s.py`, all four of its
kernels: the ETC1S frontend's scan, packed rescore and selector search (the
UASTC encoder's ETC1 hint and the transcoder's ETC1 re-encode run the scan
and the packed rescore too), and `palette_errs`, which no path of either
package calls. Each wrapper checks its inputs, then dispatches on the
device of the tensors it was given:

- a CUDA tensor launches the hand-written kernel of `csrc/etc1s_kernels.cu`
  on the current stream (and raises if the launch is refused);
- a CPU tensor runs the plain PyTorch version kept beside it (`*_reference`).

The plain version never runs for a CUDA tensor. `LAUNCHES` counts the kernel
launches of each wrapper; `reset_launch_counts()` zeroes it.
"""

import numpy as np
import torch

from basis_universal_tpu.ops.etc1 import ETC1_INTEN_TABLES

LAUNCHES = {
    "factorized_scan": 0,
    "palette_errs_packed": 0,
    "palette_errs": 0,
    "find_best_selector_patterns": 0,
}

# float32 constants of the kernels, as Python floats holding the exact f32
# value (so `tensor * const` rounds the same way on every device)
THIRD = float(np.float32(1.0 / 3.0))
C31_255 = float(np.float32(31.0 / 255.0))
_INTEN_MID = (ETC1_INTEN_TABLES[:, :-1] + ETC1_INTEN_TABLES[:, 1:]) / 2.0


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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

def factorized_scan(pixels, base5=None, radius: int = 1,
                    perceptual: bool = False):
    """Unclipped factorized ETC1S candidate errors, (B, D*8) float32.

    Replaces `pallas_etc1s.factorized_scan` (`_fscan_kernel`). Column
    d*8 + t is the error of candidate delta d (`_candidate_deltas(radius)`)
    with intensity table t: err = q - su2/3 + 3 * sum_i min_k (t_k - u_i)^2.
    The base colour is the block mean rounded to 5 bits, or `base5` (B, 3)
    float32 when given (the cluster base of `optimize_cluster_endpoints`).

    On the H100 the scan is bound by its output: 216 float32 (radius 1) or
    1,000 (radius 2) are written per 192 bytes read, a few hundred FLOPs per
    output. The kernel runs one thread per (block, delta) so the grid has
    B*D threads, reads the delta, tables and midpoints from constant memory
    (one address per warp), and writes a (D*8, B) buffer so a warp's stores
    are 32 neighbouring floats; the result is returned as its transposed
    (B, D*8) view, without a copy.
    """
    n_d = _n_deltas(radius)
    _check(pixels, "pixels", torch.float32, (None, 16, 3))
    if base5 is not None:
        _check(base5, "base5", torch.float32, (pixels.shape[0], 3))
    dev = _same_device(pixels, base5)
    if dev.type == "cpu":
        return factorized_scan_reference(pixels, base5, radius, perceptual)
    from ._build import get_lib

    b_n = pixels.shape[0]
    out = torch.empty((n_d * 8, b_n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_factorized_scan(
            pixels.data_ptr(), None if base5 is None else base5.data_ptr(),
            out.data_ptr(), b_n, radius, int(bool(perceptual)), _stream(dev))
    LAUNCHES["factorized_scan"] += 1
    _raise_on(status, "factorized_scan")
    return out.t()


def factorized_scan_reference(pixels, base5=None, radius: int = 1,
                              perceptual: bool = False):
    """Plain PyTorch version of `factorized_scan` (the reference's XLA
    formulation, `etc1s_encode._scan_block_errs`, with the kernel's base)."""
    from .etc1s_encode import (PERC_P, _block_moments, _candidate_deltas,
                               _gray_axis_minterm, perceptual_transform)

    dev = pixels.device
    px = pixels.float()
    b_n = px.shape[0]
    deltas = torch.as_tensor(_candidate_deltas(radius), device=dev)
    if base5 is None:
        b5 = torch.clamp(torch.round(px.sum(1) / 16.0 * C31_255), 0.0, 31.0)
    else:
        b5 = base5.float()
    c5 = torch.clamp(b5[None] + deltas[:, None, :].float(), 0.0, 31.0)
    base8 = c5 * 8.0 + torch.floor(c5 * 0.25)                    # (D,B,3)
    if perceptual:
        gvec = torch.as_tensor(PERC_P @ np.ones(3, np.float32), device=dev)
        px = perceptual_transform(px)
        base8 = perceptual_transform(base8)
        lb = base8 @ gvec                                        # (D,B)
    else:
        gvec = None
        lb = base8.sum(-1)
    mom = _block_moments(px, gvec)
    q = (mom["sum_x2"][None]
         - 2.0 * torch.einsum("dbc,bc->db", base8, mom["sum_x"])
         + 16.0 * (base8 * base8).sum(-1))
    su2 = mom["sum_l2"][None] - 2.0 * lb * mom["sum_l"][None] + 16.0 * lb * lb
    u = (mom["luma"][None] - lb[..., None]) * THIRD              # (D,B,16)
    err = (q - su2 * THIRD)[..., None] + 3.0 * _gray_axis_minterm(u)
    return err.permute(1, 0, 2).reshape(b_n, -1)


# ---------------------------------------------------------------------------
# palette_errs_packed
# ---------------------------------------------------------------------------

def palette_errs_packed(pixels, packed, perceptual: bool = False):
    """Exact gamut-clipped ETC1S errors from packed candidates, (B, K) f32.

    Replaces `pallas_etc1s.palette_errs_packed` (`_rescore_kernel`).
    packed: (B, K) int32, r5 | g5<<5 | b5<<10 | inten<<15. err[b, k] =
    sum_i min_sel ||x_bi - clip(expand5(c5) + t_sel)||^2, the distance taken
    through PERC_P when `perceptual`.

    On the H100 this is a small compute-bound pass (4 palette entries x 16
    pixels x ~10 FLOPs per output, 64 bytes in per output): one thread per
    (block, candidate) rebuilds its palette in registers from the packed
    word, so no (B, K, 4, 3) palette ever reaches device memory; the
    perceptual variant is a template flag with the matrix baked in.
    """
    _check(pixels, "pixels", torch.float32, (None, 16, 3))
    _check(packed, "packed", torch.int32, (pixels.shape[0], None))
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
    LAUNCHES["palette_errs_packed"] += 1
    _raise_on(status, "palette_errs_packed")
    return out


def palette_errs_packed_reference(pixels, packed, perceptual: bool = False):
    """Plain PyTorch version of `palette_errs_packed`."""
    from .etc1s_encode import PERC_P

    dev = pixels.device
    v = packed.to(torch.int32)
    c5 = torch.stack([v & 31, (v >> 5) & 31, (v >> 10) & 31], -1).float()
    tabs = torch.as_tensor(ETC1_INTEN_TABLES, dtype=torch.float32, device=dev)
    tsel = tabs[((v >> 15) & 7).long()]                          # (B,K,4)
    b8 = c5 * 8.0 + torch.floor(c5 * 0.25)                       # (B,K,3)
    pal = torch.clamp(b8[:, :, None, :] + tsel[..., None], 0.0, 255.0)
    diff = pixels.float()[:, None, None, :, :] - pal[:, :, :, None, :]
    if perceptual:
        diff = diff @ torch.as_tensor(PERC_P, device=dev).T
    dist = (diff * diff).sum(-1)                                 # (B,K,4,16)
    return dist.min(dim=2).values.sum(-1)


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
    LAUNCHES["palette_errs"] += 1
    _raise_on(status, "palette_errs")
    return out


def palette_errs_reference(pixels, palettes):
    """Plain PyTorch version of `palette_errs`: the reference's XLA broadcast
    (`etc1s_encode._palette_errs`)."""
    diff = palettes[:, :, :, None, :] - pixels[:, None, None, :, :]
    d = (diff * diff).sum(-1)                                    # (B,K,4,16)
    return d.min(dim=2).values.sum(-1)


# ---------------------------------------------------------------------------
# find_best_selector_patterns
# ---------------------------------------------------------------------------

def pack_patterns(patterns):
    """(S, 16) selector patterns -> (S,) int32 words of 16 x 2 bits
    (pixel i in bits 2i..2i+1), the layout the selector kernel reads."""
    shifts = torch.arange(16, device=patterns.device, dtype=torch.int64) * 2
    words = ((patterns.to(torch.int64) & 3) << shifts).sum(1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def find_best_selector_patterns(dists, patterns, num_patterns: int):
    """Per block, the selector pattern of least error: (best (B,) int32,
    min_err (B,) float32), with err[b, s] = sum_i bf16(d[b, i, pat_s[i]])
    accumulated in float32; ties go to the lowest pattern index.

    Replaces `pallas_etc1s.find_best_selector_patterns` (`_selbest_kernel`).
    dists: (B, 16, 4) float32; patterns: (S, 16) integer, S = num_patterns.

    On the H100 the work is B*S*16 selects and adds (1.1 G at 24,576 blocks
    x 2,731 patterns) against 256 bytes read per block, so it is bound by
    instruction issue, not memory. The kernel never materialises the
    (B, S) matrix (~270 MB here): each thread keeps one block's 64
    distances in registers, selected with compares rather than a runtime
    index (which would spill them to local memory), while the patterns,
    packed to one uint32 each, stream through shared memory; eight threads
    split each block's pattern range to fill the card, and their running
    minima merge lowest index first.
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

    b_n = dists.shape[0]
    words = pack_patterns(patterns).contiguous()
    best = torch.empty(b_n, dtype=torch.int32, device=dev)
    val = torch.empty(b_n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = get_lib().etc1s_find_best_selector_patterns(
            dists.data_ptr(), words.data_ptr(), best.data_ptr(),
            val.data_ptr(), b_n, num_patterns, _stream(dev))
    LAUNCHES["find_best_selector_patterns"] += 1
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
