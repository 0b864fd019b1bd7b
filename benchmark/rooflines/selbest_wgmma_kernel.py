"""`selbest_wgmma_kernel` (`find_best_selector_patterns`,
csrc/etc1s_kernels.cu), counted as `chip_smoke._selector_bound` counts it:
the one-hot product, 2 x B x S x 64 bf16 tensor-core FLOPs; bytes: the (B,
64) float32 distances and the (S, 16) int32 patterns in, an index and an
error a block out."""

from ._peaks import BF16_TC_FLOP_S, bound_s

KERNEL = "selbest_wgmma_kernel"


def selector(b_n: int, s: int) -> float:
    return bound_s(b_n * 64 * 4 + s * 16 * 4 + b_n * 8,
                   2.0 * b_n * s * 64, BF16_TC_FLOP_S)


def launches(tex: dict) -> list:
    """Effort 1: two selector iterations and the final assignment."""
    if tex["codec"] != "etc1s":
        return []
    return [selector(tex["blocks"], tex["selector_clusters"])] * 3
