"""`rescore_kernel` (`palette_errs_packed`, csrc/etc1s_kernels.cu), counted
as `chip_smoke._rescore_bound` counts it: per output, 16 pixels x 4
selectors x 6 instructions plus 16 x 4 (3 minimums, an add); bytes: the
pixels, the packed candidates (4 bytes each) and the errors."""

from ._peaks import bound_s

KERNEL = "rescore_kernel"


def rescore(b_n: int, k: int) -> float:
    return bound_s(b_n * 48 * 4 + b_n * k * (4 + 4),
                   b_n * k * (16 * (4 * 6 + 4)))


def launches(tex: dict) -> list:
    """ETC1S at effort 1: K 16 in the per-block encode, the cluster
    endpoints' rescore and the refine's; UASTC: the ETC1 hint's K 8."""
    b = tex["blocks"]
    if tex["codec"] == "etc1s":
        return [rescore(b, 16)] * 3
    return [rescore(b, 8)]
