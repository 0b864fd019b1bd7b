"""`fscan_kernel` (`factorized_scan` / `factorized_scan_shortlist`,
csrc/etc1s_kernels.cu), counted as `chip_smoke._scan_bound` counts it: per
output column, 16 pixels x 4 instructions (a compare, a select, a subtract
and a multiply-add); bytes: the pixels (and the cluster bases) in, the
(B, D*8) float32 sums out, or the (B, k) int64 shortlist."""

from ._peaks import bound_s

KERNEL = "fscan_kernel"


def scan(b_n: int, n_cols: int, external_base: bool, k=None) -> float:
    n_bytes = b_n * 48 * 4 + (b_n * 12 if external_base else 0) \
        + (b_n * n_cols * 4 if k is None else b_n * k * 8)
    return bound_s(n_bytes, b_n * n_cols * 16 * 4)


def launches(tex: dict) -> list:
    """ETC1S at effort 1 (radius 1, D 27): the per-block encode's fused
    shortlist (k 16) and the refine pass's scan against the cluster bases;
    UASTC: the ETC1 hint's radius-0 shortlist (D 1, k 8)."""
    b = tex["blocks"]
    if tex["codec"] == "etc1s":
        return [scan(b, 216, False, 16), scan(b, 216, True)]
    return [scan(b, 8, False, 8)]
