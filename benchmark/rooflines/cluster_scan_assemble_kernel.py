"""`cluster_scan_assemble_kernel` (`cluster_scan_assemble`,
csrc/etc1s_codebook.h), counted as `chip_smoke._assemble_bound` counts it
without the perceptual metric: bytes, the terms (B, 8D), the order (B,)
and offsets (C + 1,) int64, the pixels (B, 16, 3) and the bases (D, C, 3)
in, the (C, 8D) errors out; operations, per member an add per column (7 +
8D) and its moments (16 x 14), per (cluster, delta) 17 and per output a
fused multiply-add."""

from ._peaks import bound_s

KERNEL = "cluster_scan_assemble_kernel"


def assemble(b_n: int, c_n: int, d_n: int) -> float:
    n_bytes = (4 * b_n * 8 * d_n + 8 * b_n + 8 * (c_n + 1)
               + 12 * d_n * c_n + 4 * c_n * 8 * d_n + 192 * b_n)
    ops = b_n * (7 + 8 * d_n) + 16 * 14 * b_n + c_n * d_n * (17 + 8)
    return bound_s(n_bytes, float(ops))


def launches(tex: dict) -> list:
    """Effort 1: the one refine pass's cluster scan, radius 1 (D 27)."""
    if tex["codec"] != "etc1s":
        return []
    return [assemble(tex["blocks"], tex["endpoint_clusters"], 27)]
