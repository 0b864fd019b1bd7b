"""`cross6_argmin_kernel` (`cross6_argmin`, csrc/etc1s_codebook.h), counted
as `chip_smoke._cross6_bound` counts it: per (row, centroid) pair 9
instructions, and one more where C mod 64 is 1..32; per centroid its
squared norm (11), and from 1,024 centroids each vector's 6 coordinates
rounded to bf16 and back (12); bytes: the (N, 6) rows and (C, 6)
centroids in, the (N,) int64 indices out."""

from ._peaks import bound_s

KERNEL = "cross6_argmin_kernel"


def pair_ops(c: int) -> int:
    return 9 + (1 <= c % 64 <= 32)


def argmin(n: int, c: int) -> float:
    rounds = 0 if c < 1024 else 12 * (n + c)
    return bound_s(n * 24 + c * 24 + n * 8,
                   float(n * c * pair_ops(c) + 11 * c + rounds))


def launches(tex: dict) -> list:
    """Effort 1 on a codebook of at most a quarter of the blocks: two
    k-means assignments."""
    if tex["codec"] != "etc1s":
        return []
    return [argmin(tex["blocks"], tex["endpoint_clusters"])] * 2
