"""`cross6_kernel` (`cross6_distances`, csrc/etc1s_codebook.h), counted as
`chip_smoke._cross6_bound` counts it: per (row, centroid) pair 9
instructions and one more where C mod 64 is 1..32, per row and centroid
its squared norm (11); bytes: (N, 6) and (C, 6) in, the (N, C) float32
distances out."""

from ._peaks import bound_s
from .cross6_argmin_kernel import pair_ops

KERNEL = "cross6_kernel"


def distances(n: int, c: int) -> float:
    return bound_s(n * 24 + c * 24 + n * c * 4,
                   float(n * c * pair_ops(c) + 11 * (c + n)))


def launches(tex: dict) -> list:
    """Effort 1: the one refine pass's distances."""
    if tex["codec"] != "etc1s":
        return []
    return [distances(tex["blocks"], tex["endpoint_clusters"])]
