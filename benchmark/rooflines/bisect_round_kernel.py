"""`bisect_round_kernel` (`bisect_round`, csrc/etc1s_kernels.cu), counted as
`chip_smoke.bisect_phase` counts it: per round each member row read and
written once (32 bytes each way) and the cluster offsets (12 bytes a
cluster and one more); per member 84 operations (its moment columns, their
adds and the projection), per cluster 400 (the power iterations), and once
7 a member for the leaves."""

import math

from ._peaks import bound_s
from .bisect_rows_kernel import BISECT_M

KERNEL = "bisect_round_kernel"


def launches(tex: dict) -> list:
    """ceil(log2 C) rounds, round r splitting 2^r clusters; the last also
    sums the leaves."""
    if tex["codec"] != "etc1s":
        return []
    n = tex["blocks"]
    rounds = max(1, math.ceil(math.log2(tex["endpoint_clusters"])))
    out = []
    for r in range(rounds):
        clusters = 1 << r
        ops = n * 84.0 + 400.0 * clusters + (7.0 * n if r == rounds - 1
                                              else 0.0)
        out.append(bound_s(n * 4 * 2 * BISECT_M + 12 * (clusters + 1), ops))
    return out
