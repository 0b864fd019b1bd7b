"""`bisect_rows_kernel` (`bisect_rows`, csrc/etc1s_kernels.cu), counted as
`chip_smoke.bisect_phase` counts it: the (N, 6) vectors and weights in and
the member rows (N, 8) out, 28 + 4 x 8 bytes a row."""

from ._peaks import bound_s

KERNEL = "bisect_rows_kernel"
BISECT_M = 8


def launches(tex: dict) -> list:
    if tex["codec"] != "etc1s":
        return []
    return [bound_s(tex["blocks"] * (28 + 4 * BISECT_M), 0.0)]
