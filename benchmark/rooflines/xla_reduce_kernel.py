"""`xla_reduce_kernel32` / `64` (`xla_order._dot` on the card,
csrc/xla_order_kernels.cu): on the ETC1S path, the selector distances'
ordered sums, `block_selector_distances`: (B, 16, 4, 3) differences in,
(B, 16, 4) float32 out, one fused multiply-add a term. Both operands are
the same tensor, so its bytes are read once here (`chip_smoke` counts
them twice)."""

from ._peaks import bound_s

KERNEL = r"xla_reduce_kernel(32|64)"


def launches(tex: dict) -> list:
    if tex["codec"] != "etc1s":
        return []
    b = tex["blocks"]
    return [bound_s(4 * (b * 192 + b * 64), float(b * 192))]
