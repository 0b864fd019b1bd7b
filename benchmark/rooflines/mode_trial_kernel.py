"""`mode_trial_kernel` (`uastc_mode_trial`, csrc/xla_order_kernels.cu), one
launch a single-subset mode: bytes, the (B, 16, 4) float32 pixels in and
the error, the codes and the 16 weights out (4 x (64 + 1 + 2C + 16) a
block); instructions `_uastc_ops.mode_trial_ops`, as `chip_smoke` counts
them."""

from . import _uastc_ops as U
from ._peaks import bound_s

KERNEL = "mode_trial_kernel"


def trial(b_n: int, wb: int, comps: int, ls_iters: int = U.LS_ITERS) -> float:
    return bound_s(4 * b_n * (64 + 1 + 2 * comps + 16),
                   float(b_n * U.mode_trial_ops(comps, 1 << wb, ls_iters)))


def launches(tex: dict) -> list:
    if tex["codec"] != "uastc":
        return []
    modes = U.RGB_MODES + (U.RGBA_MODES if tex["alpha"] else ())
    return [trial(tex["blocks"], wb, comps) for _m, wb, _ep, comps in modes]
