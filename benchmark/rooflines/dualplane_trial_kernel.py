"""`dualplane_trial_kernel` (`uastc_dualplane_trial`,
csrc/xla_order_kernels.cu), one launch a dual-plane mode: bytes, the pixels
in and the error, codes, 32 weights and ccs out (4 x (64 + 1 + 2N + 32 +
(N != 2)) a block); instructions `_uastc_ops.dualplane_trial_ops`, as
`chip_smoke` counts them."""

from . import _uastc_ops as U
from ._peaks import bound_s

KERNEL = "dualplane_trial_kernel"


def trial(b_n, wb, n_ch, ls_iters=U.LS_ITERS) -> float:
    return bound_s(b_n * 4 * (64 + 1 + 2 * n_ch + 32 + (n_ch != 2)),
                   float(b_n * U.dualplane_trial_ops(n_ch, 1 << wb,
                                                     ls_iters)))


def launches(tex: dict) -> list:
    if tex["codec"] != "uastc":
        return []
    modes = U.DUAL_RGB + (U.DUAL_RGBA if tex["alpha"] else ())
    return [trial(tex["blocks"], wb, n_ch) for wb, _ep, n_ch in modes]
