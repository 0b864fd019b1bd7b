"""`subset_trial_kernel` (`uastc_subset_trial`, csrc/xla_order_kernels.cu),
one launch a 2- or 3-subset mode: bytes, the pixels in and the error, the
codes, weights and pattern out (4 x (64 + 1 + 2 S C + 16 + 1) a block);
instructions `_uastc_ops.subset_trial_ops`, as `chip_smoke` counts them."""

from . import _uastc_ops as U
from ._peaks import bound_s

KERNEL = "subset_trial_kernel"


def trial(b_n, wb, comps, n_sub, n_pat, topk, ls_iters=U.LS_ITERS) -> float:
    return bound_s(b_n * 4 * (64 + 1 + 2 * n_sub * comps + 16 + 1),
                   float(b_n * U.subset_trial_ops(comps, n_sub, 1 << wb,
                                                  ls_iters, topk, n_pat)))


def launches(tex: dict) -> list:
    if tex["codec"] != "uastc":
        return []
    modes = U.SUBSET_RGB + (U.SUBSET_RGBA if tex["alpha"] else ())
    return [trial(tex["blocks"], wb, comps, n_sub, n_pat, topk)
            for wb, _ep, comps, n_sub, n_pat, topk in modes]
