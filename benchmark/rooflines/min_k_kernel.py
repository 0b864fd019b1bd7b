"""`min_k_kernel` (`xla_cpu_min_k`, csrc/etc1s_kernels.cu): the refine's
shortlist, bytes only, as `chip_smoke` counts them: the (B, C) float32
distances in, the (B, k) int64 columns out. Its operations depend on the
data (the entries the partitions visit), so a bound from the shapes alone
leaves them out and reads low, never high."""

from ._peaks import bound_s

KERNEL = "min_k_kernel"


def launches(tex: dict) -> list:
    """Effort 1: one refine pass, k 16."""
    if tex["codec"] != "etc1s":
        return []
    b = tex["blocks"]
    return [bound_s(b * tex["endpoint_clusters"] * 4 + b * 16 * 8, 0.0)]
