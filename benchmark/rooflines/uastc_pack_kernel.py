"""`uastc_pack_kernel` (`pack.uastc_pack`, csrc/uastc_pack_kernels.cu):
bytes only, the (B, 59) winner buffer and the (B,) int32 alpha in, the (B,
16) blocks out (`chip_smoke` counts the tables too, a few hundred bytes,
and instructions that depend on which slots win, which the shapes alone do
not give: this bound reads low, never high)."""

from ._peaks import bound_s

KERNEL = "uastc_pack_kernel"


def launches(tex: dict) -> list:
    if tex["codec"] != "uastc":
        return []
    return [bound_s(tex["blocks"] * (59 + 4 + 16), 0.0)]
