"""Holds each frozen bound of `rooflines/` to the function of `chip_smoke.py`
it was copied from, at `chip_smoke`'s phase-3 shapes (ETC1S image 0 at
768x512: 24,576 blocks, 2,416 endpoint clusters; the selector at 2,731 and
16,128 patterns; every UASTC trial of the effort-2 searches).

    python3 benchmark/crosscheck_bounds.py

`chip_smoke` rates operations at the SM clock it reads in its run; the
frozen bounds at the card's top clock, 1.98 GHz. With chip_smoke's rate set
to the frozen one the two must agree; with the clock this card reports
(`nvidia-smi`, where there is one), an operation-bound kernel's bound
scales by the clocks' ratio. Where the frozen bound counts otherwise on
purpose, the line says so and what is expected. Exits 1 on a disagreement.
"""

import math
import pathlib
import subprocess
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

import chip_smoke as cs  # noqa: E402

from benchmark.rooflines import (  # noqa: E402
    _peaks, _uastc_ops as U, bisect_round_kernel, bisect_rows_kernel,
    cluster_scan_assemble_kernel, cross6_argmin_kernel, cross6_kernel,
    dualplane_trial_kernel, fscan_kernel, min_k_kernel, mode_trial_kernel,
    rescore_kernel, selbest_wgmma_kernel, subset_trial_kernel,
    uastc_pack_kernel, xla_reduce_kernel)

B, C = 24576, 2416


def sm_clock_mhz():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def cases():
    """(label, frozen seconds, chip_smoke (ms, what), relation: "==",
    ">=" or "<=", why where not ==)."""
    tex_e = dict(codec="etc1s", blocks=B, alpha=False, endpoint_clusters=C,
                 selector_clusters=2731)
    yield ("fscan D27 k16", fscan_kernel.scan(B, 216, False, 16),
           cs._scan_bound(B, 216, False, 16), "==", "")
    yield ("fscan D27 cluster base", fscan_kernel.scan(B, 216, True),
           cs._scan_bound(B, 216, True), "==", "")
    yield ("fscan D1 k8", fscan_kernel.scan(B, 8, False, 8),
           cs._scan_bound(B, 8, False, 8), "==", "")
    for k in (16, 8):
        yield (f"rescore K{k}", rescore_kernel.rescore(B, k),
               cs._rescore_bound(B, k, False, 4), "==", "")
    for s in (2731, 16128):
        yield (f"selector S{s}", selbest_wgmma_kernel.selector(B, s),
               cs._selector_bound(B, s), "==", "")
    yield ("cross6_argmin", cross6_argmin_kernel.argmin(B, C),
           cs._cross6_bound(B, C, False), "==", "")
    yield ("cross6_distances", cross6_kernel.distances(B, C),
           cs._cross6_bound(B, C, True), "==", "")
    yield ("cluster_scan_assemble D27",
           cluster_scan_assemble_kernel.assemble(B, C, 27),
           cs._assemble_bound(B, C, 27, False), "==", "")
    yield ("bisect_rows", bisect_rows_kernel.launches(tex_e)[0],
           cs._bound(B * (28 + 4 * 8), 0.0), "==", "")
    rounds = bisect_round_kernel.launches(tex_e)
    n_bytes = sum(B * 4 * 2 * 8 + 12 * ((1 << r) + 1)
                  for r in range(len(rounds)))
    n_ops = sum(B * 84.0 + 400.0 * (1 << r) for r in range(len(rounds)))
    yield ("bisect_round, 12 rounds", sum(rounds),
           cs._bound(n_bytes, n_ops + 7.0 * B),
           ">=", "chip_smoke bounds the rounds' sums, the frozen bound sums "
           "each round's")
    yield ("min_k k16", min_k_kernel.launches(tex_e)[0],
           cs._bound(B * C * 4 + B * 16 * 8, 0.0),
           "==", "chip_smoke adds the visited entries' operations, which "
           "depend on the data; bytes bound both here")
    v = B * 192
    yield ("xla_reduce selector distances",
           xla_reduce_kernel.launches(tex_e)[0],
           cs._bound(4 * (v * 2 + B * 64), float(v)),
           "<=", "the two operands are one tensor, read once here")
    for mode, wb, _ep, comps in U.RGB_MODES + U.RGBA_MODES:
        yield (f"mode trial {mode}", mode_trial_kernel.trial(B, wb, comps),
               cs._bound(4 * B * (64 + 1 + 2 * comps + 16),
                         float(B * cs._mode_trial_ops(comps, 1 << wb, 1))),
               "==", "")
    for wb, _ep, comps, n_sub, n_pat, topk in U.SUBSET_RGB + U.SUBSET_RGBA:
        yield (f"subset trial C{comps} L{1 << wb}",
               subset_trial_kernel.trial(B, wb, comps, n_sub, n_pat, topk),
               cs._bound(B * 4 * (64 + 1 + 2 * n_sub * comps + 16 + 1),
                         float(B * cs._subset_trial_ops(
                             comps, n_sub, 1 << wb, 1, topk, n_pat))),
               "==", "")
    for wb, _ep, n_ch in U.DUAL_RGB + U.DUAL_RGBA:
        yield (f"dual-plane trial N{n_ch} L{1 << wb}",
               dualplane_trial_kernel.trial(B, wb, n_ch),
               cs._bound(B * 4 * (64 + 1 + 2 * n_ch + 32 + (n_ch != 2)),
                         float(B * cs._dualplane_trial_ops(n_ch, 1 << wb,
                                                           1))),
               "==", "")
    tex_u = dict(codec="uastc", blocks=B, alpha=False)
    yield ("uastc_pack", uastc_pack_kernel.launches(tex_u)[0],
           cs._bound(B * (59 + 4 + 16), 0.0),
           "==", "chip_smoke adds the tables' bytes and the operations of "
           "the slots that win, which depend on the data")


def main() -> int:
    cs.INSTR_S = _peaks.INSTR_S
    bad = 0
    for label, frozen, (ms, what), rel, why in cases():
        ratio = frozen * 1e3 / ms
        ok = {"==": math.isclose(ratio, 1.0, rel_tol=1e-9),
              ">=": ratio >= 1.0 - 1e-9, "<=": ratio <= 1.0 + 1e-9}[rel]
        bad += not ok
        print(f"{'ok ' if ok else 'BAD'} {label}: frozen {frozen * 1e3:.6f} "
              f"ms, chip_smoke {ms:.6f} ms ({what}), ratio {ratio:.6f}, "
              f"expected {rel} 1{'; ' + why if why else ''}")
    mhz = sm_clock_mhz()
    if mhz:
        scale = _peaks.INSTR_S / (132 * 128 * mhz * 1e6)
        print(f"this card's top SM clock {mhz:.0f} MHz: chip_smoke's "
              f"operation bounds read {scale:.6f} x the frozen ones here")
    print(f"{bad} disagreements")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
