"""The frozen bounds against hand counts at small shapes, the launches a
texture is expected to make, and the roofline share read from a trace."""

import math
import types

import pytest

from benchmark import manifest, trace
from benchmark.rooflines import (
    _peaks, bisect_round_kernel, cluster_scan_assemble_kernel,
    cross6_argmin_kernel, cross6_kernel, dualplane_trial_kernel,
    fscan_kernel, min_k_kernel, mode_trial_kernel, rescore_kernel,
    selbest_wgmma_kernel, subset_trial_kernel, uastc_pack_kernel,
    xla_reduce_kernel)

BW, FL, OPS = _peaks.HBM_BYTES_S, _peaks.BF16_TC_FLOP_S, _peaks.INSTR_S


def close(a, b):
    return math.isclose(a, b, rel_tol=1e-12)


def test_peaks_are_fixed():
    assert BW == 3.35e12 and FL == 989e12
    assert close(OPS, 3.345408e13)
    assert _peaks.bound_s(3.35e12, 0) == 1.0
    assert _peaks.bound_s(0, OPS) == 1.0


def test_hand_counts_at_small_shapes():
    # 10 blocks, 216 columns, shortlist of 16: bytes 10*192 + 10*16*8,
    # instructions 10*216*64
    assert close(fscan_kernel.scan(10, 216, False, 16),
                 max((1920 + 1280) / BW, 138240 / OPS))
    # with cluster bases, the (B, 216) sums out
    assert close(fscan_kernel.scan(10, 216, True),
                 max((1920 + 120 + 8640) / BW, 138240 / OPS))
    # 10 blocks x 4 candidates x 16 pixels x 28
    assert close(rescore_kernel.rescore(10, 4),
                 max((1920 + 320) / BW, 17920 / OPS))
    # one-hot product at S 3: 2 * 10 * 3 * 64 FLOPs
    assert close(selbest_wgmma_kernel.selector(10, 3),
                 max((2560 + 192 + 80) / BW, 3840 / FL))
    # C 33 (33 mod 64 = 33: no extra add), below 1,024: no rounding
    assert close(cross6_argmin_kernel.argmin(10, 33),
                 max((240 + 792 + 80) / BW, (10 * 33 * 9 + 11 * 33) / OPS))
    assert close(cross6_kernel.distances(10, 2),
                 max((240 + 48 + 80) / BW, (10 * 2 * 10 + 11 * 12) / OPS))
    assert cross6_argmin_kernel.pair_ops(2416) == 9      # 2416 mod 64 = 48
    n, c, d = 10, 2, 1
    want_bytes = 4 * n * 8 * d + 8 * n + 8 * (c + 1) + 12 * d * c \
        + 4 * c * 8 * d + 192 * n
    want_ops = n * (7 + 8 * d) + 16 * 14 * n + c * d * 25
    assert close(cluster_scan_assemble_kernel.assemble(n, c, d),
                 max(want_bytes / BW, want_ops / OPS))


def test_pair_ops_follows_the_c_mod_64_rule():
    assert cross6_argmin_kernel.pair_ops(64) == 9
    assert cross6_argmin_kernel.pair_ops(65) == 10
    assert cross6_argmin_kernel.pair_ops(96) == 10
    assert cross6_argmin_kernel.pair_ops(97) == 9


ETC1S = dict(codec="etc1s", blocks=24576, alpha=False,
             endpoint_clusters=2416, selector_clusters=2731)
RGB = dict(codec="uastc", blocks=24576, alpha=False)
RGBA = dict(RGB, alpha=True)


@pytest.mark.parametrize("kernel,etc1s,rgb,rgba", [
    ("fscan_kernel", 2, 1, 1), ("rescore_kernel", 3, 1, 1),
    ("selbest_wgmma_kernel", 3, 0, 0), ("cross6_argmin_kernel", 2, 0, 0),
    ("cross6_kernel", 1, 0, 0), ("cluster_scan_assemble_kernel", 1, 0, 0),
    ("bisect_rows_kernel", 1, 0, 0), ("bisect_round_kernel", 12, 0, 0),
    ("min_k_kernel", 1, 0, 0), ("xla_reduce_kernel", 1, 0, 0),
    ("mode_trial_kernel", 0, 4, 8), ("subset_trial_kernel", 0, 2, 3),
    ("dualplane_trial_kernel", 0, 1, 4), ("uastc_pack_kernel", 0, 1, 1)])
def test_launches_a_texture(kernel, etc1s, rgb, rgba):
    """The launches an image makes on each path (PERF.md's table: ETC1S,
    UASTC RGB and RGBA at effort 2)."""
    mod = manifest.rooflines()[kernel]
    assert [len(mod.launches(t)) for t in (ETC1S, RGB, RGBA)] == \
        [etc1s, rgb, rgba]
    assert all(b > 0 for t in (ETC1S, RGB, RGBA) for b in mod.launches(t))


def test_bounds_scale_with_blocks():
    big = dict(ETC1S, blocks=4 * 24576)
    for mod in (min_k_kernel, xla_reduce_kernel, bisect_round_kernel,
                mode_trial_kernel, uastc_pack_kernel):
        for small_t, big_t in ((ETC1S, big), (RGB, dict(RGB, blocks=98304))):
            a, b = sum(mod.launches(small_t)), sum(mod.launches(big_t))
            assert (a == b == 0) or 3.9 < b / a <= 4.0


def test_trials_count_their_modes():
    assert close(sum(mode_trial_kernel.launches(RGB)),
                 sum(mode_trial_kernel.trial(24576, wb, c)
                     for wb, c in ((4, 3), (2, 3), (3, 3), (5, 3))))
    assert len(subset_trial_kernel.launches(RGBA)) == 3
    assert len(dualplane_trial_kernel.launches(RGBA)) == 4


def fake_trace(kernels, textures, seconds=1.0):
    win = types.SimpleNamespace(seconds=seconds, mpix=1.0, calls=[])
    ops = [trace.DeviceOp(name, start, dur, "kernel")
           for name, start, dur in kernels]
    return trace.Trace(win, 0.0, [], ops, textures, manifest.rooflines())


def test_roofline_share_from_the_trace():
    tex = dict(ETC1S)
    bound = sum(min_k_kernel.launches(tex))
    t = fake_trace([("void (anonymous namespace)::min_k_kernel<true>(float "
                     "const*)", 0.1, 4 * bound)], [tex])
    assert close(t.roofline(["min_k_kernel"]), 25.0)
    # a kernel that never ran reads nothing
    assert t.roofline(["cross6_kernel"]) is None
    # fewer launches than expected: the bound shrinks with them
    two = [tex, tex]
    t = fake_trace([("min_k_kernel", 0.1, 2 * bound)], two)
    assert close(t.roofline(["min_k_kernel"]), 50.0)
    # a longer name that holds the kernel's as a part is not it
    t = fake_trace([("min_k_kernel_split", 0.1, bound)], [tex])
    assert t.roofline(["min_k_kernel"]) is None


def test_xla_reduce_pattern_matches_both_widths():
    t = fake_trace([("xla_reduce_kernel32(float)", 0.0, 1e-3),
                    ("xla_reduce_kernel64(float)", 0.1, 1e-3)], [ETC1S])
    assert t.kernel_time(xla_reduce_kernel.KERNEL) == (2, 2e-3)
