#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's encode paths (ETC1S, UASTC LDR 4x4, the
BC7 search and XUBC7, ASTC LDR, XUASTC LDR, the HDR modes), its transcoder
re-encodes and its image metrics once on one GPU.

    python3 chip_smoke.py [--profile OUT_DIR] [--ab OTHER_TREE]
    python3 chip_smoke.py --fit-ab TREE [TREE ...]
    python3 chip_smoke.py --sel-ab TREE [TREE ...]
    python3 chip_smoke.py --wall-ab TREE PAIRS

Run it from the root of the repository's whole tree: alone, it names what
is missing and exits nonzero.

Phases (any failure raises, so the process exits nonzero with no final line):
1. require CUDA; print versions and the card's name and power limit; load
   the port's native host library (fail if it does not load); say whether
   `zstandard` is installed (a stage that needs it and cannot run is named
   on a line of its own; every other stage still runs and must pass);
2. build the hand-written kernels from `basis_universal_tpu_torch/csrc/`
   and print ptxas' registers and spills per kernel;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the paths give it (B = 24,576 blocks of one 768x512 image; the
   full scan's gray-axis sums against cluster bases at radius 1/2 and the
   fused scan + shortlist at radius 0/1/2, which must equal the plain
   errors' shortlist bit for bit in RGB; the rescore at
   K 16 and 8; `palette_errs`, which no path calls, at K 16; the selector
   search (`selbest_wgmma_kernel`, wgmma; ptxas' registers, spills and
   shared memory printed) at S 2,731 and at 16,128, the most selector
   clusters; the cluster scan, its clusters' sums and their assembly in one
   kernel (`cluster_scan_assemble`), on ETC1S image 0's own inputs (C 2,416,
   D 27) and at D 125 and perceptual, beside its bytes bound and the chain
   of adds of its largest cluster, then from the profiler `_cluster_scan`
   with the refine pass's order (one kernel; no cat, sort, gather or
   segment reduction) and the sorts of an ETC1S encode of image 0 by call
   site (its refine pass sorts the assignment once) (`cluster_scan_phase`);
   the
   k-means argmin, the refine's distances (their norms inside) and their
   shortlist in XLA-CPU's
   tie order (`xla_cpu_min_k`, held to `std::sort` on the host on every
   row; its time split by its steps, `min_k_split`) at 24,576 x 2,416; the
   bisecting init on image 0's endpoint vectors (`bisect_rows` and each of
   the 12 `bisect_round`s against the plain version on the same rows, the
   rounds' time in all and by round beside the bound of their chain of
   adds, and `bisecting_init` alone: 13 launches, no sort or segment
   reduction in its rounds, `bisect_phase`); the generic XLA-order
   kernels `xla_fma` and `xla_reduce` at every shape one ETC1S encode of
   image 0 launches them (`etc1s_xla_phase`) and at a UASTC line fit's; the
   UASTC search's line fits, `uastc_line_fit` and `uastc_mode_trial`, at
   every shape the effort-2 and effort-3 searches give them, bit for bit;
   its multi-subset and dual-plane trials, `uastc_subset_trial` and
   `uastc_dualplane_trial`, at each mode of the effort-2 RGB and RGBA
   searches and effort 3's modes 7 and 3, at 24,576 blocks and at 1,001,
   every output equal, each trial's time split by its steps (the luma
   split and shortlist, the fits' chains, the power iteration, the first
   level search, the least-squares steps, the winner and its error:
   `trial_split`, through measurement instances that only
   `<trial>_split` launches), ptxas' registers, shared memory and spills
   printed for every instance (`uastc_trials`);
   the UASTC block packing `uastc_pack` on image 0's winner buffer and on
   buffers in which every slot of efforts 1-4, RGB and RGBA, wins blocks,
   byte for byte, image 0's at 24,576, 4,096 and 1,001 blocks, each size's
   time split by step through the measurement instances of
   `uastc_pack_split`, `pack_split`; `uastc_pack_phase`)
   and time both with CUDA events, beside the least time the card could
   take (bound)
   and, where one PyTorch call computes the same function, that call
   (library); the segment sum's row gather from the scan's row-major
   output and from a transposed one;
4. ETC1S: encode four synthetic 768x512 textures with
   `compressor.compress_batch` at quality 128, effort 1 on the card: check
   that each kernel was launched the expected number of times, decode every
   .basis with the port's host decoder (slice CRCs, PSNR), and hold
   image 0 to the JAX-CPU reference's recorded bytes (sha256);
5. UASTC LDR 4x4: the same four textures through `compress_batch` at
   effort 2, then one 768x512 RGBA texture through `compress`: one scan and
   one rescore launch per image (the ETC1 hint), one `uastc_pack` (the
   blocks, packed on the card; the numpy packer and the plain versions of
   the trials and fits are made to raise) and the XLA-order kernels'
   launches and the trials' per RGB and RGBA image (`EXPECTED_UASTC_XLA`;
   every other path's XLA-order launches are pinned too, ETC1S's by
   `EXPECTED_ETC1S_XLA`), every file
   decoded (CRCs, PSNR), image 0 and the RGBA texture held to the recorded
   JAX-CPU bytes;
6. transcoder: the port's `BasisTranscoder` turns image 0's UASTC file into
   ETC1_RGB (an ETC1S re-encode on the card) and ASTC_4x4_RGBA, and the
   engine's ASTC re-encode of decoded pixels runs the UASTC search on the
   card; launches are asserted and each result is held to the port on the
   CPU;
7. determinism: ETC1S and UASTC image 0 encoded twice give the same bytes;
8. encode one 256x256 texture (ETC1S) on the card and on the CPU, compare;
9. BC7: `codecs/bc7/encode.encode_blocks` on the card at effort 2 on one
   RGB and one RGBA 768x512 texture and at effort 1, decoded with
   `unpack_bc7`: PSNR, mode histogram, wall and device ms, held to the PSNR
   and the per-block digests recorded from the JAX reference on the CPU; two
   card runs equal; card == CPU at 256x256;
10. XUBC7: `compress` lossless (the port's transcoder must return the
   search's BC7 blocks byte for byte) and, at 384x256, lossy (q 50);
11. ASTC LDR 4x4 (through the UASTC search: one scan and one rescore launch
   asserted) and 6x6, XUASTC LDR 4x4 and 6x6 at q 75: decoded through the
   port's transcoder, held to recorded JAX-CPU values;
12. the three HDR modes on a 144x96 float texture, through the transcoder,
   held to the reference's bytes; `ops/metrics.py` on the card against the
   CPU;
13. with `--profile OUT_DIR` only: time 16 images per codec and profile one
   run of each (device time by kernel in OUT_DIR/profile_*.txt), and trace
   one BC7 search of image 0 at effort 2; with `--ab` as well, the 16-image
   profiles of the other tree and of this one in turns (other, this, this,
   other), each in a process of its own;
14. with `--ab OTHER_TREE` only: build the kernels of another checkout of
   the repo (e.g. the parent commit unpacked under `_compare/`), check that
   its scan, rescore, `xla_fma`, `xla_reduce`, k-means argmin (alone and
   `kmeans_assign`), refine distances, cluster scan (`_cluster_scan`, also
   with this tree's refine-pass order given), bisecting init, refine
   shortlist, selector search (S 2,731 and 16,128, image 0's distances and
   drawn ones), UASTC trials (every shape of `uastc_trials` at 24,576 and
   1,001 blocks, `trials_ab`) and `uastc_pack` (image 0's buffer at 24,576,
   4,096 and 1,001 blocks, `pack_ab`) give the same bits as this tree's at
   the shapes of phase 3, and time both in turns (other, this, this,
   other);
   then profile the ETC1S path of each on the images of phase 4 in the
   same turns: device ms and kernels per image, `segment_reduce`'s
   device time by the function that called `segment_sum`, and the sorts
   per image by call site (`segment_split`);
15. front doors, at 768x512: `api.Encoder(device="cuda")` (ETC1S q 50 =
   native 128, effort 1: its bytes equal `compressor.compress`'s; UASTC
   LDR 4x4 and ASTC LDR 4x4: the JAX-CPU reference's bytes) and
   `api.Transcoder(device="cuda")` (decode, ETC1_RGB and ASTC_4x4_RGBA);
   the CLI in-process on image 0 written as an RGBA8 .dds (compress, the
   same bytes as the API; -uastc; -info; -bench); `parallel.mesh` with the
   card named twice (`compress_batch_sharded` byte-equal to
   `compress_batch`, one block-sharded frontend step), `graft_forward` (the
   twin of `__graft_entry__.entry()`) on 1,024 blocks against the CPU, and a
   torch.profiler device trace around one API encode (`utils/telemetry`);
   launches counted per path (`api`, `cli`);
16. ETC1S image 0, card against CPU: the bytes of the card and of the CPU
   (equal, and the reference's sha256, asserted), of the card with the
   selector search's plain version run on the CPU in place of its kernel,
   and of the card with the refine shortlist that the reference's own
   unstable sort takes (recorded; the reference's sha256, asserted: the
   witness that the port's own shortlist orders ties as that sort does),
   with the codebook entries and bytes that differ.

The last two lines are the kernels' JSON record and the result line.
`--fit-ab TREE [TREE ...]` runs only phase 1, then times the UASTC line
fits of phase 3 (each shape held to its plain version) with this
checkout's package and with each other tree's, in turns, and prints no
result line. `--sel-ab TREE [TREE ...]` runs only phase 1, then times
the selector search of this checkout and of each other tree on phase 3's
inputs and on the ETC1S path's first call, in turns, with each tree's
outputs against this one's, and prints no result line (`phase_sel_ab`).
`--wall-ab TREE PAIRS` runs only phase 1, then times
`compress_batch` of 16 images, ETC1S and UASTC, with this checkout's
package and the other tree's, PAIRS pairs in alternating order, each run
in a process of its own (`phase_wall_ab`), and prints no result line.
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Image 0 = synthetic_texture(512, 768, seed=0), encoded by the JAX reference
# `basis_universal_tpu.compressor.compress(img, CompressorParams(
# quality_level=128, effort=1))` on the CPU (JAX_PLATFORMS=cpu, jax 0.9.0),
# decoded and scored by `testing.checks.etc1s_psnr`. Recorded with:
#   JAX_PLATFORMS=cpu python -c "from basis_universal_tpu_torch.testing.\
#   synthetic import synthetic_texture; from basis_universal_tpu import \
#   compressor as c; img, sha = synthetic_texture(512, 768, seed=0); \
#   out = c.compress(img, c.CompressorParams(quality_level=128, effort=1)); \
#   print(sha, len(out.basis_data))"
REFERENCE_IMAGE0 = dict(
    sha256="36542c57e0a423150ecc6626b1b06caee9e512bdd0e440110929e964337f7277",
    psnr=35.50339699342063,
    basis_bytes=46997,
)
# UASTC LDR 4x4 at effort 2, same recipe with tex_format=UASTC_LDR_4x4 and
# effort=2 (jax 0.9.0, CPU), scored by `testing.checks.uastc_psnr`: image 0,
# and an RGBA texture, synthetic_texture(512, 768, seed=4, alpha=True).
REFERENCE_UASTC_IMAGE0 = dict(psnr=44.89409768463236, basis_bytes=393316)
# sha256 of the reference's .basis files (`tests/test_torch_recorded_reference.py
# --only etc1s_image0 uastc_image0 uastc_rgba`, jax 0.9.0, CPU)
REFERENCE_BASIS_SHA256 = dict(
    etc1s_image0="aa52f61866612e036df7ffeedfb6ffcf160ddabf9688aff2b1506d333cca30cf",
    uastc_image0="9fa72043038783e767cb3e04ce3dd6cc953053f77bbfac2061fd5ae08d0034b4",
    uastc_rgba="142fad0b66ba8a65cb08e9f426ea4ffe53d50e690ab1ebac92a9b01e54c4540b",
)
REFERENCE_UASTC_RGBA = dict(
    sha256="f69600ec8c55ad49376dd26b572282dfa943288d653d137cc037df05cce0e485",
    psnr=41.97688873860354,
    basis_bytes=393316,
)
# The encode modes beyond ETC1S and UASTC, recorded from the JAX reference on
# the CPU (jax 0.9.0) by `tests/test_torch_recorded_reference.py`, which
# also wrote the BC7 stages' per-block digests to
# `basis_universal_tpu_torch/testing/bc7_reference_digests.npz`. Textures:
# image 0 (768x512 RGB), the RGBA texture, and for the slow host stages
# `synthetic_texture(256, 384, seed=0)` ("small"). BC7: `encode_blocks` at
# effort 2 / 1, PSNR of `unpack_bc7` against the source blocks, blocks per
# mode. The others: `compress` (XUBC7 effort 2; ASTC LDR 4x4 effort 2, 6x6
# effort 1; XUASTC LDR q 75, 4x4 effort 2, 6x6 effort 1), level 0 decoded
# to RGBA32 by the transcoder, PSNR against the source as RGBA.
REFERENCE_BC7 = dict(
    bc7_rgb_e2=dict(psnr=46.15488699663378,
        modes=[5, 6011, 79, 18473, 0, 0, 8, 0]),
    bc7_rgba_e2=dict(psnr=42.62174160401629,
        modes=[0, 472, 8, 1867, 2373, 16728, 2183, 945]),
    bc7_rgb_e1=dict(psnr=45.39517792894461,
        modes=[0, 24124, 0, 0, 0, 0, 452, 0]),
)
REFERENCE_MODES = dict(
    xubc7_q100=dict(psnr=45.556007334292595, basis_bytes=308732,
        sha256="aa06549c52363f51ceb8eb1ceb6ab25c1fc2b4c7a1c17544a04388cd11b6a394"),
    xubc7_q50_small=dict(psnr=40.809917459146575, basis_bytes=35010,
        sha256="e1b7f7f455422bf8ceb2e2463eef12e97b62de09293dc91ffe88df3ddc057f77"),
    astc_4x4=dict(psnr=46.1545033544006, basis_bytes=393316,
        sha256="75ea7f39ffa751aab1e7cc29a61d3c7c538b07dfb7447e7e1305978eaf7d6e6b"),
    astc_6x6=dict(psnr=42.29932063730956, basis_bytes=176228,
        sha256="d2cbee124b25c3b369c6e3667b8e739f840a6c98cc8a1278051aebd44bff1244"),
    xuastc_4x4=dict(psnr=41.168751727847386, basis_bytes=178643,
        sha256="6c23faf6cd8d1838d14ed01a828cfa1895587ef64876189034900588d2a08a3e"),
    xuastc_4x4_arith=dict(psnr=41.168751727847386, basis_bytes=171260,
        sha256="9ae9203c4a5cd4af401fb8fd3087d0202b11cb7536aafbc5b60739d58e7ea833"),
    xuastc_6x6_small=dict(psnr=39.616091975408395, basis_bytes=24435,
        sha256="55fd55794362cafe25e7d2b75e750a71adef6c1a6ac5450738b4e971e43e69e1"),
    xuastc_6x6_small_arith=dict(psnr=39.616091975408395, basis_bytes=23830,
        sha256="8ffe8d10484dc7f371f5f5fa10d61e0c27a3de4bd40a3d19def7dd2e85d83c64"),
)
# the three HDR modes (host code): sha256 of the reference's .basis of the
# 144x96 float texture of `_hdr_texture`, effort 1
REFERENCE_HDR = dict(
    UASTC_HDR_4x4="d24c545694d3d06b3772de2a7fec54345fc1f7ffb85729c33588e68344f2a8e5",
    ASTC_HDR_6x6="1bba08294a559c9a155a4dc0ac304affeca3493edc9675d61ecd8de516f5920a",
    UASTC_HDR_6x6_INTERMEDIATE="00ff110fcb949f1da8023cfd5641f09b9af92b401f254ce64e02cb76c3b2773a",
)
# share of BC7 blocks that must be identical to the reference's: the search
# spells out XLA-CPU's float32 arithmetic, and the CPU tests find every block
# equal
MIN_BC7_SHARE = 1.0
MIN_HDR_HALF_PSNR = 45.0    # dB over half-float bit patterns
METRICS_RTOL = 1e-4         # card against CPU, float32 sums in another order
METRICS_DE_RTOL = 1e-2      # Delta-E ITP: 720 x nearly cancelling PQ terms
# the bound the CPU tests hold the port to
PSNR_TOL_DB = 0.05
SIZE_TOL = 0.015

HEIGHT, WIDTH, N_IMAGES = 512, 768, 4
QUALITY, EFFORT = 128, 1
UASTC_EFFORT = 2
RGBA_SEED = 4
# kernel launches per image at q128 / effort 1: the fused scan + shortlist
# in encode_blocks and the full scan in the one refine pass, its cluster
# errors' assembly, the rescore in encode_blocks, the refine's cluster
# rescore and its reassignment, the selector search in the two selector
# iterations and the final assignment, the k-means assignment in its two
# iterations, the refine's distances and their shortlist, and the bisecting
# init's rows and rounds
EXPECTED_PER_IMAGE = {"factorized_scan": 1, "factorized_scan_shortlist": 1,
                      "cluster_scan_assemble": 1,
                      "palette_errs_packed": 3,
                      "find_best_selector_patterns": 3,
                      "cross6_argmin": 2, "cross6_distances": 1,
                      "xla_cpu_min_k": 1,
                      # the bisecting init: its rows, then one launch per
                      # round, ceil(log2 2416)
                      "bisect_rows": 1, "bisect_round": 12}
# the transcoder's ETC1 target: one fused scan (radius 1) and one rescore
# (K 16)
EXPECTED_ETC1_TRANSCODE = {"factorized_scan_shortlist": 1,
                           "palette_errs_packed": 1}
# UASTC: per image, one fused scan (radius 0) and one rescore (K 8) for the
# ETC1 hint, and one packing of the blocks (the transcoder's ASTC re-encode
# runs one UASTC search)
EXPECTED_UASTC_PER_IMAGE = {"factorized_scan_shortlist": 1,
                            "palette_errs_packed": 1, "uastc_pack": 1}
# images each path encodes or transcodes in its counted run
PATH_IMAGES = {"etc1s": N_IMAGES, "uastc": N_IMAGES + 1, "transcoder": 1,
               "astc_ldr_4x4": 1, "xuastc_ldr_4x4": 1,
               # the API: ETC1S, UASTC and ASTC 4x4 encodes, one transcode
               "api": 4,
               # the CLI: ETC1S and UASTC compress, -bench's three encodes
               "cli": 5}
PALLAS = "basis_universal_tpu/ops/pallas_etc1s.py"
REPLACES = {"factorized_scan": f"{PALLAS}:343",
            "factorized_scan_shortlist": f"{PALLAS}:343",
            "palette_errs_packed": f"{PALLAS}:137",
            "palette_errs": f"{PALLAS}:49",
            "find_best_selector_patterns": f"{PALLAS}:207",
            # no Pallas kernel: the reference's XLA matrix products
            "cross6_argmin": "basis_universal_tpu/ops/etc1s_encode.py:357",
            "cross6_distances": "basis_universal_tpu/ops/etc1s_encode.py:452",
            # no Pallas kernel: the XLA segment sums of the cluster scan and
            # the assembly of its errors
            "cluster_scan_assemble":
                "basis_universal_tpu/ops/etc1s_encode.py:284-306",
            # the bisecting init's moment features and its rounds
            "bisect_rows": "basis_universal_tpu/ops/etc1s_encode.py:394",
            "bisect_round": "basis_universal_tpu/ops/etc1s_encode.py:403",
            # no Pallas kernel: XLA's ApproxTopK (a std::sort on the CPU)
            "xla_cpu_min_k": "basis_universal_tpu/ops/etc1s_encode.py:457",
            # no Pallas kernel: XLA's fused multiply-adds and ordered sums in
            # the reference's compiled searches (e.g. the UASTC line fit)
            "xla_fma": "basis_universal_tpu/codecs/uastc/encode.py:90",
            "xla_reduce": "basis_universal_tpu/codecs/uastc/encode.py:119",
            # no Pallas kernel: the reference's jitted line fits, a masked
            # fit (`_fit_line_masked`) and a single-subset mode trial
            "uastc_line_fit": "basis_universal_tpu/codecs/uastc/encode.py:155",
            "uastc_mode_trial": "basis_universal_tpu/codecs/uastc/encode.py:56",
            # no Pallas kernel: the reference's jitted multi-subset trials
            # (`_mode_trial_2subset`, `_mode_trial_3subset`) and dual-plane
            # trials (`_mode_trial_dualplane`, `_mode_trial_dualplane4`,
            # `_mode_trial_dualplane_la`)
            "uastc_subset_trial":
                "basis_universal_tpu/codecs/uastc/encode.py:215, :328",
            "uastc_dualplane_trial":
                "basis_universal_tpu/codecs/uastc/encode.py:408, :462, :515",
            # no Pallas kernel: the reference's numpy packing of the search's
            # winner buffer into UASTC blocks
            "uastc_pack": "basis_universal_tpu/codecs/uastc/encode.py:700"}
XLA_ORDER_KERNELS = ("xla_fma", "xla_reduce", "uastc_line_fit",
                     "uastc_mode_trial", "uastc_subset_trial",
                     "uastc_dualplane_trial")
# XLA-order launches per UASTC effort-2 image (RGB; RGBA): one
# `uastc_mode_trial` per single-subset mode, one `uastc_subset_trial` per
# 2-subset mode and one `uastc_dualplane_trial` per dual-plane mode; no line
# fit and no generic ordered sum or fused multiply-add outside them
# (`tests/test_torch_uastc_encode.py` counts the same on the CPU)
EXPECTED_UASTC_XLA = {
    False: {"xla_reduce": 0, "xla_fma": 0, "uastc_mode_trial": 4,
            "uastc_subset_trial": 2, "uastc_dualplane_trial": 1,
            "uastc_line_fit": 0},
    True: {"xla_reduce": 0, "xla_fma": 0, "uastc_mode_trial": 8,
           "uastc_subset_trial": 3, "uastc_dualplane_trial": 4,
           "uastc_line_fit": 0}}
# XLA-order launches per ETC1S image at q128 / effort 1 (768x512, and as
# many at 128x192 and 64x64), counted on the CPU as the UASTC test counts
# (the top-level calls of `ops/xla_order.py`'s plain versions outside every
# hand-written kernel's): the one ordered sum left outside the kernels, the
# selector distances' dot (`block_selector_distances`); the cluster scan's
# assembly and the k-means and refine norms are inside their kernels. The
# transcoder's ETC1 re-encode makes none
EXPECTED_ETC1S_XLA = {"xla_fma": 0, "xla_reduce": 1}
CODEBOOK_KERNELS = ("cross6_argmin", "cross6_distances",
                    "cluster_scan_assemble")
SOURCES = {name: "basis_universal_tpu_torch/csrc/"
           + ("xla_order_kernels.cu" if name in XLA_ORDER_KERNELS
              else "uastc_pack_kernels.cu" if name == "uastc_pack"
              else "etc1s_codebook.h" if name in CODEBOOK_KERNELS
              else "etc1s_kernels.cu") for name in REPLACES}
RTOL = 1e-5
SCAN_MAG_TOL = 1e-6     # ~8 float32 ulps of the scan's cancelled terms
SEL_S = (2731, 16128)   # selector patterns: the main path's, and the most

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet, dense): HBM bytes/s and bf16 tensor-core FLOP/s. Operations
# outside the tensor cores are counted as instructions, one per lane for a
# fused multiply-add, a multiply, an add, a compare or a select, at the
# card's issue rate, SMs x 128 lanes x the SM's top clock, read in this run
# (`phase_env`, `INSTR_S`): on the H100 SXM 132 x 128 x 1,980 MHz = 33.5e12
# per second, which is the data sheet's 67 TFLOP/s float32 with a fused
# multiply-add counted as its two FLOPs. A kernel's bound is the larger of
# its bytes (each input read once, each output written once) over the first
# and its operations over their rate.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
INSTR_S = None
SM_MHZ = None


def _bound(n_bytes, ops, rate=None):
    """(bound ms, what sets it) of a call moving n_bytes and doing ops
    instructions (or, with rate, ops operations at rate per second)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / (rate or INSTR_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _scan_bound(b_n, n_cols, external_base, k=None):
    """factorized_scan: per output column, 16 pixels x (a compare, a
    select, a subtract and a multiply-add = 4 instructions): 64 (the
    shortlist's selection not counted); bytes: the pixels (and cluster
    bases) in, the (B, D*8) float32 sums out, or with k the (B, k) int64
    columns of the fused shortlist."""
    n_bytes = b_n * 48 * 4 + (b_n * 12 if external_base else 0) \
        + (b_n * n_cols * 4 if k is None else b_n * k * 8)
    return _bound(n_bytes, b_n * n_cols * 16 * 4)


def _rescore_bound(b_n, k, perceptual, palette_bytes):
    """palette_errs(_packed): per output, 16 pixels x 4 selectors x (3
    subtracts, a multiply and two multiply-adds = 6 instructions) plus 16
    x (3 mins, an add); with the perceptual metric the 3x3 transform (3
    products and 6 multiply-adds) of the output's 4 palette colours and of
    each block's 16 pixels; bytes: pixels, the candidates (palette_bytes
    each) and the errors."""
    ops = b_n * k * (16 * (4 * 6 + 4) + (4 * 9 if perceptual else 0)) \
        + (b_n * 16 * 9 if perceptual else 0)
    n_bytes = b_n * 48 * 4 + b_n * k * (palette_bytes + 4)
    return _bound(n_bytes, ops)


def _selector_bound(b_n, s):
    """find_best_selector_patterns: the one-hot product, 2*B*S*64 bf16
    tensor-core FLOPs; bytes: the (B, 64) float32 distances and (S, 16)
    int32 patterns in, index and error per block out."""
    return _bound(b_n * 64 * 4 + s * 16 * 4 + b_n * 8,
                  2.0 * b_n * s * 64, BF16_TC_FLOP_S)


def _cross6_ops(c):
    """Instructions per (row, centroid) pair of the 6-D distances: 6
    products and fused multiply-adds, the two chains' add where C mod 64
    is 1..32, and 3 more: the distances' scale, subtract and add, or the
    argmin's fold of q - 2x into one fused multiply-add (-2x is exact), its
    compare and its select."""
    return 9 + (1 <= c % 64 <= 32)


def _cross6_bound(n, c, matrix):
    """cross6_*: `_cross6_ops` per pair, and per vector its squared norm
    (6 products and adds; the argmin's centroids only) and, in the argmin
    from 1,024 centroids, its 6 coordinates rounded to bf16 and back (2
    instructions each); bytes: a (N, 6) and c (C, 6) in, the (N, C)
    float32 distances or the (N,) int64 indices out."""
    n_bytes = n * 24 + c * 24 + (n * c * 4 if matrix else n * 8)
    norms = 11 * (c + (n if matrix else 0))
    rounds = 0 if matrix or c < 1024 else 12 * (n + c)
    return _bound(n_bytes, float(n * c * _cross6_ops(c) + norms + rounds))


def _assemble_bound(b_n, c_n, d_n, perceptual):
    """cluster_scan_assemble, the clusters' sums and their assembly: bytes,
    the terms (B, 8D), the order (B,) and offsets (C + 1,) int64, the
    pixels (B, 16, 3) (RGB) or the six moments a block and the levels (D,
    C) (perceptual) and the bases (D, C, 3) in, the (C, 8D) errors out;
    operations, per member an add per column (7 + 8D) and in RGB its
    moments, 14 a pixel (3 channel sums, 3 squares and their adds, the
    luma's 2 adds, its square and 2 adds), per (cluster, delta) its
    constant part (17, as before) and per output a fused multiply-add."""
    n_bytes = (4 * b_n * 8 * d_n + 8 * b_n + 8 * (c_n + 1)
               + 12 * d_n * c_n + 4 * c_n * 8 * d_n
               + (4 * (6 * b_n + d_n * c_n) if perceptual else 192 * b_n))
    ops = b_n * (7 + 8 * d_n) + (0 if perceptual else 16 * 14 * b_n) \
        + c_n * d_n * (17 + 8)
    return _bound(n_bytes, float(ops))


def _selector_resources():
    """ptxas' registers, spills and static shared memory of the selector
    kernel, and its dynamic shared memory (the ring of one-hot tiles, from
    the source's constants)."""
    import re

    from basis_universal_tpu_torch.ops import _build

    use = [u for k, u in _ptxas_summary(_build.ptxas_report(
        _build.library_path())) if "selbest_wgmma_kernel" in k]
    src = (_build._PKG / "csrc" / "etc1s_kernels.cu").read_text()
    n, stages = (int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
                 for c in ("kSelN", "kSelStages"))
    return (f"{use[0] if use else 'not in the report'}; dynamic shared "
            f"memory {stages * n * 128 + 1024} bytes ({stages} tiles of "
            f"{n} patterns x 128 B, 1 KB for alignment)")


def etc1s_xla_phase(torch, img0, measure):
    """`xla_fma` and `xla_reduce` at the shapes the ETC1S path launches
    them (q128, effort 1, one 768x512 image): every top-level launch of one
    encode of image 0, recorded with its operands (`EXPECTED_ETC1S_XLA`
    of them), then each distinct call held to its plain version, every
    value, and timed beside its bound and one PyTorch call (`addcmul`;
    `sum` or `linalg.vecdot`)."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.ops import xla_order as xo

    calls, depth = [], [0]
    real = {"xla_fma": xo._fma_card, "xla_reduce": xo._reduce_card}

    def recorded(name):
        def run(*args):
            depth[0] += 1
            try:
                out = real[name](*args)
            finally:
                depth[0] -= 1
            if depth[0] == 0:           # not the call's own retyped re-entry
                calls.append((name, args))
            return out
        return run

    xo._fma_card, xo._reduce_card = (recorded("xla_fma"),
                                     recorded("xla_reduce"))
    try:
        compressor.compress(img0, compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device="cuda"))
        torch.cuda.synchronize()
    finally:
        xo._fma_card, xo._reduce_card = real["xla_fma"], real["xla_reduce"]
    got = {k: sum(n == k for n, _ in calls) for k in EXPECTED_ETC1S_XLA}
    if got != EXPECTED_ETC1S_XLA:
        raise AssertionError(f"ETC1S image 0 launched {got} XLA-order "
                             f"kernels, expected {EXPECTED_ETC1S_XLA}")

    def shape(x):
        if isinstance(x, torch.Tensor):
            return "x".join(map(str, x.shape)) or "0-d"
        return "scalar" if isinstance(x, float) else x

    distinct = {}
    for name, args in calls:
        key = (name, tuple(shape(x) for x in args))
        distinct.setdefault(key, [args, 0])[1] += 1
    dev = torch.device("cuda")
    for (name, sig), (args, count) in distinct.items():
        if name == "xla_fma":
            a, b, c = args
            label = f"ETC1S {sig[0]} * {sig[1]} + {sig[2]}"
            ts = [x if isinstance(x, torch.Tensor) else
                  torch.tensor(float(x), device=dev) for x in args]
            run = lambda a=a, b=b, c=c: real["xla_fma"](a, b, c)
            plain = lambda a=a, b=b, c=c: xo.fma_reference(a, b, c)
            library = lambda ts=ts: torch.addcmul(ts[2], ts[0], ts[1])
            out = run()
            n_bytes = sum(x.numel() * 4 for x in args
                          if isinstance(x, torch.Tensor)) + out.numel() * 4
            ops = float(out.numel())
        else:
            a, b, dim, order = args
            label = (f"ETC1S {order} over dim {dim} of {sig[0]}"
                     + ("" if b is None else f" and {sig[1]}"))
            run = lambda a=a, b=b, dim=dim, order=order: real["xla_reduce"](
                a, b, dim, order)
            plain = lambda a=a, b=b, dim=dim, order=order: \
                xo.reduce_reference(a, b, dim, order)
            library = (lambda a=a, dim=dim: torch.sum(a, dim)) if b is None \
                else (lambda a=a, b=b, dim=dim: torch.linalg.vecdot(a, b,
                                                                   dim=dim))
            out = run()
            n_bytes = a.numel() * 4 + (0 if b is None else b.numel() * 4) \
                + out.numel() * 4
            ops = float(out.numel() * torch.broadcast_shapes(
                a.shape, a.shape if b is None else b.shape)[dim])
        want = plain()
        torch.cuda.synchronize()
        n_diff = int((out != want).sum())
        if n_diff:
            raise AssertionError(f"{name} {label}: {n_diff} of {out.numel()} "
                                 "values differ from the plain version")
        print(f"{name} {label}: {count} of the ETC1S image's launches, every "
              f"one of {out.numel()} values the plain version's")
        measure(name, f"{label} (x{count} an image)", run, plain, 0.0,
                _bound(n_bytes, ops), library=library)


def cluster_scan_phase(torch, ck, ops, px, ids, img0, measure):
    """`cluster_scan_assemble`, the clusters' sums and their assembly in one
    kernel, at the paths' shapes: its inputs recorded from one ETC1S encode
    of image 0 (q128, effort 1: C 2,416, D 27, RGB) and from
    `optimize_cluster_endpoints` of image 0's blocks px with the cluster ids
    ids at radius 2 and with the perceptual metric; each held to the plain
    version on the CPU, every bit, and timed beside its bytes bound, the
    chain of adds of its largest cluster and the plain version on the card.
    Then, from the profiler: `_cluster_scan` as the refine pass calls it
    (its order given) runs one kernel and no cat, sort, gather or segment
    reduction; and an ETC1S encode of image 0 sorts its assignment once in
    its refine pass, the pass's other sums reading that order
    (`segment_split`'s sorts by call site)."""
    from torch.profiler import ProfilerActivity, profile

    from basis_universal_tpu_torch import compressor

    seen, real = [], ck.cluster_scan_assemble

    def recorded(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    rng = np.random.default_rng(7)
    means = torch.as_tensor(rng.uniform(0, 255, (2416, 3)),
                            dtype=torch.float32, device=px.device)
    ck.cluster_scan_assemble = recorded
    try:
        compressor.compress(img0, compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device="cuda"))
        for radius, perceptual in ((2, False), (1, True)):
            ops.optimize_cluster_endpoints(px, ids, means, 2416,
                                           radius=radius,
                                           perceptual=perceptual)
        torch.cuda.synchronize()
    finally:
        ck.cluster_scan_assemble = real
    if len(seen) != 3:
        raise AssertionError(f"cluster_scan_assemble: {len(seen)} calls "
                             "recorded, expected 3")

    def on_cpu(v):
        if isinstance(v, tuple):
            return tuple(on_cpu(x) for x in v)
        return None if v is None else v.cpu()

    for label, (args, kw) in zip(("ETC1S image 0", "radius 2", "perceptual"),
                                 seen):
        mt, order, offsets, base8 = args[:4]
        d_n, c_n = base8.shape[:2]
        perceptual = kw.get("moments") is not None
        counts = offsets[1:] - offsets[:-1]
        longest = int(counts.max())
        label = f"C{c_n} D{d_n} {label}"
        got = real(*args, **kw)
        want = ck.cluster_scan_assemble_reference(
            *on_cpu(args), **{k: on_cpu(v) for k, v in kw.items()})
        n_diff = int((got.cpu().view(torch.int32)
                      != want.view(torch.int32)).sum())
        if n_diff:
            raise AssertionError(f"cluster_scan_assemble {label}: {n_diff} of "
                                 f"{got.numel()} values differ from the "
                                 "plain version")
        chain = _bisect_chain_ms([longest])
        print(f"cluster_scan_assemble {label}: every one of {got.numel()} "
              f"values the plain version's; {mt.shape[0]} blocks, "
              f"{int((counts == 0).sum())} empty clusters, the largest "
              f"{longest} members (its chain of adds {chain:.4f} ms)")
        measure("cluster_scan_assemble", label,
                lambda a=args, k=kw: real(*a, **k),
                lambda a=args, k=kw: ck.cluster_scan_assemble_reference(*a,
                                                                        **k),
                0.0, _assemble_bound(mt.shape[0], c_n, d_n, perceptual),
                chain_ms=chain)

    # `_cluster_scan` as the refine pass calls it: the pass's order given
    (mt, order, offsets, base8), kw = seen[0]
    scan = lambda: ops._cluster_scan(  # noqa: E731
        kw["pixels"], None, base8, None, mt, False, (order, offsets))
    scan()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kernels = sum(e.count for e in avgs if e.device_type == cuda_type)
    banned = [e.key for e in avgs if e.device_type != cuda_type and any(
        b in e.key for b in ("aten::cat", "sort", "segment_reduce",
                             "aten::index"))]
    if kernels != 1 or banned:
        raise AssertionError(f"_cluster_scan ran {kernels} device kernels "
                             f"and {banned}")
    print(f"_cluster_scan C{base8.shape[1]} D{base8.shape[0]} with the "
          f"refine pass's order: {kernels} device kernel, no cat, sort, "
          "gather or segment reduction; call "
          f"{_time_ms(scan, torch):.4f} ms, device "
          f"{_device_ms(torch, scan):.4f} ms")

    # the sorts of one ETC1S encode of image 0, by call site: the refine
    # pass sorts its assignment once (`segment_order` in the frontend), and
    # none of its sums sorts again
    got = segment_split(torch, "basis_universal_tpu_torch", [img0])
    sorts = got["sorts"]
    print("ETC1S image 0 sorts by call site: " + ", ".join(
        f"{k} {v:g}" for k, v in sorted(sorts.items())))
    again = [k for k in sorts if k.split("@")[1] in (
        "optimize_cluster_endpoints", "_cluster_scan")
        and not k.startswith("_shortlist@")]
    if sorts.get("segment_order@_frontend_impl") != 1 or again or \
            "segment_sum@_frontend_impl" in sorts:
        raise AssertionError(f"the refine pass's sorts: {sorts}")


def _time_ms(fn, torch, reps=20, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_us(torch, fn, n=100):
    """Host microseconds per call of fn: n calls queued without a wait."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def _device_ms(torch, fn, n=20, tries=6):
    """Device milliseconds per call of fn: the time of every kernel that n
    calls launch (after a warm-up call), by torch.profiler, over n. Every
    caller's fn launches kernels, so a profile with no device time (the
    profiler dropped its records) is taken again, up to `tries` times,
    then raises."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == cuda) / 1e3 / n
        if ms > 0:
            return ms
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                       "profiles of a function that launches kernels")


def phase_env(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs one CUDA card")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if clock.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {clock.stderr}")
    global INSTR_S, SM_MHZ
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = SM_MHZ = float(clock.stdout.strip().splitlines()[0])
    INSTR_S = sms * 128 * mhz * 1e6
    print(f"issue rate: {sms} SMs x 128 lanes x {mhz:.0f} MHz = "
          f"{INSTR_S:.4g} instructions/s")
    from basis_universal_tpu_torch import native

    if not native.available():
        raise RuntimeError("the port's native host library "
                           "(native/slice_codec.cpp) did not build or load")
    print(f"native host library: {native.get_lib()._name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib.util

    have_zstd = importlib.util.find_spec("zstandard") is not None
    print(f"zstandard: {'found' if have_zstd else 'NOT installed'} (the XUBC7 "
          "stream, the full_zstd / hybrid XUASTC syntaxes and Zstandard KTX2 "
          "levels need it)")
    return card, have_zstd


def phase_build():
    """Both kernel sources, one nvcc each, started together."""
    from basis_universal_tpu_torch.ops import _build

    t0 = time.time()
    paths = _build.build_all()
    for name in paths:
        _build.get_lib(name)
    print(f"build: {', '.join(p.name for p in paths.values())} in "
          f"{time.time() - t0:.1f} s")
    for path in paths.values():
        for line in _build.ptxas_report(path).splitlines():
            print(f"ptxas: {line.strip()}")
        for kernel, use in _ptxas_summary(_build.ptxas_report(path)):
            if "trial_kernel" in kernel:
                print(f"ptxas {kernel}: {use}")


def _ptxas_summary(report):
    """(kernel, "N registers, M bytes smem, spills S/L bytes") per entry
    function of a ptxas -v report, the mangled name cut to its template
    arguments (`subset_trial_kernel<3,2,6>`)."""
    import re

    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d+([A-Za-z_]+_kernel)I((?:L[ib]-?\d+E)+)E",
                          m.group(1))
            name = (f"{k.group(1)}<"
                    + ",".join(re.findall(r"L[ib](-?\d+)E", k.group(2)))
                    + ">") if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append((name, f"{m.group(1)} registers, "
                              f"{m.group(2) or 0} bytes smem, {spill}"))
            name = None
    return out


def _close(got, want, mag, what):
    """|got - want| <= RTOL |want| + SCAN_MAG_TOL mag, where mag is the size
    of the terms a formula cancels (0 where it cancels none); returns the
    max abs error."""
    err = (got - want).abs()
    bound = RTOL * want.abs() + SCAN_MAG_TOL * mag
    bad = int((err > bound).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {err.numel()} values outside "
                             f"rtol {RTOL} (max abs err {err.max().item():.4g})")
    return err.max().item()


def _shortlist_close(torch, got, want, flat, mag, what):
    """Shortlist indices got against want, both (B, k): where they differ,
    the two columns' plain scores (flat) must tie within the scan's
    tolerance. Returns the largest such score difference (0 if none)."""
    rows = torch.arange(got.shape[0], device=got.device)[:, None]
    a, b = flat[rows, got].double(), flat[rows, want].double()
    tol = 2.0 * (RTOL * b.abs() + SCAN_MAG_TOL * mag[rows, want].double())
    differ = got != want
    if bool(((a - b).abs() > tol)[differ].any()):
        raise AssertionError(f"{what}: an index differs off a tie")
    print(f"{what}: {int(differ.any(1).sum())} of {got.shape[0]} rows "
          "ordered differently from the plain version at ties")
    return float((a - b).abs()[differ].max()) if bool(differ.any()) else 0.0


def min_k_split(torch, ck, d, k=16):
    """The sort kernel stopped after each of its steps on the same rows:
    the row loaded only, loaded and partitioned (no final step), and the
    whole kernel: call and device ms of each (`xla_cpu_min_k`'s `stage`)."""
    split = {}
    for stage, label in ((0, "load"), (1, "load + partitions"), (2, "full")):
        run = lambda: ck.xla_cpu_min_k(d, k, stage=stage)  # noqa: E731
        split[label] = (_time_ms(run, torch), _device_ms(torch, run))
        print(f"xla_cpu_min_k split, {label}: call {split[label][0]:.4f} ms, "
              f"device {split[label][1]:.4f} ms")
    return split


def _bisect_chain_ms(lengths):
    """The dependent chain of the bisecting rounds: each round waits at
    least 4 cycles (a float32 add's latency) per member of its largest
    cluster, the leaf sums per member of the largest leaf; ms at the SM's
    top clock (`phase_env`). With one length, the chain of a sum in row
    order over that many members (the cluster scan's)."""
    return 4.0 * sum(lengths) / (SM_MHZ * 1e3)


def bisect_phase(torch, ck, ops, vec6, measure):
    """Phase 3's bisecting init: each round's kernel against its plain
    version at the main path's shapes, the rounds' bound (bytes,
    operations, and the chain of adds of each round's largest cluster),
    their times, and `bisecting_init` alone: at most 13 launches, none of
    them a sort or a segment reduction."""
    from torch.profiler import ProfilerActivity, profile

    n, c = vec6.shape[0], 2416
    rounds = int(np.ceil(np.log2(c)))
    w = torch.ones(n, dtype=torch.float32, device=vec6.device)
    first = ck.bisect_rows(vec6, w)
    want = ck.bisect_rows_reference(vec6, w)
    torch.cuda.synchronize()
    if not all(torch.equal(g, p_) for g, p_ in zip(first, want)):
        raise AssertionError("bisect_rows: differs from the plain version")
    # bound: vecs and weights in, the member rows out
    measure("bisect_rows", f"N{n}", lambda: ck.bisect_rows(vec6, w),
            lambda: ck.bisect_rows_reference(vec6, w), 0.0,
            _bound(n * (28 + 4 * ck.BISECT_M), 0.0))
    members, starts = first
    inputs, longest = [], []
    for r in range(rounds):
        last = r == rounds - 1
        got = ck.bisect_round(members, starts, last=last)
        plain = ck.bisect_round_reference(members, starts, last=last)
        torch.cuda.synchronize()
        for g, p_ in zip(got, plain):
            if g is not None and not torch.equal(g, p_):
                raise AssertionError(f"bisect_round {r}: "
                                     f"{int((g != p_).sum())} values differ "
                                     "from the plain version")
        inputs.append((members, starts, last))
        longest.append(int((starts[1:] - starts[:-1]).max()))
        members, starts, leaves = got
    longest.append(int((starts[1:] - starts[:-1]).max()))      # the leaves

    def run_rounds(fn):
        for members_, starts_, last_ in inputs:
            fn(members_, starts_, last=last_)

    # bound: per round each member row read and written once (32 B each
    # way) and the offsets; per member its 28 moment columns (22 products
    # a member, 2 for each of the 21 (v_f v_g) w less the 6 v_f w's one
    # each: 48) and their 28 adds, the projection (6 products and fused
    # multiply-adds, the subtract, the compare); per cluster the power
    # iterations (~400 operations); the leaves' 7 columns and sums
    n_bytes = sum(n * 4 * 2 * ck.BISECT_M + 12 * s_.shape[0]
                  for _, s_, _ in inputs)
    n_ops = sum(n * 84.0 + 400.0 * (s_.shape[0] - 1) for _, s_, _ in inputs)
    bound = _bound(n_bytes, n_ops + 7.0 * n)
    chain = _bisect_chain_ms(longest)
    print(f"bisect_round: largest cluster by round {longest[:-1]}, largest "
          f"leaf {longest[-1]}: the chain of adds bounds the rounds at "
          f"{chain:.4f} ms (bytes / operations: {bound[0]:.4f} ms, "
          f"{bound[1]})")
    measure("bisect_round", f"{rounds} rounds, N{n} C{c}",
            lambda: run_rounds(ck.bisect_round),
            lambda: run_rounds(ck.bisect_round_reference), 0.0, bound,
            chain_ms=chain)
    by_round = [_device_ms(torch, lambda a=a_: ck.bisect_round(
        a[0], a[1], last=a[2])) for a_ in inputs]
    print("bisect_round device ms by round: "
          + ", ".join(f"{t:.4f}" for t in by_round))

    # bisecting_init alone, as the frontend calls it: its launches, its
    # operators (no sort or segment reduction in the rounds) and its time
    gen = torch.Generator(device=vec6.device)
    init = lambda: ops.bisecting_init(vec6, w, c, generator=gen)  # noqa: E731
    init()
    ck.reset_launch_counts()
    init()
    torch.cuda.synchronize()
    launched = {k: v for k, v in ck.LAUNCHES.items() if v}
    if launched != {"bisect_rows": 1, "bisect_round": rounds}:
        raise AssertionError(f"bisecting_init launched {launched}")
    leaves_only = lambda: ops.bisect_leaves(vec6, w, c)  # noqa: E731
    leaves_only()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        leaves_only()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kernels = sum(e.count for e in avgs if e.device_type == cuda_type)
    banned = [e.key for e in avgs if e.device_type != cuda_type and any(
        b in e.key for b in ("sort", "segment_reduce"))]
    if kernels > 1 + rounds or banned:
        raise AssertionError(f"the bisecting rounds ran {kernels} device "
                             f"kernels and {banned}")
    print(f"bisecting_init: {sum(launched.values())} launches "
          f"({launched}); the rounds alone {kernels} device kernels, no sort "
          f"or segment reduction; call {_time_ms(init, torch):.4f} ms, "
          f"device {_device_ms(torch, init):.4f} ms (rounds alone "
          f"{_device_ms(torch, leaves_only):.4f} ms)")


def phase_kernels(torch, blocks, img0):
    """Each kernel against its plain version at the paths' shapes. Returns
    per kernel the max abs error, the times of its first shape (the ETC1S
    main path's, or K 16 for `palette_errs`) and every shape's row."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    px = torch.as_tensor(blocks, dtype=torch.float32, device=dev).contiguous()
    b_n = px.shape[0]
    results = {}

    def measure(name, label, run, plain, err, bound, library=None,
                chain_ms=None):
        ms = _time_ms(run, torch)
        dms = _device_ms(torch, run)
        pms = _time_ms(plain, torch, reps=5)
        lms = None if library is None else _time_ms(library, torch, reps=5)
        ldms = None if library is None else _device_ms(torch, library)
        bound_ms, bound_by = bound
        row = dict(shape=label, max_abs_err=err, ms=ms, device_ms=dms,
                   plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lms, library_device_ms=ldms)
        chain_txt = ""
        if chain_ms is not None:
            row["chain_bound_ms"] = chain_ms
            chain_txt = f"; chain of adds {chain_ms:.4f} ms"
        lib_txt = "none" if lms is None else \
            f"{lms:.4f} ms (device {ldms:.4f} ms)"
        print(f"{name} {label}: B={b_n} max_abs_err={err:.4g} "
              f"kernel {ms:.4f} ms (device {dms:.4f} ms), plain {pms:.4f} ms"
              f", library {lib_txt}, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / dms:.0f}% of device){chain_txt}")
        res = results.setdefault(name, dict(row, by_shape=[]))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["by_shape"].append(row)

    # -- factorized_scan, the gray-axis sums of the refine's cluster scan:
    #    radius 1 (216 columns) against per-block cluster bases, the main
    #    path's shape; radius 2 (1,000 columns, effort 6 and up) and the
    #    perceptual variant: the plain version's bits (whole-numbered pixels
    #    in RGB; the perceptual metric's XLA order spelled out in both)
    base5 = torch.as_tensor(rng.integers(0, 32, (b_n, 3)), dtype=torch.float32,
                            device=dev)
    for label, kw in (("D27 cluster base", dict(radius=1, base5=base5)),
                      ("D125 cluster base", dict(radius=2, base5=base5)),
                      ("D27 cluster base perceptual",
                       dict(radius=1, base5=base5, perceptual=True))):
        got = ck.factorized_scan(px, **kw)
        want = ck.factorized_scan_reference(px, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"factorized_scan {label}: "
                                 f"{int((got != want).sum())} values differ "
                                 "from the plain version's")
        err = 0.0
        measure("factorized_scan", label,
                lambda: ck.factorized_scan(px, **kw),
                lambda: ck.factorized_scan_reference(px, **kw), err,
                _scan_bound(b_n, got.shape[1], "base5" in kw))

    # -- the segment sum of optimize_cluster_endpoints gathers whole rows of
    #    the cluster-base scan (`data[order]`): device times from the
    #    row-major (B, 216) result, and from the transposed view of a
    #    (216, B) buffer
    ids = torch.as_tensor(rng.integers(0, 2416, b_n), device=dev)
    order = torch.sort(ids, stable=True).indices
    by_row = ck.factorized_scan(px, base5=base5, radius=1)
    by_col = by_row.t().contiguous().t()
    dev_ms = [_device_ms(torch, f) for f in (
        lambda: by_row[order], lambda: by_col[order],
        lambda: ops.segment_sum(by_row, ids, 2416),
        lambda: ops.segment_sum(by_col, ids, 2416))]
    print("segment_sum of the D27 cluster-base scan, row-major vs transposed"
          f" (device ms): gather {dev_ms[0]:.4f} vs {dev_ms[1]:.4f}, whole "
          f"sum {dev_ms[2]:.4f} vs {dev_ms[3]:.4f}")
    del by_row, by_col

    # -- cluster_scan_assemble on the inputs the paths give it: ETC1S image
    #    0's own call (C 2,416, D 27), and `optimize_cluster_endpoints` of
    #    image 0's blocks at radius 2 (D 125) and with the perceptual
    #    metric; the plain version's bits (on the CPU, and timed on the
    #    card, where it is the XLA-order composition the kernel replaced)
    cluster_scan_phase(torch, ck, ops, px, ids, img0, measure)

    # -- factorized_scan_shortlist at the shapes of encode_blocks (radius 1;
    #    radius 2 at effort 6 and up; the perceptual metric; radius 0, the
    #    UASTC hint): equal to `_shortlist` of the plain errors, bit for bit
    #    (whole-numbered pixels in RGB: the plain errors are exact, as the
    #    kernel's are; with the perceptual metric both round in XLA's order)
    for label, kw in (("D27", dict(radius=1)), ("D125", dict(radius=2)),
                      ("D27 perceptual", dict(radius=1, perceptual=True)),
                      ("D1", dict(radius=0))):
        got = ck.factorized_scan_shortlist(px, **kw)
        k = got.shape[1]
        flat = ck.factorized_scan_errors_reference(px, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ops._shortlist(flat, k)):
            raise AssertionError(f"factorized_scan_shortlist {label}: differs "
                                 "from the plain errors' shortlist")
        err = _shortlist_close(torch, got, ops._shortlist(flat, k), flat,
                               scan_term_magnitude(px, **kw),
                               f"factorized_scan_shortlist {label}")
        measure("factorized_scan_shortlist", label,
                lambda: ck.factorized_scan_shortlist(px, **kw),
                lambda: ck.factorized_scan_shortlist_reference(px, **kw), err,
                _scan_bound(b_n, flat.shape[1], False, k))
        del flat

    # -- palette_errs_packed: K = 16 packed candidates, plain and perceptual;
    #    K = 8 (the UASTC hint's rescore)
    c5 = rng.integers(0, 32, (b_n, 16, 3))
    tt = rng.integers(0, 8, (b_n, 16))
    packed = torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
                             | (tt << 15), dtype=torch.int32, device=dev)
    for label, pk, perceptual in (("K16", packed, False),
                                  ("K16 perceptual", packed, True),
                                  ("K8", packed[:, :8].contiguous(), False)):
        got = ck.palette_errs_packed(px, pk, perceptual=perceptual)
        want = ck.palette_errs_packed_reference(px, pk, perceptual=perceptual)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"palette_errs_packed {label}: "
                                 f"{int((got != want).sum())} errors differ "
                                 "from the plain version's")
        err = 0.0
        measure("palette_errs_packed", label,
                lambda: ck.palette_errs_packed(px, pk, perceptual=perceptual),
                lambda: ck.palette_errs_packed_reference(
                    px, pk, perceptual=perceptual), err,
                _rescore_bound(b_n, pk.shape[1], perceptual, 4))

    # -- palette_errs: the same K = 16 candidates as explicit palettes
    #    (integer values: bit-exact), and pixels and palettes perceptually
    #    transformed (rtol 1e-5)
    tabs = torch.as_tensor(ck.ETC1_INTEN_TABLES, dtype=torch.float32,
                           device=dev)
    pal = torch.clamp(
        ops.expand5(torch.as_tensor(c5, dtype=torch.int32, device=dev)).float()
        [:, :, None, :] + tabs[torch.as_tensor(tt, device=dev)][..., None],
        0.0, 255.0).contiguous()                                # (B,16,4,3)
    for label, x, pl in (("K16", px, pal),
                         ("K16 perceptual", ops.perceptual_transform(px),
                          ops.perceptual_transform(pal).contiguous())):
        got = ck.palette_errs(x, pl)
        want = ck.palette_errs_reference(x, pl)
        torch.cuda.synchronize()
        if label == "K16" and not torch.equal(got, want):
            raise AssertionError("palette_errs K16: integer palettes must "
                                 "agree bit for bit")
        err = _close(got, want, 0.0, f"palette_errs {label}")
        measure("palette_errs", label, lambda: ck.palette_errs(x, pl),
                lambda: ck.palette_errs_reference(x, pl), err,
                _rescore_bound(b_n, pl.shape[1], False, 48))

    # -- find_best_selector_patterns: distances to each block's own
    #    encode_blocks palette, S = 2,731 patterns (the main path's) and
    #    16,128 (MAX_SELECTOR_CLUSTERS). The library call is the plain
    #    version's product and min on prepared operands: one float32 matmul
    #    of the bf16-rounded distances by the (64, S) one-hot, then min.
    enc = ops.encode_blocks(px, radius=1)
    pal = torch.clamp(
        ops.expand5(enc["color5"]).float()[:, None, :]
        + tabs[enc["inten"].long()][:, :, None], 0.0, 255.0)
    dists = ops.block_selector_distances(px, pal).contiguous()
    d_bf = dists.reshape(b_n, 64).to(torch.bfloat16).float()
    for n_pat in SEL_S:
        pats = torch.as_tensor(rng.integers(0, 4, (n_pat, 16)),
                               dtype=torch.int32, device=dev)
        best, val = ck.find_best_selector_patterns(dists, pats, n_pat)
        again = ck.find_best_selector_patterns(dists, pats, n_pat)
        best_p, val_p = ck.find_best_selector_patterns_reference(dists, pats,
                                                                 n_pat)
        torch.cuda.synchronize()
        if not (torch.equal(again[0], best) and torch.equal(again[1], val)):
            raise AssertionError("find_best_selector_patterns: two calls on "
                                 "the same input differ")
        err = _close(val, val_p, 0.0,
                     f"find_best_selector_patterns S{n_pat} min_err")
        # an index may differ only where the two patterns' errors tie
        onehot_t = torch.nn.functional.one_hot(pats.long(), 4).reshape(
            n_pat, 64).float().T.contiguous()
        err_of_best = (d_bf * onehot_t.T[best.long()]).sum(-1)
        differ = best != best_p
        if not torch.all(~differ | ((err_of_best - val_p).abs()
                                    <= RTOL * val_p.abs())):
            raise AssertionError("find_best_selector_patterns: index differs "
                                 "without a tie")
        print(f"find_best_selector_patterns S{n_pat}: index ties "
              f"{int(differ.sum())}/{b_n}")
        measure("find_best_selector_patterns", f"S{n_pat}",
                lambda: ck.find_best_selector_patterns(dists, pats, n_pat),
                lambda: ck.find_best_selector_patterns_reference(dists, pats,
                                                                 n_pat), err,
                _selector_bound(b_n, n_pat),
                library=lambda: torch.min(d_bf @ onehot_t, dim=-1))
        del best_p, val_p
    print(f"ptxas selbest_wgmma_kernel: {_selector_resources()}")

    # -- cross6_argmin / cross6_distances at the main path's shapes: the
    #    24,576 blocks' 6-D endpoint vectors against 2,416 centroids drawn
    #    from them, the squared norms and (the k-means form, >= 1024
    #    clusters) the bf16 operands inside the kernels, as the frontend
    #    calls them; the plain version's bits, every index and every
    #    distance. The library call for the distances is one addmm on
    #    prepared operands (the row and column terms added beforehand).
    from basis_universal_tpu_torch.ops.xla_order import _dot

    vec6 = torch.cat([enc["low"], enc["high"]], -1) * (1.0 / 255.0)
    cents = vec6[torch.as_tensor(rng.choice(b_n, 2416, replace=False),
                                 device=dev)].contiguous()
    got = ck.cross6_argmin(vec6, cents)
    want = ck.cross6_argmin_reference(vec6, cents)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"cross6_argmin: {int((got != want).sum())} of "
                             f"{b_n} indices differ from the plain version")
    measure("cross6_argmin", "N24576 C2416 bf16",
            lambda: ck.cross6_argmin(vec6, cents),
            lambda: ck.cross6_argmin_reference(vec6, cents), 0.0,
            _cross6_bound(b_n, 2416, False))
    got = ck.cross6_distances(vec6, cents)
    want = ck.cross6_distances_reference(vec6, cents)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"cross6_distances: {int((got != want).sum())} "
                             "distances differ from the plain version")
    del got, want
    r, q = _dot(vec6, vec6), _dot(cents, cents)
    bias = r[:, None] + q[None, :]
    measure("cross6_distances", "N24576 C2416",
            lambda: ck.cross6_distances(vec6, cents),
            lambda: ck.cross6_distances_reference(vec6, cents), 0.0,
            _cross6_bound(b_n, 2416, True),
            library=lambda: torch.addmm(bias, vec6, cents.T, alpha=-2.0))

    # -- xla_cpu_min_k on those distances (24,576 x 2,416, whole-numbered
    #    centroid components, so most rows tie among their 17 smallest, as
    #    on the main path): the columns of std::sort on the host, bit for
    #    bit, every row; the sort stopped after each step (`min_k_split`).
    #    No PyTorch call orders ties so; torch.topk, which takes the same 16
    #    values in another order, is timed beside.
    d6 = ck.cross6_distances(vec6, cents)
    d6_host = d6.cpu()
    stv = torch.sort(d6_host, dim=-1, stable=True).values
    tied = int((stv[:, 1:17] == stv[:, :16]).any(1).sum())
    del stv
    want = ck.xla_cpu_min_k_reference(d6_host, 16, mode="std_sort")
    visits = torch.zeros(b_n, dtype=torch.int64)
    ck.xla_cpu_min_k_reference(d6_host, 16, visits=visits)
    got = ck.xla_cpu_min_k(d6, 16).cpu()
    if not torch.equal(got, want):
        raise AssertionError(
            f"xla_cpu_min_k: {int((got != want).any(1).sum())} of {b_n} rows "
            "differ from std::sort on the host")
    print("xla_cpu_min_k: every row std::sort's; host "
          f"{_host_us(torch, lambda: ck.xla_cpu_min_k(d6, 16)):.1f} us per "
          "call (the wrapper and the launch)")
    min_k_split(torch, ck, d6)
    topk = lambda: torch.topk(d6, 16, largest=False)  # noqa: E731
    print(f"xla_cpu_min_k: {tied} of {b_n} rows tie among their 17 smallest;"
          f" the partitions visit {int(visits.sum())} entries "
          f"({float(visits.sum()) / d6.numel():.3f} per entry of the row); "
          f"torch.topk of the same 16 (another tie order) "
          f"{_time_ms(topk, torch, reps=5):.4f} ms, device "
          f"{_device_ms(torch, topk):.4f} ms")
    # bound: the distances read once and the columns written; one compare
    # per entry each partition visits (counted on the host for these rows)
    measure("xla_cpu_min_k", "N24576 C2416 k16",
            lambda: ck.xla_cpu_min_k(d6, 16),
            lambda: ck.xla_cpu_min_k_reference(d6_host, 16), 0.0,
            _bound(d6.numel() * 4 + b_n * 16 * 8, float(visits.sum())))
    del d6, d6_host, got, want

    # -- the bisecting init on image 0's endpoint vectors (the main path's
    #    input: 24,576 rows, C 2,416, 12 rounds): `bisect_rows` and each
    #    `bisect_round` against the plain version on the same rows, bit for
    #    bit (rows, offsets, leaves); the rounds' time in all and by round;
    #    `bisecting_init` alone (launches and the profiler's operators)
    bisect_phase(torch, ck, ops, vec6, measure)

    # -- the XLA-order kernels at the ETC1S path's own shapes (each distinct
    #    call of one encode of image 0; the first is these kernels' row in
    #    the kernels line), then at a UASTC line fit's
    etc1s_xla_phase(torch, img0, measure)

    # -- the XLA-order kernels at a UASTC line fit's shapes (24,576 blocks x
    #    16 pixels x 3 channels): a fused multiply-add with a broadcast and a
    #    scalar operand, and the 16-term fma chain of P = sum_i a_i v_i
    #    (`_dot` over the pixels); the plain versions (each fused
    #    multiply-add emulated through float64 and rounded once) on the same
    #    card tensors; the library calls are one addcmul and one einsum.
    #    Every value must be the plain version's.
    from basis_universal_tpu_torch.ops import xla_order as xo

    v = px
    w = torch.as_tensor(rng.uniform(0, 1, (b_n, 16, 1)), dtype=torch.float32,
                        device=dev)
    m = v.mean(1, keepdim=True)
    # what any kernel takes at this size: PyTorch's copy of v (its bytes
    # read and written, about xla_fma's traffic), on the device
    copy_dms = _device_ms(torch, lambda: v.clone())
    print(f"copy of v ({v.numel() * 4} B read and written): device "
          f"{copy_dms:.4f} ms, bound "
          f"{_bound(8 * v.numel(), 0)[0]:.4f} ms")
    for name, label, run, plain, lib, bound in (
            ("xla_fma", "B24576x16x3 broadcast+scalar",
             lambda: xo._fma(v, 257.0, m),
             lambda: xo.fma_reference(v, 257.0, m),
             lambda: torch.addcmul(m, v, torch.tensor(257.0, device=dev)),
             _bound(4 * (v.numel() * 2 + m.numel()), float(v.numel()))),
            ("xla_reduce", "dot K16 B24576x3",
             lambda: xo._dot(w, v, 1),
             lambda: xo.reduce_reference(w, v, 1, "dot"),
             lambda: torch.einsum("bik,bic->bc", w, v),
             _bound(4 * (v.numel() + w.numel() + b_n * 3),
                    float(v.numel())))):
        got, want = run(), plain()
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        if n_diff:
            raise AssertionError(f"{name}: {n_diff} of {got.numel()} values "
                                 "differ from the plain version")
        print(f"{name} {label}: every one of {got.numel()} values the plain "
              "version's")
        measure(name, label, run, plain, float((got - want).abs().max()),
                bound, library=lib)

    # -- the UASTC search's line fits at every shape of the effort-2 and
    #    effort-3 searches (24,576 blocks: image 0's pixels, random alpha):
    #    `uastc_line_fit` on a strided view of the pixels with labels of
    #    the modes' own partitions, and `uastc_mode_trial`; their plain
    #    versions are the Python compositions of `_dot`, `_sum`, `_sqrt` and
    #    `_fma`, which on the card launch the generic kernels, whose bits
    #    they must give, every value. No one PyTorch call computes either.
    uastc_line_fits(torch, px, rng, measure)

    # -- the UASTC search's multi-subset and dual-plane mode trials, one
    #    launch each, at each mode of the effort-2 RGB and RGBA searches and
    #    effort 3's modes 7 and 3, at 24,576 blocks and at a ragged count;
    #    every output the plain version's (`uastc_trials`)
    uastc_trials(torch, px, rng, measure)

    # -- the UASTC block packing at 24,576 blocks: image 0's own winner
    #    buffer and buffers drawn so that every slot of each slot list wins
    #    blocks, each the plain version's bytes (`uastc_pack_phase`)
    uastc_pack_phase(torch, px, rng, measure)
    return results


def _pack_ops(compact, tables):
    """Instructions `uastc_pack` spends on the buffer: per field written 5
    (mask, shift, or, the offset's add and the 64-bit crossing's compare),
    per weight 2 more (its flip), and the solid colour's LUT search, 32
    combinations x 9 (three loads, three multiply-adds, a compare, a select
    and the loop)."""
    from basis_universal_tpu_torch.codecs.uastc import pack

    tab = tables.cpu().numpy().astype(np.int64)
    n_slots, slots_ofs = int(tab[0]), int(tab[1])
    counts = np.bincount(compact[:, 0].cpu().numpy(), minlength=256)
    ops = 0
    for slot in range(n_slots):
        r = tab[slots_ofs + slot * pack.SLOT_WORDS:][:pack.SLOT_WORDS]
        if r[pack.S_KIND] == pack.KIND_SOLID:
            fields, extra = 11, 32 * 9
        else:
            n_values = r[pack.S_SUBSETS] * r[pack.S_COMPS] * 2
            n_weights = 32 if r[pack.S_KIND] == pack.KIND_DUAL else 16
            bundle = 5 if r[pack.S_TRITS] else 3 if r[pack.S_QUINTS] else 0
            # the code, 9 hint and aux fields, the bundles, the raw bits
            fields = (1 + 9 + (-(-n_values // bundle) if bundle else 0)
                      + n_values + n_weights)
            extra = 2 * n_weights
        ops += int(counts[slot]) * (5 * fields + extra)
    return float(ops)


PACK_SIZES = (24576, 4096, 1001)      # the last RAGGED_BLOCKS
PACK_STEPS = ("staging, the code and the store",
              "the header and the solid blocks", "the anchor flips",
              "the endpoints", "the weights")


def pack_split(torch, compact, alpha0, tabs, label):
    """The device ms of each stop point of `uastc_pack_split` on the buffer
    (the kernel up to that step, with the lanes a block that `uastc_pack`
    takes at its size; the last the whole kernel) and each step's
    share as the difference from the stop before it, printed; returns the
    cumulative times."""
    from basis_universal_tpu_torch.ops import _build

    lib = _build.get_lib("uastc_pack_kernels")
    n = compact.shape[0]
    out = torch.empty((n, 16), dtype=torch.uint8, device=compact.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run(stop):
        status = lib.uastc_pack_split(
            compact.data_ptr(), alpha0.data_ptr(), tabs.data_ptr(),
            tabs.numel(), out.data_ptr(), n, stop, 0, stream)
        if status != 0:
            raise RuntimeError(f"uastc_pack_split stop {stop}: status "
                               f"{status}")

    cum = [_device_ms(torch, lambda stop=stop: run(stop))
           for stop in range(1, len(PACK_STEPS) + 1)]
    steps = ", ".join(f"{step} {b - a:+.4f}" for step, a, b in
                      zip(PACK_STEPS, [0.0] + cum, cum))
    print(f"uastc_pack {label} split at {n} blocks, device ms by step: "
          f"{steps} (cumulative {', '.join(f'{c:.4f}' for c in cum)})")
    return cum


def uastc_pack_phase(torch, px, rng, measure):
    """`uastc_pack` at 24,576 blocks, each call held to `pack_reference`
    byte for byte: image 0's own winner buffer (the effort-2 RGB search of
    its pixels, the main path's input), also held to the numpy packer; for
    each slot list of efforts 1-4, RGB and RGBA, a buffer drawn so that
    every slot wins blocks (`testing.synthetic.uastc_winner_buffer`); the
    effort-4 RGBA one also with its rows sorted by slot (no warp spans two
    slots but at the boundaries: the divergence's cost). Timed: image 0's
    at 24,576 blocks and its first 4,096 and 1,001 rows (each size split by
    step, `pack_split`), the drawn effort-4 RGBA and its sorted rows.
    Bound: the bytes the function moves (the buffer, pixel 0's alpha as
    int32, the tables once, the blocks) against `_pack_ops`."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc
    from basis_universal_tpu_torch.codecs.uastc import pack
    from basis_universal_tpu_torch.testing.synthetic import \
        uastc_winner_buffer

    dev = px.device
    b_n = px.shape[0]
    rgba = torch.cat([px, torch.full_like(px[..., :1], 255.0)], -1)
    modes, ls, extra, topk = pack._effort_mode_set(UASTC_EFFORT, False)
    cases = [("image 0 effort 2 RGB",
              uenc._search_device(rgba, modes, ls, extra, topk), modes, extra,
              rgba[:, 0, 3].to(torch.int32), True)]
    for effort in (1, 2, 3, 4):
        for alpha in (False, True):
            m, _, x, _ = pack._effort_mode_set(effort, alpha)
            compact = torch.as_tensor(uastc_winner_buffer(
                m, x, b_n, seed=int(rng.integers(1 << 30))), device=dev)
            last = (effort, alpha) == (4, True)
            cases.append((f"drawn effort {effort} {'RGBA' if alpha else 'RGB'}",
                          compact, m, x, torch.as_tensor(
                              rng.integers(0, 256, b_n), dtype=torch.int32,
                              device=dev), last))
            if last:
                order = torch.sort(compact[:, 0].long(), stable=True).indices
                cases.append((f"drawn effort {effort} RGBA, rows by slot",
                              compact[order].contiguous(), m, x,
                              cases[-1][4][order].contiguous(), True))
    for label, compact, m, x, alpha0, timed in cases:
        tabs = pack.pack_tables(m, x, dev)
        got = pack.uastc_pack(compact, alpha0, tabs)
        want = pack.pack_reference(compact, alpha0, tabs)
        torch.cuda.synchronize()
        n_slots = len(m) + 1 + len(x)
        won = int((torch.unique(compact[:, 0]) < n_slots).sum())
        if not torch.equal(got, want):
            raise AssertionError(
                f"uastc_pack {label}: {int((got != want).any(1).sum())} of "
                f"{b_n} blocks differ from the plain version")
        if label.startswith("image 0"):
            image0 = (compact, alpha0, tabs)
            px_np = np.zeros((b_n, 16, 4), np.float32)
            px_np[:, 0, 3] = alpha0.cpu().numpy()
            if not np.array_equal(got.cpu().numpy(), pack._pack_from_compact(
                    compact.cpu().numpy(), px_np, m, x)):
                raise AssertionError(f"uastc_pack {label}: not the numpy "
                                     "packer's bytes")
        print(f"uastc_pack {label}: {won} of {n_slots} slots win blocks; "
              f"every block the plain version's")
        if timed:
            n_bytes = b_n * (59 + 4 + 16) + 4 * tabs.numel()
            measure("uastc_pack", label,
                    lambda: pack.uastc_pack(compact, alpha0, tabs),
                    lambda: pack.pack_reference(compact, alpha0, tabs), 0.0,
                    _bound(n_bytes, _pack_ops(compact, tabs)))
    # image 0's buffer at the three sizes: the smaller ones timed too, each
    # split by step
    compact0, alpha00, tabs0 = image0
    for n in PACK_SIZES:
        c, a = compact0[:n].contiguous(), alpha00[:n].contiguous()
        label = f"image 0 effort 2 RGB, {n} blocks"
        if n != b_n:
            got = pack.uastc_pack(c, a, tabs0)
            if not torch.equal(got, pack.pack_reference(c, a, tabs0)):
                raise AssertionError(f"uastc_pack {label}: differs from the "
                                     "plain version")
            measure("uastc_pack", label,
                    lambda c=c, a=a: pack.uastc_pack(c, a, tabs0),
                    lambda c=c, a=a: pack.pack_reference(c, a, tabs0), 0.0,
                    _bound(n * (59 + 4 + 16) + 4 * tabs0.numel(),
                           _pack_ops(c, tabs0)))
        pack_split(torch, c, a, tabs0, label)


def pack_ab(torch, px, other_pack):
    """`uastc_pack` of this tree and of another (`other_pack`, its
    `codecs.uastc.pack`) on image 0's winner buffer at `PACK_SIZES`: the
    same bytes, call and device ms in turns (other, this, this, other)."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc
    from basis_universal_tpu_torch.codecs.uastc import pack

    rgba = torch.cat([px, torch.full_like(px[..., :1], 255.0)], -1)
    modes, ls, extra, topk = pack._effort_mode_set(UASTC_EFFORT, False)
    compact = uenc._search_device(rgba, modes, ls, extra, topk)
    alpha0 = rgba[:, 0, 3].to(torch.int32)
    tabs = pack.pack_tables(modes, extra, px.device)
    for n in PACK_SIZES:
        c, a = compact[:n].contiguous(), alpha0[:n].contiguous()
        mine, theirs = pack.uastc_pack(c, a, tabs), other_pack.uastc_pack(
            c, a, tabs)
        torch.cuda.synchronize()
        n_diff = int((mine != theirs).any(1).sum())
        runs = [lambda m=m, c=c, a=a: m.uastc_pack(c, a, tabs)
                for m in (other_pack, pack, pack, other_pack)]
        t = [_time_ms(r, torch) for r in runs]
        dt = [_device_ms(torch, r) for r in runs]
        print(f"ab uastc_pack image 0 effort 2 RGB, {n} blocks: same bytes "
              f"{n_diff == 0} ({n_diff} of {n} blocks differ); call ms other "
              f"{t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, other "
              f"{t[3]:.4f}; device ms other {dt[0]:.4f}, this {dt[1]:.4f}, "
              f"this {dt[2]:.4f}, other {dt[3]:.4f}")
        if n_diff:
            raise AssertionError(f"ab uastc_pack {n} blocks: the two trees "
                                 "differ")


def _line_fit_ops(n_ch, n_sub, n_lev, ls_iters, iters=4, per_level=None):
    """Instructions per 4x4 block of one line fit of n_sub subsets (an add,
    multiply, fused multiply-add, compare, select, divide, root or floor
    each one). A pixel adds nothing to another subset's result (its mask
    there is 0), so what is per pixel counts once per block, for the
    pixel's own subset: the mean's terms (16 C), the centring (16 C), the
    covariance (16 C^2 fused multiply-adds), the projections (16 C) and the
    extremes (2 x 16); per weight search (1 + ls_iters) each pixel's search
    (per_level a level, by default 3 C + 1) and the error (16); per
    least-squares step the
    weights (16 x 2), their moments (16 x 6) and the P and Q chains (2 C x
    16). Per subset: the mean's C divides, the power iteration (per round
    C^2 + C products, C - 1 adds, a root, an add, C divides), the endpoints
    (3 C), per weight search the reconstruction (5 per level and channel),
    per least-squares step the solve (3 + 10 C) and the select (2 C + 2)."""
    searches = 1 + ls_iters
    if per_level is None:
        per_level = 3 * n_ch + 1
    per_block = (16 * n_ch * 3 + 16 * n_ch * n_ch + 32
                 + searches * (16 * n_lev * per_level + 16)
                 + ls_iters * (16 * 2 + 16 * 6 + 32 * n_ch))
    per_subset = (n_ch + iters * (n_ch * n_ch + 3 * n_ch + 1) + 3 * n_ch
                  + searches * 5 * n_lev * n_ch
                  + ls_iters * (3 + 10 * n_ch + 2 * n_ch + 2))
    return per_block + n_sub * per_subset


def _mode_trial_ops(comps, n_lev, ls_iters):
    """Instructions per 4x4 block of one mode trial: the line fit of
    `_line_fit_ops` of one subset with 6 power iterations, its search at
    the cheaper of the two forms a level (RGB and RGBA, whose errors are
    whole numbers: 4, a load, a dot product of bytes, a multiply-add and a
    minimum; LA: 3 C + 1), and per quantised endpoint pair 12 C (round,
    clip, convert, two table reads), the reconstruction at 7 per level and
    channel instead of 5, the luma (16 x 3) of LA and the full-pixel error
    (16 x 3; LA 16 x 25)."""
    ops = _line_fit_ops(comps, 1, n_lev, ls_iters, iters=6,
                        per_level=3 * comps + 1 if comps == 2 else 4)
    ops += (1 + ls_iters) * (12 * comps + 2 * n_lev * comps)
    return ops + {2: 16 * 3 + 16 * 25, 3: 16 * 3, 4: 0}[comps]


def _subset_trial_ops(comps, n_sub, n_lev, ls_iters, topk, n_pat):
    """Instructions per 4x4 block of one multi-subset trial, counted as
    `_line_fit_ops` counts: the luma (16 x 3) and its extremes (2 x 16);
    the ideal split, per 2-means round each pixel's side (5: two
    subtracts, two absolutes, a compare; 4 rounds with the final split)
    and per centre a chain of 16 adds and a divide (3 rounds x 2), or the
    3-means' first centre (17), 3 rounds of each pixel's label (8) and 2
    of 3 centres (17 each); per pattern its score (S 2: 3; S 3: 9 masked
    counts and 6 sums, 30) and its rank (n_pat compares); per candidate
    the fits of its subsets (`_line_fit_ops`), the codes (12 C a subset),
    the reconstruction at each level of each subset (7 C), each pixel's
    search (3 C + 1 a level) and the error (16); RGB adds the alpha's error
    (16 x 3), LA the winner's full-pixel error (16 x 19 and 64 adds)."""
    split = 16 * 3 + 32
    if n_sub == 2:
        split += 4 * 16 * 5 + 3 * 2 * 17
    else:
        split += 17 + 3 * 16 * 8 + 2 * 3 * 17
    scores = n_pat * ((3 if n_sub == 2 else 30) + n_pat)
    per_cand = (_line_fit_ops(comps, n_sub, n_lev, ls_iters)
                + n_sub * (12 * comps + 7 * n_lev * comps)
                + 16 * n_lev * (3 * comps + 1) + 16)
    tail = {2: 16 * 19 + 64, 3: 16 * 3, 4: 0}[comps]
    return split + scores + topk * per_cand + tail


def _dualplane_trial_ops(n_ch, n_lev, ls_iters):
    """Instructions per 4x4 block of one dual-plane trial, counted as
    `_line_fit_ops` counts: per ccs (n_ch of them) the plane-0 fit over the
    other channels and the plane-1 fit (one subset each), the codes (12 a
    channel), the reconstruction (7 a level and channel), each pixel's two
    searches (3 a channel and 2 compares a level) and the two errors (32);
    mode 6 adds the alpha's error (16 x 3). LA (n_ch 2): the luma (16 x 3),
    the luma and alpha fits, their codes, the reconstruction, and the
    searches against R, G, B and alpha (14 a level)."""
    fit1 = _line_fit_ops(1, 1, n_lev, ls_iters)
    if n_ch == 2:
        return (48 + 2 * fit1 + 24 + 14 * n_lev + 16 * n_lev * 14 + 32)
    per_ccs = (_line_fit_ops(n_ch - 1, 1, n_lev, ls_iters) + fit1
               + 12 * n_ch + 7 * n_lev * n_ch + 16 * n_lev * (3 * n_ch + 2)
               + 32)
    return n_ch * per_ccs + (48 if n_ch == 3 else 0)


# The trials phase 3 holds: (label, weight bits, endpoint range, comps,
# subsets, pattern list, top-k, least-squares steps) of the 2- and 3-subset
# modes, the effort-2 RGB search's first (modes 2, 4), then the RGBA
# search's (9; 16 at effort 4), effort 3's mode 7 (top-k 8) and mode 3
# (its own top-k 2, 2 steps); (label, weight bits, endpoint range,
# channels, steps) of the dual-plane modes 6, then 11, 13 and 17
SUBSET_TRIALS = (("mode 2", 3, 8, 3, 2, 2, 4, 1),
                 ("mode 4", 2, 12, 3, 2, 2, 4, 1),
                 ("mode 9", 2, 8, 4, 2, 2, 4, 1),
                 ("mode 16", 2, 20, 2, 2, 2, 4, 1),
                 ("mode 7 effort 3", 2, 12, 3, 2, 7, 8, 2),
                 ("mode 3 effort 3", 2, 7, 3, 3, 3, 2, 2))
DUALPLANE_TRIALS = (("mode 6", 2, 18, 3, 1), ("mode 11", 2, 13, 4, 1),
                    ("mode 13", 1, 20, 4, 1), ("mode 17", 2, 20, 2, 1))
RAGGED_BLOCKS = 1001
# the trials' stop points (`TrialStop` in `csrc/xla_order_kernels.cu`), each
# the step that a measurement instance runs last
TRIAL_STEPS = ("split and shortlist", "chains", "power iteration",
               "level search", "solves", "winner and error")


def _trial_launcher(torch, uenc, name, args, x):
    """A function of stop (1..6) that launches the measurement entry
    `<name>_split` of the trial `name` at args on x, with the wrapper's
    tables and outputs."""
    from basis_universal_tpu_torch.ops import _build

    lib = _build.get_lib("xla_order_kernels")
    dev, n = x.device, x.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    err = torch.empty(n, dtype=torch.float32, device=dev)
    w = torch.empty((n, 32), dtype=torch.int32, device=dev)
    aux = torch.empty(n, dtype=torch.int32, device=dev)
    if name == "uastc_subset_trial":
        wb, ep_range, comps, ls, n_sub, plist, topk = args
        pats = uenc._patterns(n_sub, plist == 7, str(dev))
        inv, unq, wlev = uenc._mode_consts(wb, ep_range, str(dev))
        ep = torch.empty((n, 2 * n_sub * comps), dtype=torch.int32,
                         device=dev)
        return lambda stop: lib.uastc_subset_trial_split(
            x.data_ptr(), *x.stride(), pats.data_ptr(), len(pats),
            inv.data_ptr(), unq.data_ptr(), unq.numel(), wlev.data_ptr(),
            wlev.numel(), comps, n_sub, ls, topk, err.data_ptr(),
            ep.data_ptr(), w.data_ptr(), aux.data_ptr(), n, stop, stream)
    wb, ep_range, ls, n_ch = args
    inv, unq, wlev = uenc._mode_consts(wb, ep_range, str(dev))
    ep = torch.empty((n, 2 * n_ch), dtype=torch.int32, device=dev)
    return lambda stop: lib.uastc_dualplane_trial_split(
        x.data_ptr(), *x.stride(), inv.data_ptr(), unq.data_ptr(),
        unq.numel(), wlev.data_ptr(), wlev.numel(), n_ch, ls, err.data_ptr(),
        ep.data_ptr(), w.data_ptr(), aux.data_ptr(), n, stop, stream)


def trial_split(torch, uenc, name, label, args, x):
    """The per-step split of one trial on x: the device ms of each stop
    point's measurement instance (the trial up to that step; the last is
    the path's own instance), and each step's share as the difference
    from the stop before it, printed."""
    launch = _trial_launcher(torch, uenc, name, args, x)

    def run(stop):
        status = launch(stop)
        if status != 0:
            raise RuntimeError(f"{name}_split stop {stop}: status {status}")

    cum = [_device_ms(torch, lambda stop=stop: run(stop))
           for stop in range(1, len(TRIAL_STEPS) + 1)]
    steps = ", ".join(f"{step} {b - a:+.4f}" for step, a, b in
                      zip(TRIAL_STEPS, [0.0] + cum, cum))
    print(f"{name} {label} split at {x.shape[0]} blocks, device ms by step: "
          f"{steps} (cumulative {', '.join(f'{c:.4f}' for c in cum)})")


def uastc_trials(torch, px, rng, measure):
    """`uastc_subset_trial` and `uastc_dualplane_trial` at each trial of
    `SUBSET_TRIALS` and `DUALPLANE_TRIALS` on image 0's 24,576 blocks with a
    random alpha and on the first RAGGED_BLOCKS of them (a ragged last
    CTA), every output held to the plain version with torch.equal; timed
    at 24,576. Bound: the pixels in and the outputs out against
    `_subset_trial_ops` / `_dualplane_trial_ops`. No one PyTorch call
    computes either. Each trial's time is split by its steps
    (`trial_split`)."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    dev = px.device
    b_n = px.shape[0]
    rgba = torch.cat([px, torch.as_tensor(rng.integers(0, 256, (b_n, 16, 1)),
                                          dtype=torch.float32, device=dev)],
                     -1).contiguous()
    cases = []
    for label, wb, ep_range, comps, n_sub, plist, topk, ls in SUBSET_TRIALS:
        n_pat = len(uenc._patterns(n_sub, plist == 7, str(dev)))
        cases.append((
            "uastc_subset_trial", f"{label} C{comps} S{n_sub} L{1 << wb} "
            f"top{topk} ls{ls}", uenc.subset_trial,
            uenc.subset_trial_reference,
            (wb, ep_range, comps, ls, n_sub, plist, topk),
            4 * (64 + 1 + 2 * n_sub * comps + 16 + 1),
            _subset_trial_ops(comps, n_sub, 1 << wb, ls, topk, n_pat)))
    for label, wb, ep_range, n_ch, ls in DUALPLANE_TRIALS:
        cases.append((
            "uastc_dualplane_trial", f"{label} N{n_ch} L{1 << wb} ls{ls}",
            uenc.dualplane_trial, uenc.dualplane_trial_reference,
            (wb, ep_range, ls, n_ch),
            4 * (64 + 1 + 2 * n_ch + 32 + (n_ch != 2)),
            _dualplane_trial_ops(n_ch, 1 << wb, ls)))
    for name, label, run, plain, args, block_bytes, ops in cases:
        for n in (b_n, RAGGED_BLOCKS):
            x = rgba[:n]
            got = run(x, *args)
            want = plain(x, *args)
            torch.cuda.synchronize()
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} {label} at {n} blocks: "
                                     "differs from the plain version")
        print(f"{name} {label}: every output the plain version's at {b_n} "
              f"and {RAGGED_BLOCKS} blocks")
        measure(name, label, lambda: run(rgba, *args),
                lambda: plain(rgba, *args), 0.0,
                _bound(b_n * block_bytes, float(b_n * ops)))
        trial_split(torch, uenc, name, label, args, rgba)


def trials_ab(torch, px, rng, other_uenc):
    """This tree's `uastc_subset_trial` / `uastc_dualplane_trial` against
    another tree's (`other_uenc`, its `codecs/uastc/encode.py`) at every
    trial of `SUBSET_TRIALS` / `DUALPLANE_TRIALS`, on the inputs of
    `uastc_trials`, at 24,576 and RAGGED_BLOCKS blocks: every output equal,
    and the device ms of each in turns (other, this, this, other)."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    dev = px.device
    b_n = px.shape[0]
    rgba = torch.cat([px, torch.as_tensor(rng.integers(0, 256, (b_n, 16, 1)),
                                          dtype=torch.float32, device=dev)],
                     -1).contiguous()
    cases = [("uastc_subset_trial", label, "subset_trial",
              (wb, ep_range, comps, ls, n_sub, plist, topk))
             for label, wb, ep_range, comps, n_sub, plist, topk, ls
             in SUBSET_TRIALS]
    cases += [("uastc_dualplane_trial", label, "dualplane_trial",
               (wb, ep_range, ls, n_ch))
              for label, wb, ep_range, n_ch, ls in DUALPLANE_TRIALS]
    for name, label, fn, args in cases:
        for n in (b_n, RAGGED_BLOCKS):
            x = rgba[:n]
            mine = getattr(uenc, fn)(x, *args)
            theirs = getattr(other_uenc, fn)(x, *args)
            torch.cuda.synchronize()
            same = len(mine) == len(theirs) and all(
                torch.equal(a, b) for a, b in zip(mine, theirs))
            runs = [lambda m=m: getattr(m, fn)(x, *args)
                    for m in (other_uenc, uenc, uenc, other_uenc)]
            dt = [_device_ms(torch, r) for r in runs]
            print(f"ab {name} {label} at {n} blocks: same outputs {same}; "
                  f"device ms other {dt[0]:.4f}, this {dt[1]:.4f}, this "
                  f"{dt[2]:.4f}, other {dt[3]:.4f}")
            if not same:
                raise AssertionError(f"ab {name} {label} at {n} blocks: the "
                                     "two trees' outputs differ")


# the mode trial's stop points (`ModeStop` in `csrc/xla_order_kernels.cu`),
# each the step that a measurement instance runs last
MODE_STEPS = ("mean and covariance", "power iteration",
              "endpoints and codes", "tables and level search",
              "least-squares steps", "full-pixel error")


def mode_split(torch, uenc, label, args, x):
    """The per-step split of one mode trial on x: the device ms of each
    stop point's measurement instance (`uastc_mode_trial_split`, the trial
    up to that step, the last the whole trial), and each step's share as
    the difference from the stop before it, printed."""
    from basis_universal_tpu_torch.ops import _build

    lib = _build.get_lib("xla_order_kernels")
    wb, ep_range, comps, ls = args
    dev, n = x.device, x.shape[0]
    inv, unq, wlev = uenc._mode_consts(wb, ep_range, str(dev))
    err = torch.empty(n, dtype=torch.float32, device=dev)
    ep = torch.empty((n, 2 * comps), dtype=torch.int32, device=dev)
    w = torch.empty((n, 16), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(stop):
        status = lib.uastc_mode_trial_split(
            x.data_ptr(), *x.stride(), inv.data_ptr(), unq.data_ptr(),
            unq.numel(), wlev.data_ptr(), wlev.numel(), comps, ls,
            err.data_ptr(), ep.data_ptr(), w.data_ptr(), n, stop, 0, 0,
            stream)
        if status != 0:
            raise RuntimeError(f"uastc_mode_trial_split stop {stop}: "
                               f"status {status}")

    cum = [_device_ms(torch, lambda stop=stop: run(stop))
           for stop in range(1, len(MODE_STEPS) + 1)]
    steps = ", ".join(f"{step} {b - a:+.4f}" for step, a, b in
                      zip(MODE_STEPS, [0.0] + cum, cum))
    print(f"uastc_mode_trial {label} split at {n} blocks, device ms by step: "
          f"{steps} (cumulative {', '.join(f'{c:.4f}' for c in cum)})")


def _mode_cases():
    """(mode, weight bits, endpoint range, comps) of every single-subset
    mode, mode 0 (the effort-2 RGB search's most frequent) first."""
    from basis_universal_tpu_torch.codecs.uastc import pack

    return sorted(pack.ALL_MODES, key=lambda m: (m[3] != 3, m[0] != 0))


def _with_alpha(torch, px, rng):
    """Image 0's blocks (B, 16, 3) with a random alpha, contiguous."""
    b_n = px.shape[0]
    return torch.cat([px, torch.as_tensor(rng.integers(0, 256, (b_n, 16, 1)),
                                          dtype=torch.float32,
                                          device=px.device)],
                     -1).contiguous()


# the launches `mode_trials_ab` holds: image 0's blocks, a 512x512, a
# 512x256 and a 256x256 image's, and RAGGED_BLOCKS (small launches, where
# the launcher gives a warp fewer blocks and their serial chains show)
MODE_AB_BLOCKS = (24576, 16384, 8192, 4096, RAGGED_BLOCKS)


def mode_trials_ab(torch, px, rng, other_uenc):
    """This tree's `uastc_mode_trial` against another tree's
    (`other_uenc`, its `codecs/uastc/encode.py`) at every single-subset
    mode and 1 and 2 least-squares steps, on the first MODE_AB_BLOCKS of
    image 0's blocks: every output equal, and the device ms of each in
    turns (other, this, this, other)."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    rgba = _with_alpha(torch, px, rng)
    for ls in (1, 2):
        for mode, wb, ep_range, comps in _mode_cases():
            args = (wb, ep_range, comps, ls)
            for n in MODE_AB_BLOCKS:
                x = rgba[:n]
                mine = uenc._mode_trial(x, *args)
                theirs = other_uenc._mode_trial(x, *args)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
                runs = [lambda m=m: m._mode_trial(x, *args)
                        for m in (other_uenc, uenc, uenc, other_uenc)]
                dt = [_device_ms(torch, r) for r in runs]
                print(f"ab uastc_mode_trial mode {mode} comps {comps} "
                      f"L{1 << wb} ls{ls} at {n} blocks: same outputs "
                      f"{same}; device ms other {dt[0]:.4f}, this "
                      f"{dt[1]:.4f}, this {dt[2]:.4f}, other {dt[3]:.4f}")
                if not same:
                    raise AssertionError(f"ab uastc_mode_trial mode {mode} "
                                         f"ls{ls} at {n} blocks: the two "
                                         "trees' outputs differ")


def uastc_line_fits(torch, px, rng, measure, split=True):
    """`uastc_line_fit` at the (C, S, weight bits, least-squares steps) and
    `uastc_mode_trial` at the (comps, weight bits, steps) of every
    single-subset mode (the first of each is the effort-2 RGB search's
    most frequent), each against its plain version bit for bit; the mode
    trials at 24,576 and RAGGED_BLOCKS blocks, timed at 24,576, and with
    `split` each mode's one-step trial split by its steps
    (`mode_split`)."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    dev = px.device
    b_n = px.shape[0]
    rgba = _with_alpha(torch, px, rng)
    # (C, S, weight bits): modes 2, 4 (and 7); the dual planes of mode 6;
    # mode 9; the planes of modes 11 and 13, and mode 17's; mode 3
    fits = [(3, 2, 3), (3, 2, 2), (2, 1, 2), (1, 1, 2), (4, 2, 2), (3, 1, 2),
            (3, 1, 1), (1, 1, 1)]
    shapes = [f + (ls,) for ls in (1, 2) for f in fits] + [(3, 3, 2, 2)]
    for n_ch, n_sub, wb, ls in shapes:
        # RGB views of the RGBA pixels as the 2- and 3-subset modes take
        # them; the dual planes' channel subsets are copies
        v = rgba[..., :n_ch] if n_ch != 2 else rgba[..., 1:3].contiguous()
        label = None
        if n_sub > 1:
            pats = uenc._patterns(n_sub, False, str(dev))
            label = pats[torch.as_tensor(rng.integers(0, len(pats), b_n),
                                         device=dev)]
        levels = uenc._mode_consts(wb, 20, str(dev))[2]
        args = (v, label, n_sub, levels, ls)
        got = uenc.line_fit(*args)
        want = uenc.line_fit_reference(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"uastc_line_fit C{n_ch} S{n_sub} wb{wb} "
                                 f"ls{ls}: differs from the plain version")
        n_bytes = 4 * b_n * (16 * n_ch + 2 * n_sub * n_ch) \
            + (8 * b_n * 16 if label is not None else 0)
        measure("uastc_line_fit", f"C{n_ch} S{n_sub} L{len(levels)} ls{ls}",
                lambda: uenc.line_fit(*args),
                lambda: uenc.line_fit_reference(*args), 0.0,
                _bound(n_bytes, float(b_n * _line_fit_ops(
                    n_ch, n_sub, len(levels), ls))))
    for ls in (1, 2):
        for mode, wb, ep_range, comps in _mode_cases():
            args = (wb, ep_range, comps, ls)
            for n in (b_n, RAGGED_BLOCKS):
                got = uenc._mode_trial(rgba[:n], *args)
                want = uenc.mode_trial_reference(rgba[:n], *args)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"uastc_mode_trial mode {mode} "
                                         f"ls{ls} at {n} blocks: differs "
                                         "from the plain version")
            n_lev = 1 << wb
            n_bytes = 4 * b_n * (64 + 1 + 2 * comps + 16)
            label = f"mode {mode} comps {comps} L{n_lev} ls{ls}"
            measure("uastc_mode_trial", label,
                    lambda: uenc._mode_trial(rgba, *args),
                    lambda: uenc.mode_trial_reference(rgba, *args), 0.0,
                    _bound(n_bytes, float(b_n * _mode_trial_ops(
                        comps, n_lev, ls))))
            if split and ls == 1:
                mode_split(torch, uenc, label, args, rgba)


def phase_main_path(torch, images):
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.testing.checks import etc1s_psnr

    params = compressor.CompressorParams(quality_level=QUALITY, effort=EFFORT,
                                         device="cuda")
    mpix = sum(i.shape[0] * i.shape[1] for i in images) / 1e6
    t0 = time.time()
    compressor.compress_batch(images, params)           # first run (warm-up)
    torch.cuda.synchronize()
    t_first = time.time() - t0

    ck.reset_launch_counts()
    t0 = time.time()
    outs = compressor.compress_batch(images, params)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(ck.LAUNCHES)
    print(f"main path: {len(images)} x {WIDTH}x{HEIGHT} q{QUALITY} e{EFFORT}: "
          f"{dt:.3f} s = {mpix / dt:.3f} Mpix/s (first run {t_first:.3f} s)")
    _expect(launches, EXPECTED_PER_IMAGE, len(images), "ETC1S compress_batch")
    _expect_xla(launches, "ETC1S compress_batch", n_etc1s=len(images))

    for i, (img, out) in enumerate(zip(images, outs)):
        p = etc1s_psnr(out.basis_data, img)     # decodes, checks all CRCs
        print(f"image {i}: {len(out.basis_data)} B, endpoints "
              f"{out.num_endpoints}, selectors {out.num_selectors}, "
              f"PSNR {p:.4f} dB, CRCs ok")
        if not np.isfinite(p) or p < 25.0:
            raise AssertionError(f"image {i}: PSNR {p}")
        if i == 0:
            ref = REFERENCE_IMAGE0
            dp = p - ref["psnr"]
            ds = len(out.basis_data) / ref["basis_bytes"] - 1.0
            print(f"image 0 vs JAX-CPU reference: PSNR {dp:+.4f} dB, "
                  f"size {100 * ds:+.3f}%")
            if abs(dp) > PSNR_TOL_DB or abs(ds) > SIZE_TOL:
                raise AssertionError("image 0 drifted from the reference")
            _same_as_reference("ETC1S image 0", out.basis_data,
                               REFERENCE_BASIS_SHA256["etc1s_image0"])
    return launches, outs[0].basis_data


def _expect(launches, per_image, n, what):
    """Every kernel launched per_image[name] * n times (0 if unnamed); the
    XLA-order kernels, which run wherever the port spells out XLA's float32
    order (as many times as the search has such operators), are counted,
    not pinned."""
    print(f"{what} launch counts: {launches}")
    for name, got in launches.items():
        if name in XLA_ORDER_KERNELS:
            continue
        want = per_image.get(name, 0) * n
        if got != want:
            raise AssertionError(f"{what}: {name} launched {got} times, "
                                 f"expected {want}")


def _expect_xla(launches, what, n_etc1s=0, n_rgb=0, n_rgba=0):
    """The XLA-order kernels' launches of n_etc1s ETC1S images (q128,
    effort 1) and n_rgb RGB and n_rgba RGBA UASTC effort-2 images,
    exactly."""
    for name in XLA_ORDER_KERNELS:
        want = (EXPECTED_ETC1S_XLA.get(name, 0) * n_etc1s
                + EXPECTED_UASTC_XLA[False][name] * n_rgb
                + EXPECTED_UASTC_XLA[True][name] * n_rgba)
        if launches[name] != want:
            raise AssertionError(f"{what}: {name} launched "
                                 f"{launches[name]} times, expected {want}")
    print(f"{what}: XLA-order launches as expected "
          f"({ {k: launches[k] for k in XLA_ORDER_KERNELS} })")


def _hold(label, p, size, ref):
    dp = p - ref["psnr"]
    print(f"{label} vs JAX-CPU reference: PSNR {dp:+.6f} dB, "
          f"{size} vs {ref['basis_bytes']} B")
    if abs(dp) > PSNR_TOL_DB or size != ref["basis_bytes"]:
        raise AssertionError(f"{label} drifted from the reference")


def _same_as_reference(label, data, sha256):
    """The .basis bytes are the JAX-CPU reference's (by sha256)."""
    same = hashlib.sha256(data).hexdigest() == sha256
    print(f"{label}: .basis bytes {'equal' if same else 'NOT equal'} to the "
          "JAX-CPU reference's")
    if not same:
        raise AssertionError(f"{label}: not the reference's bytes")


def _uastc_params(compressor, device="cuda"):
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat

    return compressor.CompressorParams(
        tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=UASTC_EFFORT,
        device=device)


def phase_uastc(torch, images, rgba):
    """UASTC LDR 4x4: compress_batch of the four textures (after a warm-up
    run), then compress of the RGBA texture, the numpy packer and the plain
    versions of the search's kernels made to raise (the card packs the
    blocks and runs every trial). Returns (launches of the two counted
    runs, image 0's output)."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.uastc import encode, pack
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.testing.checks import uastc_psnr

    params = _uastc_params(compressor)
    mpix = sum(i.shape[0] * i.shape[1] for i in images) / 1e6
    t0 = time.time()
    compressor.compress_batch(images, params)           # first run (warm-up)
    torch.cuda.synchronize()
    t_first = time.time() - t0

    # the numpy packer and the plain versions of the search's kernels are
    # made to raise: the card packs the blocks and runs every trial
    refused = [(pack, "_pack_from_compact")] + [
        (encode, name) for name in (
            "subset_trial_reference", "dualplane_trial_reference",
            "mode_trial_reference", "line_fit_reference")]
    saved = [getattr(mod, name) for mod, name in refused]

    def refusing(name):
        def refuse(*args, **kw):
            raise AssertionError(f"{name} ran on the card's path")
        return refuse

    for mod, name in refused:
        setattr(mod, name, refusing(name))
    try:
        ck.reset_launch_counts()
        t0 = time.time()
        outs = compressor.compress_batch(images, params)
        torch.cuda.synchronize()
        dt = time.time() - t0
        batch = dict(ck.LAUNCHES)
        ck.reset_launch_counts()
        out_rgba = compressor.compress(rgba, params)
        torch.cuda.synchronize()
        single = dict(ck.LAUNCHES)
    finally:
        for (mod, name), fn in zip(refused, saved):
            setattr(mod, name, fn)
    print(f"UASTC: {len(images)} x {WIDTH}x{HEIGHT} effort {UASTC_EFFORT}: "
          f"{dt:.3f} s = {mpix / dt:.3f} Mpix/s (first run {t_first:.3f} s)")
    _expect_xla(batch, "UASTC compress_batch", n_rgb=len(images))
    _expect(batch, EXPECTED_UASTC_PER_IMAGE, len(images),
            "UASTC compress_batch")
    for i, (img, out) in enumerate(zip(images, outs)):
        p = uastc_psnr(out.basis_data, img)     # decodes, checks all CRCs
        print(f"UASTC image {i}: {len(out.basis_data)} B, PSNR {p:.4f} dB, "
              "CRCs ok")
        if not np.isfinite(p) or p < 30.0:
            raise AssertionError(f"UASTC image {i}: PSNR {p}")
        if i == 0:
            _hold("UASTC image 0", p, len(out.basis_data),
                  REFERENCE_UASTC_IMAGE0)
            _same_as_reference("UASTC image 0", out.basis_data,
                               REFERENCE_BASIS_SHA256["uastc_image0"])

    _expect(single, EXPECTED_UASTC_PER_IMAGE, 1, "UASTC compress RGBA")
    _expect_xla(single, "UASTC compress RGBA", n_rgba=1)
    _hold("UASTC RGBA", uastc_psnr(out_rgba.basis_data, rgba),
          len(out_rgba.basis_data), REFERENCE_UASTC_RGBA)
    _same_as_reference("UASTC RGBA", out_rgba.basis_data,
                       REFERENCE_BASIS_SHA256["uastc_rgba"])
    return {k: batch[k] + single[k] for k in batch}, outs[0]


def phase_transcoder(torch, uastc_out):
    """The port's transcoder on image 0's UASTC file: ETC1_RGB (ETC1S
    re-encode at radius 1 on the card), ASTC_4x4_RGBA (host conversion of
    the stored blocks), and the engine's ASTC re-encode of the decoded
    pixels (the UASTC search on the card). Each is held to the port on the
    CPU. Returns the launches of the two re-encodes."""
    from basis_universal_tpu_torch import transcoder
    from basis_universal_tpu_torch.codecs.uastc import astc_pack
    from basis_universal_tpu_torch.codecs.uastc.decode import decode_rgba
    from basis_universal_tpu_torch.formats.basis_file import BasisFile
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu_torch.ops.etc1 import unpack_etc1_blocks
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.testing.checks import psnr

    nbx, nby = WIDTH // 4, HEIGHT // 4
    blocks = np.frombuffer(BasisFile(uastc_out.basis_data).slice_data(0),
                           np.uint8).reshape(-1, 16)
    rgba = decode_rgba(blocks)                                   # (N,4,4,4)
    px = rgba.reshape(-1, 16, 4)[..., :3].astype(np.float64)
    tc = transcoder.BasisTranscoder(uastc_out.basis_data, device="cuda")
    cpu = transcoder.UastcTranscodeEngine("cpu")

    ck.reset_launch_counts()
    etc1 = tc.transcode_image_level(0, 0, TF.ETC1_RGB)
    torch.cuda.synchronize()
    etc1_launches = dict(ck.LAUNCHES)
    _expect(etc1_launches, EXPECTED_ETC1_TRANSCODE, 1, "transcode ETC1_RGB")
    _expect_xla(etc1_launches, "transcode ETC1_RGB")
    etc1_cpu = cpu.convert_rgba(TF.ETC1_RGB, rgba, nbx, nby, WIDTH, HEIGHT)

    def etc1_psnr(e):
        dec = unpack_etc1_blocks(e)[..., :3].reshape(-1, 16, 3)
        return psnr(dec, px)

    # the scan kernel rounds as its plain version does (whole-numbered
    # pixels), so the card picks the CPU's candidates, block for block
    differ = float((etc1 != etc1_cpu).any(-1).mean())
    p_card, p_cpu = etc1_psnr(etc1), etc1_psnr(etc1_cpu)
    print(f"transcode ETC1_RGB: PSNR vs the decoded UASTC pixels {p_card:.4f}"
          f" dB (CPU run {p_cpu:.4f} dB); {differ:.6f} of the blocks differ "
          "from the CPU run")
    if differ > 0:
        raise AssertionError("transcode ETC1_RGB: card and CPU disagree")

    ck.reset_launch_counts()
    astc = tc.transcode_image_level(0, 0, TF.ASTC_4x4_RGBA)
    _expect(dict(ck.LAUNCHES), {}, 1, "transcode ASTC_4x4_RGBA")
    if not np.array_equal(astc, astc_pack.uastc_blocks_to_astc(blocks)
                          .reshape(nby, nbx, 16)):
        raise AssertionError("transcode ASTC_4x4_RGBA differs from the "
                             "stored blocks' conversion")

    ck.reset_launch_counts()
    t0 = time.time()
    re = tc._engine.convert_rgba(TF.ASTC_4x4_RGBA, rgba, nbx, nby, WIDTH,
                                 HEIGHT)
    torch.cuda.synchronize()
    dt = time.time() - t0
    re_launches = dict(ck.LAUNCHES)
    _expect(re_launches, EXPECTED_UASTC_PER_IMAGE, 1, "ASTC 4x4 re-encode")
    # the decoded pixels carry an alpha channel: the RGBA search
    _expect_xla(re_launches, "ASTC 4x4 re-encode", n_rgba=1)
    re_cpu = cpu.convert_rgba(TF.ASTC_4x4_RGBA, rgba, nbx, nby, WIDTH, HEIGHT)
    same = float((re == re_cpu).all(-1).mean())
    print(f"ASTC 4x4 re-encode on the card: {dt:.3f} s, {same:.6f} of the "
          "blocks identical to the CPU run")
    if same < 1.0:
        raise AssertionError("ASTC 4x4 re-encode: card and CPU disagree")
    return {k: etc1_launches[k] + re_launches[k] for k in etc1_launches}


def phase_determinism(torch, img):
    """Encoding the same image twice on the card gives the same bytes."""
    from basis_universal_tpu_torch import compressor

    for label, params in (
            ("ETC1S", compressor.CompressorParams(
                quality_level=QUALITY, effort=EFFORT, device="cuda")),
            ("UASTC", _uastc_params(compressor))):
        a = compressor.compress(img, params).basis_data
        b = compressor.compress(img, params).basis_data
        print(f"determinism {label} image 0: {hashlib.sha256(a).hexdigest()} "
              f"/ {hashlib.sha256(b).hexdigest()}")
        if a != b:
            raise AssertionError(f"{label}: two encodes of image 0 differ")


def phase_cuda_vs_cpu(torch):
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.checks import etc1s_psnr
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    img, _ = synthetic_texture(256, 256, seed=1)
    res = {}
    for device in ("cuda", "cpu"):
        out = compressor.compress(img, compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device=device))
        res[device] = (etc1s_psnr(out.basis_data, img), len(out.basis_data))
    dp = res["cuda"][0] - res["cpu"][0]
    ds = res["cuda"][1] / res["cpu"][1] - 1.0
    print(f"256x256 cuda vs cpu: PSNR {res['cuda'][0]:.4f} vs "
          f"{res['cpu'][0]:.4f} dB ({dp:+.4f}), size {res['cuda'][1]} vs "
          f"{res['cpu'][1]} B ({100 * ds:+.3f}%)")
    if abs(dp) > PSNR_TOL_DB or abs(ds) > SIZE_TOL:
        raise AssertionError("cuda and cpu runs of the port disagree")


def _decode_level0(data, fmt, device="cuda"):
    """Level 0 of image 0 of a .basis file through the port's transcoder."""
    from basis_universal_tpu_torch import transcoder

    return np.asarray(transcoder.BasisTranscoder(
        data, device=device).transcode_image_level(0, 0, fmt))


def _rgba_of(img):
    if img.shape[-1] == 4:
        return img
    return np.concatenate(
        [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)


def _hold_mode(label, p, size, ref, exact_size):
    """PSNR within PSNR_TOL_DB of the recorded JAX-CPU value; the .basis
    size equal (exact_size) or within SIZE_TOL."""
    dp, ds = p - ref["psnr"], size / ref["basis_bytes"] - 1.0
    print(f"{label} vs JAX-CPU reference: PSNR {p:.4f} dB ({dp:+.6f}), "
          f"{size} vs {ref['basis_bytes']} B ({100 * ds:+.4f}%)")
    if abs(dp) > PSNR_TOL_DB or (size != ref["basis_bytes"] if exact_size
                                 else abs(ds) > SIZE_TOL):
        raise AssertionError(f"{label} drifted from the reference")


def phase_bc7(torch, rgb, rgba):
    """The BC7 search on the card (plain PyTorch, no hand-written kernel):
    effort 2 on an RGB and an RGBA 768x512 texture (all nine candidates)
    and effort 1 on the RGB one. Each is decoded with the port's
    `unpack_bc7` and held to the PSNR and the per-block digests recorded
    from the JAX reference on the CPU; two card runs must give the same
    bytes; a 256x256 texture must give the same blocks on the card and on
    the CPU. It launches none of the hand-written kernels."""
    import pathlib

    from basis_universal_tpu_torch.codecs.bc7 import encode as bc7
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
    from basis_universal_tpu_torch.ops.gpu_unpack import unpack_bc7
    from basis_universal_tpu_torch.testing import checks
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    digests = np.load(pathlib.Path(checks.__file__).with_name(
        "bc7_reference_digests.npz"))
    ck.reset_launch_counts()
    for name, img, effort in (("bc7_rgb_e2", rgb, 2), ("bc7_rgba_e2", rgba, 2),
                              ("bc7_rgb_e1", rgb, 1)):
        px = image_to_blocks(_rgba_of(img)).reshape(-1, 16, 4)
        run = lambda: bc7.encode_blocks(px, effort=effort, device="cuda")
        run()                                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        blocks = run()
        wall = time.time() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dms = _device_ms(torch, run, n=1)
        again = run()
        if not np.array_equal(blocks, again):
            raise AssertionError(f"{name}: two card runs differ")
        ref = REFERENCE_BC7[name]
        p = checks.psnr(unpack_bc7(blocks), px)
        share = float((checks.block_digests(blocks) == digests[name]).mean())
        modes = checks.bc7_mode_histogram(blocks).tolist()
        print(f"{name}: {px.shape[0]} blocks, wall {1e3 * wall:.1f} ms, device "
              f"{dms:.1f} ms, peak memory {peak_gb:.2f} GB, PSNR {p:.4f} dB "
              f"({p - ref['psnr']:+.6f} vs the JAX-CPU reference), blocks "
              f"identical to the reference's "
              f"{share:.6f}, modes {modes} (reference {ref['modes']}), two "
              "runs equal")
        if abs(p - ref["psnr"]) > PSNR_TOL_DB or share < MIN_BC7_SHARE:
            raise AssertionError(f"{name} drifted from the reference")
    small = image_to_blocks(synthetic_texture(256, 256, seed=6, alpha=True)[0]
                            ).reshape(-1, 16, 4)
    for effort in (1, 2):
        card = bc7.encode_blocks(small, effort=effort, device="cuda")
        cpu = bc7.encode_blocks(small, effort=effort, device="cpu")
        same = float((card == cpu).all(1).mean())
        print(f"bc7 256x256 RGBA effort {effort}: card == cpu on {same:.6f} of "
              "the blocks")
        if same != 1.0:
            raise AssertionError("BC7: the card and the CPU disagree")
    _expect(dict(ck.LAUNCHES), {}, 1, "BC7 search")


def phase_xubc7(torch, rgb, small, have_zstd):
    """compress(XUBC7): lossless (q 100, 768x512) must hand back, through
    the port's transcoder, the BC7 blocks of the search byte for byte;
    lossy (q 50, 384x256: its host entropy search is the slowest stage of
    all) is held to the recorded JAX-CPU PSNR and size. The stream needs
    `zstandard`; effort 0 (the mode-5 encoder of `ops/transcode.py`) too."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.bc7 import encode as bc7
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
    from basis_universal_tpu_torch.testing.checks import psnr

    if not have_zstd:
        print("XUBC7 stream: NOT RUN for want of the zstandard package (the "
              "BC7 search it packs ran above)")
        return
    ck.reset_launch_counts()
    for q, name, img in ((100, "xubc7_q100", rgb),
                         (50, "xubc7_q50_small", small)):
        t0 = time.time()
        out = compressor.compress(img, compressor.CompressorParams(
            tex_format=BasisTexFormat.XUBC7, quality_level=q, effort=2,
            device="cuda"))
        dt = time.time() - t0
        dec = _decode_level0(out.basis_data, TF.RGBA32)
        p = psnr(dec, _rgba_of(img))
        print(f"{name}: {dt:.1f} s, {len(out.basis_data)} B .basis, "
              f"{len(out.ktx2_data)} B .KTX2")
        _hold_mode(name, p, len(out.basis_data), REFERENCE_MODES[name], False)
        if q == 100:
            px = image_to_blocks(_rgba_of(rgb)).reshape(-1, 16, 4)
            want = bc7.encode_blocks(px, effort=2, perceptual=True,
                                     device="cuda")
            got = _decode_level0(out.basis_data, TF.BC7_RGBA).reshape(-1, 16)
            if not np.array_equal(got, want):
                raise AssertionError("lossless XUBC7 did not return the BC7 "
                                     "blocks byte for byte")
            print("xubc7_q100: the transcoder returns the search's BC7 blocks "
                  "byte for byte")
    _expect(dict(ck.LAUNCHES), {}, 1, "XUBC7")


def _counted_compress(torch, img, label, per_image, **kw):
    """One `compress` on the card with the launch counts read around it."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck

    ck.reset_launch_counts()
    t0 = time.time()
    out = compressor.compress(img, compressor.CompressorParams(
        device="cuda", **kw))
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(ck.LAUNCHES)
    print(f"{label}: {dt:.1f} s, {len(out.basis_data)} B .basis, "
          f"{len(out.ktx2_data)} B .KTX2")
    _expect(launches, per_image, 1, label)
    return out, launches


def phase_astc_ldr(torch, rgb):
    """ASTC LDR: 4x4 at 768x512 through the UASTC search on the card (one
    fused scan and one rescore, the ETC1 hint) and 6x6 (host code); both
    decoded by the port's transcoder and held to recorded JAX-CPU
    values. Returns the 4x4 path's launches."""
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu_torch.testing.checks import psnr

    out, launches = _counted_compress(
        torch, rgb, "ASTC LDR 4x4", EXPECTED_UASTC_PER_IMAGE,
        tex_format=BasisTexFormat.ASTC_LDR_4x4, effort=2)
    _expect_xla(launches, "ASTC LDR 4x4", n_rgb=1)
    ref = REFERENCE_MODES["astc_4x4"]
    _same_as_reference("ASTC LDR 4x4", out.basis_data, ref["sha256"])
    _hold_mode("ASTC LDR 4x4", psnr(_decode_level0(out.basis_data, TF.RGBA32),
                                    _rgba_of(rgb)),
               len(out.basis_data), ref, True)
    out6, _ = _counted_compress(
        torch, rgb, "ASTC LDR 6x6", {},
        tex_format=BasisTexFormat.ASTC_LDR_6x6, effort=1)
    _hold_mode("ASTC LDR 6x6", psnr(_decode_level0(out6.basis_data, TF.RGBA32),
                                    _rgba_of(rgb)),
               len(out6.basis_data), REFERENCE_MODES["astc_6x6"], True)
    return launches


def phase_xuastc(torch, rgb, small, have_zstd):
    """XUASTC LDR at q 75: 4x4 at 768x512 through the UASTC search on the
    card in the default full-zstd syntax (the FullArith one, which needs no
    Zstandard, where `zstandard` is not installed); 6x6 (host code) at
    384x256 in the FullArith syntax and, where it can, the full-zstd one;
    decoded by the port's transcoder and held to recorded JAX-CPU values.
    Returns the 4x4 path's launches."""
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu_torch.testing.checks import psnr

    main_syntax = "full_zstd" if have_zstd else "arith"
    if not have_zstd:
        print("XUASTC LDR full_zstd syntax: NOT RUN for want of the zstandard "
              "package (the arith syntax runs in its place)")
    out, launches = _counted_compress(
        torch, rgb, f"XUASTC LDR 4x4 {main_syntax}", EXPECTED_UASTC_PER_IMAGE,
        tex_format=BasisTexFormat.XUASTC_LDR_4x4, quality_level=75,
        effort=2, xuastc_syntax=main_syntax)
    _expect_xla(launches, f"XUASTC LDR 4x4 {main_syntax}", n_rgb=1)
    ref = REFERENCE_MODES["xuastc_4x4" + ("" if have_zstd else "_arith")]
    _hold_mode(f"XUASTC LDR 4x4 {main_syntax}",
               psnr(_decode_level0(out.basis_data, TF.RGBA32), _rgba_of(rgb)),
               len(out.basis_data), ref, True)
    _same_as_reference(f"XUASTC LDR 4x4 {main_syntax}", out.basis_data,
                       ref["sha256"])
    for syntax, suffix in (("arith", "_arith"), ("full_zstd", "")):
        if syntax == "full_zstd" and not have_zstd:
            continue
        out6, _ = _counted_compress(
            torch, small, f"XUASTC LDR 6x6 {syntax} (384x256)", {},
            tex_format=BasisTexFormat.XUASTC_LDR_6x6, quality_level=75,
            effort=1, xuastc_syntax=syntax)
        _hold_mode(f"XUASTC LDR 6x6 {syntax}",
                   psnr(_decode_level0(out6.basis_data, TF.RGBA32),
                        _rgba_of(small)),
                   len(out6.basis_data),
                   REFERENCE_MODES["xuastc_6x6_small" + suffix], True)
    return launches


def _hdr_texture():
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    base = synthetic_texture(96, 144, seed=7)[0].astype(np.float32) / 255.0
    return (base ** 2.2 * 8.0 + 0.01).astype(np.float32)


def phase_hdr(torch):
    """One 144x96 float texture through the three HDR modes (host code) and
    back through the port's transcoder: the reference's bytes, decoding to
    finite half floats of the right shape close to the source."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import metrics

    img = _hdr_texture()
    ck.reset_launch_counts()
    for fmt in (BasisTexFormat.UASTC_HDR_4x4, BasisTexFormat.ASTC_HDR_6x6,
                BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE):
        t0 = time.time()
        out = compressor.compress(img, compressor.CompressorParams(
            tex_format=fmt, effort=1, device="cuda"))
        dt = time.time() - t0
        half = _decode_level0(out.basis_data, TF.RGBA_HALF)
        dec = half.view(np.float16).astype(np.float32)[..., :3]
        m = metrics.hdr_image_metrics(img, dec, device="cuda")
        same = hashlib.sha256(out.basis_data).hexdigest() \
            == REFERENCE_HDR[fmt.name]
        print(f"{fmt.name}: {dt:.1f} s, {len(out.basis_data)} B .basis "
              f"({'equal' if same else 'NOT equal'} to the JAX-CPU "
              f"reference's), {len(out.ktx2_data)} B .KTX2, half-float PSNR "
              f"{m['half_rgb_psnr']:.3f} dB, log2 PSNR "
              f"{m['log2_rgb_psnr']:.3f} dB, mean Delta-E ITP "
              f"{m['mean_delta_itp']:.3f}")
        if dec.shape != img.shape or not np.isfinite(dec).all() \
                or m["half_rgb_psnr"] < MIN_HDR_HALF_PSNR or not same:
            raise AssertionError(f"{fmt.name}: decoded texture is wrong")
    _expect(dict(ck.LAUNCHES), {}, 1, "HDR modes")


def phase_metrics(torch, a, b):
    """`ops/metrics.py` on the card against the CPU on one 768x512 image
    pair (relative tolerance METRICS_RTOL; the Delta-E statistics, sums of
    nearly cancelling float32 terms, METRICS_DE_RTOL)."""
    from basis_universal_tpu_torch.ops import metrics

    hdr = _hdr_texture()
    hdr_b = np.abs(hdr + np.random.default_rng(3).normal(
        0, 0.02, hdr.shape).astype(np.float32))
    rows = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        r = {"ssim": metrics.ssim(a, b, device=device),
             "psnr_hvs_m": metrics.psnr_hvs_m(a, b, device=device)}
        r.update(metrics.image_metrics(a, b, device=device))
        r.update({"hdr_" + k: v for k, v in metrics.hdr_image_metrics(
            hdr, hdr_b, device=device).items()})
        rows[device] = r
        print(f"metrics on {device} ({1e3 * (time.time() - t0):.1f} ms): {r}")
    for k, want in rows["cpu"].items():
        tol = METRICS_DE_RTOL if "delta_itp" in k else METRICS_RTOL
        if abs(rows["cuda"][k] - want) > tol * abs(want):
            raise AssertionError(f"metrics: {k} {rows['cuda'][k]} on the card,"
                                 f" {want} on the CPU")


def _port_package(tree, name):
    """The port package of another checkout of the repo (or of a copy of
    the package), imported as `name` (its kernels build into that tree's
    own build/)."""
    import importlib.util
    import pathlib

    pkg = pathlib.Path(tree).resolve() / "basis_universal_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _other_port(tree):
    """The port package of another checkout of the repo, imported as
    `_other_port`: its kernel wrappers, build, XLA-order and ETC1S ops."""
    import importlib

    _port_package(tree, "_other_port")
    return (importlib.import_module("_other_port.ops.cuda_etc1s"),
            importlib.import_module("_other_port.ops._build"),
            importlib.import_module("_other_port.ops.xla_order"),
            importlib.import_module("_other_port.ops.etc1s_encode"))


# the callers of `segment_sum` on the ETC1S path, by the names of their
# functions (the bisecting init's rounds and leaf sums apart)
SEGMENT_SITES = {"bisecting_init rounds": "bisecting rounds",
                 "bisecting_init leaves": "bisecting leaves",
                 "kmeans": "k-means update",
                 "_cluster_scan": "_cluster_scan",
                 "optimize_cluster_endpoints": "refine cluster errors",
                 "_frontend_impl": "refine cluster means",
                 "update_selector_patterns": "update_selector_patterns"}
# the functions of the ETC1S path whose calls `segment_split` labels
# `name@caller` (module, name; a tree without one skips it), so that each
# sort is counted at the labelled call that encloses it
SORT_SITES = (("ops.etc1s_encode", "segment_sum"),
              ("ops.etc1s_encode", "segment_order"),
              ("ops.etc1s_encode", "_cluster_scan"),
              ("ops.etc1s_encode", "_shortlist"),
              ("ops.etc1s_encode", "bisecting_init"),
              ("codecs.etc1s.frontend", "_init_selector_patterns"))


def segment_split(torch, pkg, images):
    """ETC1S `compress_batch` of images through the port package `pkg`
    (this tree's, or `_other_port`) under torch.profiler, after a warm-up
    run, with the functions of `SORT_SITES` each in a profiler range named
    `name@caller` (`segment_order` only where a sum does not call it): the
    device ms per image of `segment_reduce` by the caller of `segment_sum`
    (`SEGMENT_SITES`), the sorts per image (`aten::sort` calls, each counted
    at its innermost labelled range; "other@none" outside them), the device
    ms per image of every kernel, and the device kernels per image."""
    import importlib

    from torch.profiler import ProfilerActivity, profile, record_function

    compressor = importlib.import_module(f"{pkg}.compressor")
    params = compressor.CompressorParams(quality_level=QUALITY, effort=EFFORT,
                                         device="cuda")

    def labelled(name, fn):
        def run(*args, **kw):
            site = sys._getframe(1).f_code.co_name
            if name == "segment_order" and site == "segment_sum":
                return fn(*args, **kw)
            if name == "segment_sum" and site == "bisecting_init":
                site += " leaves" if args[0].shape[-1] == 7 else " rounds"
            with record_function(f"{name}@{site}"):
                return fn(*args, **kw)
        return run

    compressor.compress_batch(images, params)
    torch.cuda.synchronize()
    patched = []
    for mod_name, name in SORT_SITES:
        mod = importlib.import_module(f"{pkg}.{mod_name}")
        if hasattr(mod, name):
            patched.append((mod, name, getattr(mod, name)))
            setattr(mod, name, labelled(name, getattr(mod, name)))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            compressor.compress_batch(images, params)
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)

    def reduce_us(ev):
        if "segment_reduce" in ev.name:
            return ev.device_time_total
        return sum(reduce_us(ch) for ch in ev.cpu_children)

    split = dict.fromkeys(SEGMENT_SITES.values(), 0.0)
    split["other"] = 0.0
    sorts = {}
    for ev in prof.events():
        if ev.name.startswith("segment_sum@"):
            site = SEGMENT_SITES.get(ev.name.split("@", 1)[1], "other")
            split[site] += reduce_us(ev) / 1e3 / len(images)
        if ev.name == "aten::sort":
            up = ev.cpu_parent
            while up is not None and "@" not in up.name:
                up = up.cpu_parent
            site = "other@none" if up is None else up.name
            sorts[site] = sorts.get(site, 0) + 1 / len(images)
    cuda_type = torch.autograd.DeviceType.CUDA
    # the device rows, less the ranges' own spans on the device timeline
    kernels = [e for e in prof.key_averages() if e.device_type == cuda_type
               and "@" not in e.key]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    reduce_all = sum(e.self_device_time_total for e in kernels
                     if "segment_reduce" in e.key) / 1e3
    return dict(split=split, segment_reduce_ms=reduce_all / len(images),
                device_ms=device_ms / len(images),
                kernels=sum(e.count for e in kernels) / len(images),
                sorts=sorts)


def phase_ab(torch, blocks, tree, images):
    """`--ab TREE`: this tree's scan, rescore, generic XLA-order kernels,
    k-means argmin, bisecting init, refine shortlist, selector search and
    UASTC trials against another checkout's at the shapes of phase 3:
    whether they give the same bits (the fused scan's shortlists, the
    rescore's errors, the argmin's indices, the init's seeds, the refine's
    columns, the selector's indices and errors, every output of the trials
    at 24,576 and 1,001 blocks, `trials_ab` and `mode_trials_ab`), and
    their call
    times (CUDA events) and device times (torch.profiler) in turns: other,
    this, this, other; then the ETC1S path of each (`segment_split`, the
    images of phase 4) in the same turns."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.ops import xla_order as xo

    other, other_build, other_xo, other_ops = _other_port(tree)
    t0 = time.time()
    other_build.get_lib()
    print(f"ab: {tree}'s kernels built in {time.time() - t0:.1f} s")
    for line in other_build.ptxas_report(
            other_build.library_path()).splitlines():
        print(f"ab ptxas (other): {line.strip()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    px = torch.as_tensor(blocks, dtype=torch.float32, device=dev).contiguous()
    b_n = px.shape[0]
    base5 = torch.as_tensor(rng.integers(0, 32, (b_n, 3)), dtype=torch.float32,
                            device=dev)
    c5 = rng.integers(0, 32, (b_n, 16, 3))
    packed = torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
                             | (rng.integers(0, 8, (b_n, 16)) << 15),
                             dtype=torch.int32, device=dev)
    cases = [("factorized_scan_shortlist", label, (px,), kw)
             for label, kw in (
                 ("D27", dict(radius=1)),
                 ("D27 cluster base", dict(radius=1, base5=base5)),
                 ("D125", dict(radius=2)),
                 ("D27 perceptual", dict(radius=1, perceptual=True)),
                 ("D1", dict(radius=0)))]
    cases += [("palette_errs_packed", label, (px, pk), dict(perceptual=perc))
              for label, pk, perc in (
                  ("K16", packed, False), ("K16 perceptual", packed, True),
                  ("K8", packed[:, :8].contiguous(), False))]
    # the generic XLA-order kernels at phase 3's shapes (a UASTC line fit)
    w = torch.as_tensor(rng.uniform(0, 1, (b_n, 16, 1)), dtype=torch.float32,
                        device=dev)
    m = px.mean(1, keepdim=True)
    xla = {"xla_fma": lambda mod: mod._fma(px, 257.0, m),
           "xla_reduce": lambda mod: mod._dot(w, px, 1)}
    for name, run in xla.items():
        mine, theirs = run(xo), run(other_xo)
        torch.cuda.synchronize()
        n_diff = int((mine != theirs).sum())
        runs = [lambda mod=mod_: run(mod)
                for mod_ in (other_xo, xo, xo, other_xo)]
        t = [_time_ms(r, torch) for r in runs]
        dt = [_device_ms(torch, r) for r in runs]
        print(f"ab {name}: same bits {n_diff == 0} ({n_diff} of "
              f"{mine.numel()} differ); call ms other {t[0]:.4f}, this "
              f"{t[1]:.4f}, this {t[2]:.4f}, other {t[3]:.4f}; device ms "
              f"other {dt[0]:.4f}, this {dt[1]:.4f}, this {dt[2]:.4f}, other "
              f"{dt[3]:.4f}")
        if n_diff:
            raise AssertionError(f"ab {name}: the two trees' bits differ")
    # the refine shortlist of the main path, `cross6_distances` then
    # `xla_cpu_min_k`, of both trees at phase 3's shape (a tree whose
    # kernel takes the norms computes them in the call); the k-means argmin
    # and the distances alone (such a tree's operands prepared beforehand)
    # and the whole `kmeans_assign`; the cluster scan; the bisecting init
    # of image 0's endpoint vectors
    enc = ops.encode_blocks(px, radius=1)
    vec6 = torch.cat([enc["low"], enc["high"]], -1) * (1.0 / 255.0)
    cents = vec6[torch.as_tensor(rng.choice(b_n, 2416, replace=False),
                                 device=dev)].contiguous()
    rq = (xo._dot(vec6, vec6), xo._dot(cents, cents))
    v_h = vec6.to(torch.bfloat16).float().contiguous()
    c_h = cents.to(torch.bfloat16).float().contiguous()
    q_h = xo._sum(cents * cents, -1)
    ones = torch.ones(b_n, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)

    def norms_given(m, name):
        # a tree whose cross6 kernels take the norms (and the argmin its
        # bf16 operands) from the caller, as before they moved inside
        import inspect

        return "q" in inspect.signature(getattr(m, name)).parameters

    def argmin(m):
        return (m.cross6_argmin(v_h, c_h, q_h)
                if norms_given(m, "cross6_argmin")
                else m.cross6_argmin(vec6, cents))

    def distances(m, norms=None):
        if not norms_given(m, "cross6_distances"):
            return m.cross6_distances(vec6, cents)
        return m.cross6_distances(vec6, cents, *(norms() if norms else rq))

    # the cluster scan of the main path's shape (C 2,416, D 27) on drawn
    # clusters of image 0's blocks: each tree's `_cluster_scan` (one
    # segment sum, then the assembly: one kernel here, the XLA-order
    # composition in a tree before it)
    ids = torch.as_tensor(rng.integers(0, 2416, b_n), device=dev)
    cbase5 = torch.as_tensor(rng.integers(0, 32, (2416, 3)), device=dev)
    deltas = torch.as_tensor(ops._candidate_deltas(1), device=dev)
    base8 = ops.expand5(torch.clamp(cbase5[None] + deltas[:, None, :], 0,
                                    31)).float()
    mt = ck.factorized_scan(px, base5=cbase5[ids].float().contiguous(),
                            radius=1)
    order = ops.segment_order(ids, 2416)

    def takes_order(m_ops):
        # a tree whose refine pass shares one order of the ids
        import inspect

        return "order" in inspect.signature(m_ops._cluster_scan).parameters

    for label, fn in (
            ("cross6_argmin N24576 C2416 bf16 (kernel alone)",
             lambda m, m_ops: argmin(m)),
            ("kmeans_assign N24576 C2416 (its operands, norms and kernel)",
             lambda m, m_ops: m_ops.kmeans_assign(vec6, cents, 2416)),
            ("cross6_distances N24576 C2416 (kernel alone)",
             lambda m, m_ops: distances(m)),
            ("_cluster_scan C2416 D27 (moments, segment sum, assembly; "
             "its own sort of the ids)",
             lambda m, m_ops: m_ops._cluster_scan(px, ids, base8, None, mt,
                                                  False)),
            ("_cluster_scan C2416 D27 (this tree with the refine pass's "
             "order given)",
             lambda m, m_ops: m_ops._cluster_scan(
                 px, ids, base8, None, mt, False,
                 *((order,) if takes_order(m_ops) else ()))),
            ("bisecting_init N24576 C2416",
             lambda m, m_ops: m_ops.bisecting_init(vec6, ones, 2416,
                                                   generator=gen))):
        mine, theirs = fn(ck, ops), fn(other, other_ops)
        torch.cuda.synchronize()
        n_diff = int((mine != theirs).sum())
        runs = [lambda m=m, o=o: fn(m, o)
                for m, o in ((other, other_ops), (ck, ops), (ck, ops),
                             (other, other_ops))]
        t = [_time_ms(r, torch) for r in runs]
        dt = [_device_ms(torch, r) for r in runs]
        print(f"ab {label}: same bits {n_diff == 0} ({n_diff} of "
              f"{mine.numel()} differ); call ms other {t[0]:.4f}, this "
              f"{t[1]:.4f}, this {t[2]:.4f}, other {t[3]:.4f}; device ms "
              f"other {dt[0]:.4f}, this {dt[1]:.4f}, this {dt[2]:.4f}, other "
              f"{dt[3]:.4f}")
        if n_diff:
            raise AssertionError(f"ab {label}: the two trees differ")

    # the selector search of both trees at S 2,731 and 16,128, on image 0's
    # distances (to its encode_blocks palettes, as phase 3) and on drawn
    # ones: every index and every value equal
    tabs = torch.as_tensor(ck.ETC1_INTEN_TABLES, dtype=torch.float32,
                           device=dev)
    pal = torch.clamp(ops.expand5(enc["color5"]).float()[:, None, :]
                      + tabs[enc["inten"].long()][:, :, None], 0.0, 255.0)
    drawn = torch.as_tensor(rng.uniform(0.0, 5000.0, (b_n, 16, 4)),
                            dtype=torch.float32, device=dev)
    for label, d in (("image 0", ops.block_selector_distances(
            px, pal).contiguous()), ("drawn", drawn)):
        for n_pat in SEL_S:
            pats = torch.as_tensor(rng.integers(0, 4, (n_pat, 16)),
                                   dtype=torch.int32, device=dev)

            def sel(m, d=d, pats=pats, n_pat=n_pat):
                return m.find_best_selector_patterns(d, pats, n_pat)

            mine, theirs = sel(ck), sel(other)
            torch.cuda.synchronize()
            n_diff = (int((mine[0] != theirs[0]).sum())
                      + int((mine[1] != theirs[1]).sum()))
            runs = [lambda m=m: sel(m) for m in (other, ck, ck, other)]
            t = [_time_ms(r, torch) for r in runs]
            dt = [_device_ms(torch, r) for r in runs]
            print(f"ab find_best_selector_patterns {label} S{n_pat}: same bits "
                  f"{n_diff == 0} ({n_diff} of {2 * b_n} outputs differ); call "
                  f"ms other {t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, "
                  f"other {t[3]:.4f}; device ms other {dt[0]:.4f}, this "
                  f"{dt[1]:.4f}, this {dt[2]:.4f}, other {dt[3]:.4f}")
            if n_diff:
                raise AssertionError(f"ab find_best_selector_patterns {label} "
                                     f"S{n_pat}: the two trees differ")

    def refine(mod):
        return mod.xla_cpu_min_k(distances(mod, lambda: (
            xo._dot(vec6, vec6), xo._dot(cents, cents))), 16)

    mine, theirs = refine(ck), refine(other)
    torch.cuda.synchronize()
    n_diff = int((mine != theirs).any(1).sum())
    runs = [lambda m=m: refine(m) for m in (other, ck, ck, other)]
    t = [_time_ms(r, torch) for r in runs]
    dt = [_device_ms(torch, r) for r in runs]
    print(f"ab refine shortlist N24576 C2416 k16: same columns {n_diff == 0} "
          f"({n_diff} of {b_n} rows differ); call ms other {t[0]:.4f}, this "
          f"{t[1]:.4f}, this {t[2]:.4f}, other {t[3]:.4f}; device ms other "
          f"{dt[0]:.4f}, this {dt[1]:.4f}, this {dt[2]:.4f}, other "
          f"{dt[3]:.4f}")
    if n_diff:
        raise AssertionError("ab refine shortlist: the two trees differ")
    import importlib

    other_uenc = importlib.import_module("_other_port.codecs.uastc.encode")
    trials_ab(torch, px, np.random.default_rng(1234), other_uenc)
    pack_ab(torch, px,
            importlib.import_module("_other_port.codecs.uastc.pack"))
    mode_trials_ab(torch, px, np.random.default_rng(1234), other_uenc)
    for name, label, args, kw in cases:
        mine = getattr(ck, name)(*args, **kw)
        theirs = getattr(other, name)(*args, **kw)
        torch.cuda.synchronize()
        n_diff = int((mine != theirs).sum())
        runs = [lambda m=m: getattr(m, name)(*args, **kw)
                for m in (other, ck, ck, other)]
        t = [_time_ms(r, torch) for r in runs]
        dt = [_device_ms(torch, r) for r in runs]
        print(f"ab {name} {label}: same bits {n_diff == 0} ({n_diff} of "
              f"{mine.numel()} differ, max abs "
              f"{(mine - theirs).abs().max().item():.4g}); call ms other "
              f"{t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, other "
              f"{t[3]:.4f}; device ms other {dt[0]:.4f}, this {dt[1]:.4f}, "
              f"this {dt[2]:.4f}, other {dt[3]:.4f}")
    for label, pkg in (("other", "_other_port"),
                       ("this", "basis_universal_tpu_torch"),
                       ("this", "basis_universal_tpu_torch"),
                       ("other", "_other_port")):
        got = segment_split(torch, pkg, images)
        split = ", ".join(f"{k} {v:.4f}" for k, v in got["split"].items())
        sorts = ", ".join(f"{k} {v:g}" for k, v in sorted(
            got["sorts"].items()))
        print(f"ab ETC1S {label}: device {got['device_ms']:.4f} ms/image, "
              f"{got['kernels']:.1f} device kernels/image; segment_reduce "
              f"{got['segment_reduce_ms']:.4f} ms/image, by call site: "
              f"{split}; sorts {sum(got['sorts'].values()):g}/image, by call "
              f"site: {sorts}")


def phase_profile(torch, out_dir, n_images=16):
    """Where the time goes (`--profile OUT_DIR`): steady-state throughput
    over n_images, the frontend alone (device work and one fetch per image),
    the host assembly alone (entropy coding and containers, serial), and one
    run under torch.profiler (device time by kernel, device busy share)."""
    import pathlib

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.etc1s import frontend
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    images = [synthetic_texture(HEIGHT, WIDTH, seed=s)[0]
              for s in range(n_images)]
    mpix = n_images * HEIGHT * WIDTH / 1e6
    params = compressor.CompressorParams(quality_level=QUALITY, effort=EFFORT,
                                         device="cuda")
    compressor.compress_batch(images, params)
    walls = []
    for _ in range(3):
        t0 = time.time()
        compressor.compress_batch(images, params)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    print(f"profile: {n_images} x {WIDTH}x{HEIGHT}: wall {walls} s, best "
          f"{mpix / min(walls):.3f} Mpix/s, median "
          f"{mpix / statistics.median(walls):.3f} Mpix/s")

    per_image = [compressor._prepare_slices([img], params) for img in images]
    batch = [np.concatenate([s["blocks"] for s in sl]) for sl in per_image]
    fp = compressor._frontend_params(params, batch[0].shape[0])
    nbrs = [compressor._slice_neighbors(sl) for sl in per_image]
    t0 = time.time()
    fes = list(frontend.compress_batch_iter(batch, fp, seed=params.seed,
                                            neighbors=nbrs))
    t_front = time.time() - t0
    t0 = time.time()
    for sl, fe in zip(per_image, fes):
        compressor._assemble(sl, fe, params)
    t_asm = time.time() - t0
    print(f"profile: frontend alone {t_front:.3f} s "
          f"({1e3 * t_front / n_images:.2f} ms/image), host assembly alone "
          f"(serial) {t_asm:.3f} s ({1e3 * t_asm / n_images:.2f} ms/image)")

    _trace(torch, lambda: compressor.compress_batch(images, params),
           out / "profile_device_time.txt", n_images)


def _trace(torch, run, path, n_images):
    """One run of `run` under torch.profiler: wall, device busy and idle
    share, device ms per image; kernel and operator tables to `path`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    avgs = prof.key_averages()
    cuda_type = torch.autograd.DeviceType.CUDA
    # kernels and copies (device-side rows), and the operators that
    # launched them (their device time includes their kernels)
    kernels = sorted((e for e in avgs if e.device_type == cuda_type),
                     key=lambda e: e.self_device_time_total, reverse=True)
    ops_rows = sorted((e for e in avgs if e.device_type != cuda_type
                       and e.device_time_total > 0),
                      key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n_kernels = sum(e.count for e in kernels)
    print(f"profile {path.stem}: traced wall {wall:.3f} s, device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%, device {1e3 * busy / n_images:.2f}"
          f" ms/image, {n_kernels / n_images:.1f} device kernels/image")
    k_lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
               f"{e.key[:110]}" for e in kernels]
    o_lines = [f"{e.device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
               f"{e.key[:110]}" for e in ops_rows]
    path.write_text(
        "kernels (self device time)\n" + "\n".join(k_lines)
        + "\n\noperators (device time of the kernels they launched)\n"
        + "\n".join(o_lines) + "\n")
    for line in k_lines[:12]:
        print(f"profile kernel: {line}")
    for line in o_lines[:12]:
        print(f"profile op: {line}")


def phase_profile_uastc(torch, out_dir, n_images=16):
    """The UASTC lane (`--profile OUT_DIR`): steady-state throughput over
    n_images at effort 2, the search alone (device work and one fetch of
    its (B, 59) buffer per image), the search and the packing on the card
    (one fetch of the (B, 16) blocks per image; a package without
    `uastc_pack` packs on the host), the numpy packer alone (serial: what
    `uastc_pack` replaced), and one traced run."""
    import pathlib

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.uastc import encode, pack
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    images = [synthetic_texture(HEIGHT, WIDTH, seed=s)[0]
              for s in range(n_images)]
    mpix = n_images * HEIGHT * WIDTH / 1e6
    params = _uastc_params(compressor)
    compressor.compress_batch(images, params)
    walls = []
    for _ in range(3):
        t0 = time.time()
        compressor.compress_batch(images, params)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    print(f"profile UASTC: {n_images} x {WIDTH}x{HEIGHT}: wall {walls} s, "
          f"best {mpix / min(walls):.3f} Mpix/s, median "
          f"{mpix / statistics.median(walls):.3f} Mpix/s")

    pxs = [s["px"] for img in images
           for s in compressor._prep_uastc_slices([img], params)[0]]
    modes, ls_iters, extra, topk = pack._effort_mode_set(UASTC_EFFORT, False)
    dev = torch.device("cuda")
    t0 = time.time()
    compacts = [encode._search(torch.as_tensor(px.astype(np.uint8)).to(dev),
                               modes, ls_iters, extra, topk) for px in pxs]
    t_search = time.time() - t0
    both = "n/a (this package packs on the host)"
    if hasattr(encode, "_search_and_pack"):
        t0 = time.time()
        for px in pxs:
            encode._search_and_pack(
                torch.as_tensor(px.astype(np.uint8)).to(dev), modes, ls_iters,
                extra, topk)
        t_both = time.time() - t0
        both = f"{t_both:.3f} s ({1e3 * t_both / n_images:.2f} ms/image)"
    t0 = time.time()
    for c, px in zip(compacts, pxs):
        pack._pack_from_compact(c, px, modes, extra)
    t_pack = time.time() - t0
    print(f"profile UASTC: search alone {t_search:.3f} s "
          f"({1e3 * t_search / n_images:.2f} ms/image), search + pack on the "
          f"card {both}, numpy packing alone (serial; what uastc_pack "
          f"replaced) {t_pack:.3f} s ({1e3 * t_pack / n_images:.2f} "
          "ms/image)")
    _trace(torch, lambda: compressor.compress_batch(images, params),
           pathlib.Path(out_dir) / "profile_uastc_device_time.txt", n_images)


def phase_profile_bc7(torch, img, out_dir):
    """The BC7 search (`--profile OUT_DIR`): one effort-2 encode of image 0
    traced after a warm-up run (device time by kernel in
    OUT_DIR/profile_bc7_device_time.txt)."""
    import pathlib

    from basis_universal_tpu_torch.codecs.bc7 import encode as bc7
    from basis_universal_tpu_torch.ops.etc1 import image_to_blocks

    px = image_to_blocks(_rgba_of(img)).reshape(-1, 16, 4)
    run = lambda: bc7.encode_blocks(px, effort=2, device="cuda")
    run()
    torch.cuda.synchronize()
    _trace(torch, run, pathlib.Path(out_dir) / "profile_bc7_device_time.txt",
           1)


# this script's profiles of the port package at the working directory
_PROFILE_RUN = ("import importlib.util, sys, torch; sys.path.insert(0, '.'); "
                "spec = importlib.util.spec_from_file_location('chip_smoke', "
                "{script!r}); c = importlib.util.module_from_spec(spec); "
                "spec.loader.exec_module(c); c.phase_env(torch); "
                "c.phase_profile(torch, {out!r}); "
                "c.phase_profile_uastc(torch, {out!r})")


def phase_profile_ab(tree, out_dir, timeout=1500):
    """`--profile OUT_DIR --ab TREE`: the 16-image profiles of both lanes
    (`phase_profile`, `phase_profile_uastc`, this script's) of the other
    checkout's package and of this one's in turns, other, this, this,
    other, each in a process of its own started from its tree's root
    (tables under OUT_DIR/ab_<i>_<tree>)."""
    import pathlib

    here = pathlib.Path(__file__).resolve().parent
    for i, (label, root) in enumerate((("other", pathlib.Path(tree)),
                                       ("this", here), ("this", here),
                                       ("other", pathlib.Path(tree)))):
        out = pathlib.Path(out_dir).resolve() / f"ab_{i}_{label}"
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", _PROFILE_RUN.format(
                                   script=str(here / "chip_smoke.py"),
                                   out=str(out))],
                              cwd=str(root.resolve()), capture_output=True,
                              text=True, timeout=timeout)
        for line in proc.stdout.splitlines():
            if line.startswith("profile"):
                print(f"profile-ab {i} {label}: {line}")
        print(f"profile-ab {i} {label}: {time.time() - t0:.1f} s, exit "
              f"{proc.returncode}")
        if proc.returncode != 0:
            raise RuntimeError(f"profile of {root} failed:\n"
                               f"{proc.stderr[-4000:]}")


def fit_timings(torch, label):
    """`uastc_line_fits` on image 0's blocks with the port package at the
    working directory, each shape's call and device ms printed under label
    (`--fit-ab`); a kernel that does not give its plain version's bits
    fails."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    img = synthetic_texture(HEIGHT, WIDTH, seed=0)[0]
    blocks = compressor._prepare_slices(
        [img], compressor.CompressorParams())[0]["blocks"]
    px = torch.as_tensor(blocks, dtype=torch.float32,
                         device="cuda").contiguous()

    def measure(name, shape, run, plain, err, bound):
        print(f"fit-ab {label} {name} {shape}: call "
              f"{_time_ms(run, torch):.4f} ms, device "
              f"{_device_ms(torch, run):.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})")

    uastc_line_fits(torch, px, np.random.default_rng(1234), measure,
                    split=False)


# this script's line-fit timings of the port package at the working directory
_FIT_RUN = ("import importlib.util, sys, torch; sys.path.insert(0, '.'); "
            "spec = importlib.util.spec_from_file_location('chip_smoke', "
            "{script!r}); c = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(c); c.phase_env(torch); "
            "c.fit_timings(torch, {label!r})")


def phase_fit_ab(trees, timeout=900):
    """`--fit-ab TREE [TREE ...]`: the line fits' timings (`fit_timings`)
    of this checkout's package and of each other tree's, in turns (this,
    the trees, the trees again in reverse, this), each in a process of its
    own started from its tree's root."""
    import pathlib

    here = pathlib.Path(__file__).resolve().parent
    roots = [("this", here)] + [(t, pathlib.Path(t)) for t in trees]
    for label, root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, "-c", _FIT_RUN.format(
                                   script=str(here / "chip_smoke.py"),
                                   label=label)],
                              cwd=str(root.resolve()), capture_output=True,
                              text=True, timeout=timeout)
        for line in proc.stdout.splitlines():
            if line.startswith("fit-ab"):
                print(line)
        if proc.returncode != 0:
            raise RuntimeError(f"line-fit timings of {root} failed:\n"
                               f"{proc.stderr[-4000:]}")


def phase_sel_ab(trees):
    """`--sel-ab TREE [TREE ...]`: the selector search of this checkout and
    of each other tree (e.g. a copy of the package under `_compare/` whose
    kernel was changed), at S 2,731 and 16,128 on image 0's distances (to
    its encode_blocks palettes, as phase 3) and on drawn ones, and on the
    ETC1S path's first call of image 0: whether each tree gives this
    tree's indices and errors, ptxas' resources, and device ms in turns
    (this, the trees, the trees again in reverse, this). A tree changed
    for a measurement may be wrong on purpose: differences are printed,
    not raised. No result line."""
    import importlib
    import threading

    import torch

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.ops import _build
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    mods, builds = {"this": ck}, {"this": _build}
    for i, tree in enumerate(trees):
        _port_package(tree, f"_sel_port{i}")
        mods[tree] = importlib.import_module(f"_sel_port{i}.ops.cuda_etc1s")
        builds[tree] = importlib.import_module(f"_sel_port{i}.ops._build")
    failed = {}

    def build(label):
        try:
            builds[label].build_all(("etc1s_kernels",))
        except Exception as e:    # noqa: BLE001 (reported below)
            failed[label] = e

    threads = [threading.Thread(target=build, args=(k,)) for k in builds]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failed:
        raise RuntimeError(f"sel-ab: builds failed: {failed}")
    for label, b in builds.items():
        use = [u for k, u in _ptxas_summary(b.ptxas_report(
            b.library_path())) if "selbest" in k]
        print(f"sel-ab {label} ptxas: {use}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    img = synthetic_texture(HEIGHT, WIDTH, seed=0)[0]
    px = torch.as_tensor(compressor._prepare_slices(
        [img], compressor.CompressorParams())[0]["blocks"],
        dtype=torch.float32, device=dev).contiguous()
    b_n = px.shape[0]
    enc = ops.encode_blocks(px, radius=1)
    tabs = torch.as_tensor(ck.ETC1_INTEN_TABLES, dtype=torch.float32,
                           device=dev)
    pal = torch.clamp(ops.expand5(enc["color5"]).float()[:, None, :]
                      + tabs[enc["inten"].long()][:, :, None], 0.0, 255.0)
    cases = []
    for label, d in (("image 0", ops.block_selector_distances(
            px, pal).contiguous()), ("drawn", torch.as_tensor(
                rng.uniform(0.0, 5000.0, (b_n, 16, 4)), dtype=torch.float32,
                device=dev))):
        for n_pat in SEL_S:
            cases.append((f"{label} S{n_pat}", d, torch.as_tensor(
                rng.integers(0, 4, (n_pat, 16)), dtype=torch.int32,
                device=dev), n_pat))
    calls, real = [], ops.find_best_selector_patterns

    def recorded(d, p, n):
        calls.append((d.clone(), p.clone(), n))
        return real(d, p, n)

    ops.find_best_selector_patterns = recorded
    try:
        compressor.compress(img, compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device="cuda"))
    finally:
        ops.find_best_selector_patterns = real
    d, p, n = calls[0]
    cases.append((f"ETC1S image 0 first call S{n}", d, p, n))
    order = list(mods) + list(mods)[::-1]
    for label, d, p, n in cases:
        want = ck.find_best_selector_patterns(d, p, n)
        same = []
        for tree, m in mods.items():
            got = m.find_best_selector_patterns(d, p, n)
            torch.cuda.synchronize()
            n_diff = (int((got[0] != want[0]).sum())
                      + int((got[1] != want[1]).sum()))
            same.append(f"{tree} {n_diff}")
        dt = [_device_ms(torch, lambda m=mods[k]: m.find_best_selector_patterns(
            d, p, n)) for k in order]
        print(f"sel-ab {label}: outputs differing from this tree's: "
              f"{', '.join(same)}; device ms "
              + ", ".join(f"{k} {t:.4f}" for k, t in zip(order, dt)))


def wall_times(torch, n_images=16, reps=3):
    """`compress_batch` of n_images 768x512 images with the port package at
    the working directory, ETC1S (q128, effort 1) and UASTC (effort 2), each
    after a warm-up run: one line per lane, the Mpix/s of the median of
    reps walls."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    images = [synthetic_texture(HEIGHT, WIDTH, seed=s)[0]
              for s in range(n_images)]
    mpix = n_images * HEIGHT * WIDTH / 1e6
    for lane, params in (("ETC1S", compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device="cuda")),
                         ("UASTC", _uastc_params(compressor))):
        compressor.compress_batch(images, params)
        walls = []
        for _ in range(reps):
            t0 = time.time()
            compressor.compress_batch(images, params)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        print(f"wall {lane} {mpix / statistics.median(walls):.4f} Mpix/s "
              f"(walls {walls} s)")


# this script's wall times of the port package at the working directory
_WALL_RUN = ("import importlib.util, sys, torch; sys.path.insert(0, '.'); "
             "spec = importlib.util.spec_from_file_location('chip_smoke', "
             "{script!r}); c = importlib.util.module_from_spec(spec); "
             "spec.loader.exec_module(c); c.phase_env(torch); "
             "c.wall_times(torch)")


def phase_wall_ab(tree, pairs, timeout=900):
    """`--wall-ab TREE PAIRS`: `wall_times` of the other checkout's package
    and of this one's, PAIRS pairs, each run in a process of its own started
    from its tree's root, the order within a pair alternating (the other
    tree first in even pairs); per lane each run's Mpix/s, then both trees'
    medians and quartiles and the pairs this tree won."""
    import pathlib

    here = pathlib.Path(__file__).resolve().parent
    roots = {"this": here, "other": pathlib.Path(tree)}
    runs = {"this": {}, "other": {}}
    for i in range(pairs):
        for label in (("other", "this") if i % 2 == 0 else ("this", "other")):
            proc = subprocess.run(
                [sys.executable, "-c", _WALL_RUN.format(
                    script=str(here / "chip_smoke.py"))],
                cwd=str(roots[label].resolve()), capture_output=True,
                text=True, timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"wall times of {roots[label]} failed:\n"
                                   f"{proc.stderr[-4000:]}")
            for line in proc.stdout.splitlines():
                if line.startswith("wall "):
                    _, lane, mpix = line.split()[:3]
                    runs[label].setdefault(lane, []).append(float(mpix))
                    print(f"wall-ab pair {i} {label}: {line}")
    for lane in ("ETC1S", "UASTC"):
        this, other = runs["this"][lane], runs["other"][lane]
        won = sum(a > b for a, b in zip(this, other))
        quart = [statistics.quantiles(x, n=4) if len(x) > 1 else x * 3
                 for x in (this, other)]
        print(f"wall-ab {lane}: this median {statistics.median(this):.4f} "
              f"Mpix/s (quartiles {quart[0][0]:.4f}-{quart[0][2]:.4f}), "
              f"other median {statistics.median(other):.4f} (quartiles "
              f"{quart[1][0]:.4f}-{quart[1][2]:.4f}); this tree faster in "
              f"{won} of {pairs} pairs")


def _sha(data):
    return hashlib.sha256(data).hexdigest()


def _launches_of(torch, ck, run):
    """run() with the launch counts read from 0 around it: (result,
    launches)."""
    ck.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES)


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_front_doors(torch, img0, work_dir):
    """The API and the CLI on the card at 768x512. Returns (the API path's
    launches, the CLI path's, the API's ETC1S .basis bytes)."""
    from basis_universal_tpu_torch import api, cli, compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat as F
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.utils import image_io

    enc = api.Encoder(device="cuda")
    api_total, cli_total = {}, {}
    # -- ETC1S: quality 50 is native 128; the bytes of compress() itself
    etc1s, got = _launches_of(torch, ck, lambda: enc.compress(
        img0, F.ETC1S, quality=50, effort=1, flags=api.BasisFlags.SRGB))
    _expect(got, EXPECTED_PER_IMAGE, 1, "api ETC1S")
    _expect_xla(got, "api ETC1S", n_etc1s=1)
    _add(api_total, got)
    direct = compressor.compress(img0, compressor.CompressorParams(
        quality_level=128, effort=1, device="cuda")).basis_data
    same_ref = _sha(etc1s) == REFERENCE_BASIS_SHA256["etc1s_image0"]
    print(f"api ETC1S: {len(etc1s)} B, bytes equal to compressor.compress: "
          f"{etc1s == direct}; to the JAX-CPU reference's: {same_ref}")
    if etc1s != direct:
        raise AssertionError("api ETC1S differs from compressor.compress")
    # -- UASTC LDR 4x4 and ASTC LDR 4x4 (quality 100: no RDO): the
    #    reference's bytes
    for label, fmt, want in (
            ("UASTC LDR 4x4", F.UASTC_LDR_4x4,
             REFERENCE_BASIS_SHA256["uastc_image0"]),
            ("ASTC LDR 4x4", F.ASTC_LDR_4x4, REFERENCE_MODES["astc_4x4"]
             ["sha256"])):
        data, got = _launches_of(torch, ck, lambda fmt=fmt: enc.compress(
            img0, fmt, quality=100, effort=2, flags=api.BasisFlags.SRGB))
        _expect(got, EXPECTED_UASTC_PER_IMAGE, 1, f"api {label}")
        _expect_xla(got, f"api {label}", n_rgb=1)
        _add(api_total, got)
        print(f"api {label}: {len(data)} B")
        _same_as_reference(f"api {label}", data, want)
        if fmt == F.UASTC_LDR_4x4:
            uastc = data
    # -- the transcoder: decode, the ETC1 re-encode (one shortlist at radius
    #    1 and one rescore), the ASTC 4x4 conversion (host)
    tr = api.Transcoder(device="cuda")
    rgba, got = _launches_of(torch, ck, lambda: tr.decode_rgba(uastc))
    _expect(got, {}, 1, "api decode_rgba")
    etc1, got = _launches_of(torch, ck,
                             lambda: tr.transcode_tfmt(uastc, TF.ETC1_RGB))
    _expect(got, EXPECTED_ETC1_TRANSCODE, 1, "api transcode ETC1_RGB")
    _expect_xla(got, "api transcode ETC1_RGB")
    _add(api_total, got)
    astc, got = _launches_of(
        torch, ck, lambda: tr.transcode_tfmt(uastc, TF.ASTC_4x4_RGBA))
    _expect(got, {}, 1, "api transcode ASTC_4x4_RGBA")
    print(f"api Transcoder: decode_rgba {np.asarray(rgba).shape}, ETC1_RGB "
          f"{np.asarray(etc1).shape}, ASTC_4x4_RGBA {np.asarray(astc).shape}")
    if np.asarray(rgba).shape != (HEIGHT, WIDTH, 4):
        raise AssertionError("api decode_rgba: wrong shape")

    # -- the CLI in-process on image 0 as an RGBA8 .dds (no Pillow needed)
    work_dir.mkdir(parents=True, exist_ok=True)
    dds = work_dir / "image0.dds"
    rgba0 = np.ascontiguousarray(_rgba_of(img0))
    image_io.write_dds(dds, rgba0.tobytes(), WIDTH, HEIGHT, "RGBA8")
    out_dir = str(work_dir)
    rc, got = _launches_of(torch, ck, lambda: cli.main(
        [str(dds), "-q", "128", "-effort", "1", "-basis", "-device", "cuda",
         "-output_path", out_dir]))
    _expect(got, EXPECTED_PER_IMAGE, 1, "cli ETC1S")
    _expect_xla(got, "cli ETC1S", n_etc1s=1)
    _add(cli_total, got)
    cli_etc1s = (work_dir / "image0.basis").read_bytes()
    want = enc.compress(rgba0, F.ETC1S, quality=50, effort=1,
                        flags=api.BasisFlags.SRGB)
    print(f"cli ETC1S: {len(cli_etc1s)} B, bytes equal to the API's on the "
          f"same pixels: {cli_etc1s == want}")
    if rc != 0 or cli_etc1s != want:
        raise AssertionError("cli ETC1S: not the API's bytes")
    rc, got = _launches_of(torch, ck, lambda: cli.main(
        [str(dds), "-uastc", "-effort", "2", "-basis", "-device", "cuda",
         "-output_file", "image0_uastc", "-output_path", out_dir]))
    _expect(got, EXPECTED_UASTC_PER_IMAGE, 1, "cli -uastc")
    _expect_xla(got, "cli -uastc", n_rgb=1)
    _add(cli_total, got)
    if rc != 0 or not (work_dir / "image0_uastc.basis").exists():
        raise AssertionError("cli -uastc failed")
    rc, got = _launches_of(torch, ck, lambda: cli.main(
        [str(work_dir / "image0.basis"), str(dds), "-info", "-device",
         "cuda"]))
    _expect(got, {}, 1, "cli -info")
    rc2, got = _launches_of(torch, ck, lambda: cli.main(
        [str(dds), "-bench", "-bench_reps", "2", "-q", "128", "-effort", "1",
         "-device", "cuda"]))
    _expect(got, EXPECTED_PER_IMAGE, 3, "cli -bench")
    _expect_xla(got, "cli -bench", n_etc1s=3)
    _add(cli_total, got)
    if rc != 0 or rc2 != 0:
        raise AssertionError("cli -info / -bench failed")
    print("cli -unpack / -compare: NOT RUN here (they write and read PNG "
          "through Pillow, which this machine lacks; the CPU tests run them)")
    return api_total, cli_total, etc1s


def graft_forward(blocks):
    """The twin of `__graft_entry__.entry()`'s forward step in the port:
    per-block encode, k-means of the 6-D endpoint vectors (64 clusters, two
    iterations, seeded with the first 64), a palette per cluster, the
    selector distances and the selector search against 32 patterns.
    blocks (B, 16, 3) float32 tensor. Returns (assign, sel, err)."""
    import torch

    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    num_clusters, num_patterns = 64, 32
    dev = blocks.device
    with ops.exact_matmuls():
        enc = ops.encode_blocks(blocks, radius=1)
        vec6 = torch.cat([enc["low"], enc["high"]], -1) * (1.0 / 255.0)
        w = torch.ones(vec6.shape[0], dtype=torch.float32, device=dev)
        cents, assign = ops.kmeans(vec6, w, vec6[:num_clusters], num_clusters,
                                   iters=2)
        c5 = torch.clamp(torch.round(cents[:, :3] * 31), 0, 31).to(torch.int32)
        steps = torch.tensor([[-8.0], [-2.0], [2.0], [8.0]], device=dev)
        pal = torch.clamp(ops.expand5(c5).float()[:, None, :] + steps,
                          0, 255)[assign]
        dists = ops.block_selector_distances(blocks, pal)
        patterns = torch.zeros((num_patterns, 16), dtype=torch.int32,
                               device=dev)
        sel, err = ops.find_best_selector_patterns(dists.contiguous(),
                                                   patterns, num_patterns)
    return assign, sel, err


def phase_mesh_graft_trace(torch, images, work_dir):
    """`parallel.mesh` with the card named twice, `graft_forward` against
    the CPU, and a device trace around one API encode."""
    from basis_universal_tpu_torch import api, compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat as F
    from basis_universal_tpu_torch.parallel import mesh
    from basis_universal_tpu_torch.utils import telemetry

    devs = ["cuda:0", "cuda:0"]
    params = compressor.CompressorParams(quality_level=QUALITY, effort=EFFORT,
                                         device="cuda")
    t0 = time.time()
    sharded = mesh.compress_batch_sharded(images[:2], params, devs)
    dt = time.time() - t0
    plain = compressor.compress_batch(images[:2], params)
    same = [a.basis_data == b.basis_data for a, b in zip(sharded, plain)]
    print(f"mesh compress_batch_sharded over {devs}: {dt:.3f} s, bytes equal "
          f"to compress_batch: {same} (no machine here has a second card)")
    if not all(same):
        raise AssertionError("compress_batch_sharded differs from "
                             "compress_batch")
    blocks = compressor._prepare_slices([images[0]], params)[0]["blocks"]
    px = torch.as_tensor(blocks[:1024], dtype=torch.float32)
    cents, assign = mesh.shard_blocks_frontend_step(devs, 64)(px)
    print(f"mesh shard_blocks_frontend_step: centroids "
          f"{tuple(cents.shape)}, {int(torch.unique(assign).numel())} "
          "clusters used")
    if not bool(torch.isfinite(cents).all()):
        raise AssertionError("shard_blocks_frontend_step: bad centroids")

    got = [t.cpu() for t in graft_forward(px.cuda())]
    want = graft_forward(px)
    err = float((got[2] - want[2]).abs().max())
    print(f"graft_forward on {px.shape[0]} blocks: assignments equal to the "
          f"CPU's {bool(torch.equal(got[0], want[0]))}, selector errors max "
          f"abs diff {err:.4g}")
    if not torch.equal(got[0], want[0]) or err > RTOL * float(
            want[2].abs().max()):
        raise AssertionError("graft_forward: card and CPU disagree")

    trace_dir = work_dir / "trace"
    telemetry.start_device_trace(str(trace_dir), device="cuda")
    api.Encoder(device="cuda").compress(images[0], F.ETC1S, quality=50,
                                        effort=1, flags=api.BasisFlags.SRGB)
    prof = telemetry.stop_device_trace()
    trace = trace_dir / "trace.json"
    cuda_rows = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"telemetry device trace: {trace} {trace.stat().st_size} B, "
          f"{len(cuda_rows)} device kernels")
    if not trace.exists() or not cuda_rows:
        raise AssertionError("telemetry: no device trace")


def _fed_shortlist(ops, cand):
    """A stand-in for `ops.refine_endpoint_assignment` (inside this script
    only) whose shortlist is `cand`, the one the reference's own unstable
    sort takes from image 0's refine distances (recorded by
    `tests/test_torch_recorded_reference.py --only etc1s_image0_shortlist`),
    in place of the port's own (`_refine_shortlist`)."""
    refine, own = ops.refine_endpoint_assignment, ops._refine_shortlist

    def fed(pixels, *args, **kwargs):
        want = cand.to(pixels.device)
        ops._refine_shortlist = lambda d6, k: want
        try:
            return refine(pixels, *args, **kwargs)
        finally:
            ops._refine_shortlist = own

    return refine, fed


def phase_selector_cause(torch, img0, card_bytes):
    """ETC1S image 0 on the card against the port on the CPU (asserted
    equal), on the card with the selector search's plain version run on the
    CPU in its place, and on the card with the refine shortlist the
    reference's own sort takes (asserted: the reference's recorded sha256);
    the codebook entries and bytes that differ."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.etc1s import frontend
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    params = compressor.CompressorParams(quality_level=QUALITY, effort=EFFORT)
    t0 = time.time()
    cpu = compressor.compress(img0, compressor.CompressorParams(
        quality_level=QUALITY, effort=EFFORT, device="cpu"))
    t_cpu = time.time() - t0
    kernel = ops.find_best_selector_patterns

    def plain_on_cpu(dists, patterns, num_patterns):
        best, val = ck.find_best_selector_patterns_reference(
            dists.cpu(), patterns.cpu(), num_patterns)
        return best.to(dists.device), val.to(dists.device)

    ops.find_best_selector_patterns = plain_on_cpu
    try:
        swapped = compressor.compress(img0, compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device="cuda"))
        per_image = compressor._prepare_slices([img0], params)
        blocks = np.concatenate([s["blocks"] for s in per_image])
        fp = compressor._frontend_params(params, blocks.shape[0])
        fe_swap = frontend.compress(blocks, _on_device(fp, "cuda"))
    finally:
        ops.find_best_selector_patterns = kernel
    fe_card = frontend.compress(blocks, _on_device(fp, "cuda"))
    fe_cpu = frontend.compress(blocks, _on_device(fp, "cpu"))

    def entries(fe):
        ep = {tuple(c) + (int(i),) for c, i in zip(fe.endpoint_color5.tolist(),
                                                    fe.endpoint_inten5)}
        return ep, {tuple(r) for r in fe.selectors.tolist()}

    def differ(a, b):
        ea, sa = entries(a)
        eb, sb = entries(b)
        return len(ea ^ eb), len(sa ^ sb)

    def byte_diff(a, b):
        if len(a) != len(b):
            return f"{len(a)} vs {len(b)} B"
        n = int((np.frombuffer(a, np.uint8) != np.frombuffer(b, np.uint8))
                .sum())
        return f"{n} bytes differ"

    import pathlib

    cand = torch.as_tensor(np.load(
        pathlib.Path(__file__).resolve().parent / "basis_universal_tpu_torch"
        / "testing" / "etc1s_image0_refine_shortlist.npz")["cand"]).long()
    refine, ops.refine_endpoint_assignment = _fed_shortlist(ops, cand)
    try:
        fed = compressor.compress(img0, compressor.CompressorParams(
            quality_level=QUALITY, effort=EFFORT, device="cuda")).basis_data
    finally:
        ops.refine_endpoint_assignment = refine
    print(f"ETC1S image 0 card vs CPU port ({t_cpu:.1f} s on the CPU): "
          f"bytes equal {card_bytes == cpu.basis_data} "
          f"({byte_diff(card_bytes, cpu.basis_data)}); codebook entries not "
          f"in both (endpoints, selectors) {differ(fe_card, fe_cpu)}")
    print(f"ETC1S image 0 card with the plain selector (on the CPU) vs CPU "
          f"port: bytes equal {swapped.basis_data == cpu.basis_data} "
          f"({byte_diff(swapped.basis_data, cpu.basis_data)}); codebook "
          f"entries not in both {differ(fe_swap, fe_cpu)}")
    want = REFERENCE_BASIS_SHA256["etc1s_image0"]
    print(f"ETC1S image 0 vs the JAX-CPU reference's bytes: card "
          f"{_sha(card_bytes) == want}, CPU port "
          f"{_sha(cpu.basis_data) == want} ({len(card_bytes)} / "
          f"{len(cpu.basis_data)} / {REFERENCE_IMAGE0['basis_bytes']} B); "
          f"card fed the reference's refine shortlist {_sha(fed) == want} "
          f"({len(fed)} B)")
    if card_bytes != cpu.basis_data:
        raise AssertionError("ETC1S image 0: the card's bytes differ from "
                             "the CPU's")
    if _sha(card_bytes) != want:
        raise AssertionError("ETC1S image 0: not the reference's bytes")
    if _sha(fed) != want:
        raise AssertionError("ETC1S image 0 with the reference's refine "
                             "shortlist: not the reference's bytes")


def _on_device(fp, device):
    """The frontend parameters fp on another device."""
    import dataclasses

    return dataclasses.replace(fp, device=device)


def _require_tree():
    """Exits, naming what is missing, where the port's package or the
    native sources it builds do not lie beside this script: it runs from
    the root of the whole tree."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent
    missing = [d for d in ("basis_universal_tpu_torch", "native")
               if not (root / d).is_dir()]
    if missing:
        raise SystemExit(f"chip_smoke: {', '.join(missing)} not found in "
                         f"{root}: run this script from the root of the "
                         "repository's whole tree")


def main():
    _require_tree()
    import torch

    card, have_zstd = phase_env(torch)
    if "--fit-ab" in sys.argv:
        phase_fit_ab(sys.argv[sys.argv.index("--fit-ab") + 1:])
        return
    if "--sel-ab" in sys.argv:
        phase_sel_ab(sys.argv[sys.argv.index("--sel-ab") + 1:])
        return
    if "--wall-ab" in sys.argv:
        at = sys.argv.index("--wall-ab")
        phase_wall_ab(sys.argv[at + 1], int(sys.argv[at + 2]))
        return
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    images = []
    for seed in range(N_IMAGES):
        img, sha = synthetic_texture(HEIGHT, WIDTH, seed=seed)
        if seed == 0 and sha != REFERENCE_IMAGE0["sha256"]:
            raise AssertionError(f"image 0 sha256 {sha} differs from the "
                                 "recorded reference input")
        images.append(img)
    rgba, sha = synthetic_texture(HEIGHT, WIDTH, seed=RGBA_SEED, alpha=True)
    if sha != REFERENCE_UASTC_RGBA["sha256"]:
        raise AssertionError(f"RGBA texture sha256 {sha} differs from the "
                             "recorded reference input")
    phase_build()
    blocks = compressor._prepare_slices(
        [images[0]], compressor.CompressorParams())[0]["blocks"]
    kernels = phase_kernels(torch, blocks, images[0])
    # each path's launches, counted from 0 just before it
    paths = {}
    paths["etc1s"], etc1s_image0 = phase_main_path(torch, images)
    paths["uastc"], uastc0 = phase_uastc(torch, images, rgba)
    paths["transcoder"] = phase_transcoder(torch, uastc0)
    phase_determinism(torch, images[0])
    phase_cuda_vs_cpu(torch)
    small = synthetic_texture(HEIGHT // 2, WIDTH // 2, seed=0)[0]
    phase_bc7(torch, images[0], rgba)
    phase_xubc7(torch, images[0], small, have_zstd)
    paths["astc_ldr_4x4"] = phase_astc_ldr(torch, images[0])
    paths["xuastc_ldr_4x4"] = phase_xuastc(torch, images[0], small, have_zstd)
    phase_hdr(torch)
    from basis_universal_tpu_torch.formats.constants import \
        TranscoderTextureFormat as TF

    phase_metrics(torch, _rgba_of(images[0]),
                  _decode_level0(uastc0.basis_data, TF.RGBA32))
    import pathlib

    work_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    paths["api"], paths["cli"], _ = phase_front_doors(torch, images[0],
                                                      work_dir)
    phase_mesh_graft_trace(torch, images, work_dir)
    phase_selector_cause(torch, images[0], etc1s_image0)
    tree = sys.argv[sys.argv.index("--ab") + 1] if "--ab" in sys.argv \
        else None
    if tree:
        phase_ab(torch, blocks, tree, images)
    if "--profile" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--profile") + 1]
        if tree:
            phase_profile_ab(tree, out_dir)
        else:
            phase_profile(torch, out_dir)
            phase_profile_uastc(torch, out_dir)
        phase_profile_bc7(torch, images[0], out_dir)

    record = [dict(name=name, route="cuda", source=SOURCES[name],
                   replaces=REPLACES[name],
                   launches=sum(p[name] for p in paths.values()),
                   launches_by_path={k: p[name] for k, p in paths.items()},
                   launches_per_image={k: p[name] / PATH_IMAGES[k]
                                       for k, p in paths.items()},
                   **kernels[name]) for name in REPLACES]
    print(f"card: {card}")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
