#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's encode paths (ETC1S, UASTC LDR 4x4) and
its transcoder re-encodes once on one GPU.

    python3 chip_smoke.py [--profile OUT_DIR]

Phases (any failure raises, so the process exits nonzero with no final line):
1. require CUDA; print versions, the card's name and power limit, and
   whether the native host backend is available;
2. build the hand-written kernels from `basis_universal_tpu_torch/csrc/`;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the paths give it (B = 24,576 blocks of one 768x512 image; the
   scan at radius 0/1/2, the rescore at K 16 and 8; `palette_errs`, which
   no path calls, at K 16) and time both with CUDA events;
4. ETC1S: encode four synthetic 768x512 textures with
   `compressor.compress_batch` at quality 128, effort 1 on the card: check
   that each kernel was launched the expected number of times, decode every
   .basis with the reference's host decoder (slice CRCs, PSNR), and hold
   image 0 against values recorded from the JAX reference on the CPU;
5. UASTC LDR 4x4: the same four textures through `compress_batch` at
   effort 2, then one 768x512 RGBA texture through `compress`: one scan and
   one rescore launch per image (the ETC1 hint), every file decoded (CRCs,
   PSNR), image 0 and the RGBA texture held to recorded JAX-CPU values;
6. transcoder: the port's `BasisTranscoder` turns image 0's UASTC file into
   ETC1_RGB (an ETC1S re-encode on the card) and ASTC_4x4_RGBA, and the
   engine's ASTC re-encode of decoded pixels runs the UASTC search on the
   card; launches are asserted and each result is held to the port on the
   CPU;
7. determinism: ETC1S and UASTC image 0 encoded twice give the same bytes;
8. encode one 256x256 texture (ETC1S) on the card and on the CPU, compare;
9. with `--profile OUT_DIR` only: time 16 images per codec and profile one
   run of each (device time by kernel in OUT_DIR/profile_*.txt).

The last two lines are the kernels' JSON record and the result line.
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
REFERENCE_UASTC_RGBA = dict(
    sha256="f69600ec8c55ad49376dd26b572282dfa943288d653d137cc037df05cce0e485",
    psnr=41.97688873860354,
    basis_bytes=393316,
)
# the bound the CPU tests hold the port to
PSNR_TOL_DB = 0.05
SIZE_TOL = 0.015

HEIGHT, WIDTH, N_IMAGES = 512, 768, 4
QUALITY, EFFORT = 128, 1
UASTC_EFFORT = 2
RGBA_SEED = 4
# kernel launches per image at q128 / effort 1: the scan in encode_blocks
# and in the one refine pass, the rescore in encode_blocks, the refine's
# cluster rescore and its reassignment, the selector search in the two
# selector iterations and the final assignment
EXPECTED_PER_IMAGE = {"factorized_scan": 2, "palette_errs_packed": 3,
                      "find_best_selector_patterns": 3}
# UASTC: per image, one scan (radius 0) and one rescore (K 8) for the ETC1
# hint; the transcoder's ETC1 target one scan (radius 1) and one rescore
# (K 16), its ASTC re-encode one UASTC search
EXPECTED_UASTC_PER_IMAGE = {"factorized_scan": 1, "palette_errs_packed": 1}
PALLAS = "basis_universal_tpu/ops/pallas_etc1s.py"
REPLACES = {"factorized_scan": f"{PALLAS}:343",
            "palette_errs_packed": f"{PALLAS}:137",
            "palette_errs": f"{PALLAS}:49",
            "find_best_selector_patterns": f"{PALLAS}:207"}
SOURCE = "basis_universal_tpu_torch/csrc/etc1s_kernels.cu"
RTOL = 1e-5
SCAN_MAG_TOL = 1e-6     # ~8 float32 ulps of the scan's cancelled terms


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
    from basis_universal_tpu_torch import compressor

    print("native host backend available: "
          f"{compressor.native_mod.available()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from basis_universal_tpu_torch.ops import _build

    t0 = time.time()
    path = _build.library_path()
    _build.get_lib()
    print(f"build: {path.name} in {time.time() - t0:.1f} s")


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


def phase_kernels(torch, blocks):
    """Each kernel against its plain version at the paths' shapes. Returns
    per kernel the max abs error, the time of its first shape (the ETC1S
    main path's, or K 16 for `palette_errs`) and every shape's row."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    px = torch.as_tensor(blocks, dtype=torch.float32, device=dev).contiguous()
    b_n = px.shape[0]
    results = {}

    def measure(name, label, run, plain, err):
        ms = _time_ms(run, torch)
        pms = _time_ms(plain, torch, reps=5)
        print(f"{name} {label}: B={b_n} max_abs_err={err:.4g} "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
        row = dict(shape=label, max_abs_err=err, ms=ms, plain_ms=pms)
        res = results.setdefault(name, dict(max_abs_err=0.0, ms=ms,
                                            plain_ms=pms, by_shape=[]))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["by_shape"].append(row)

    # -- factorized_scan: radius 1 (216 columns) with and without a cluster
    #    base, radius 2 (1,000 columns), the perceptual variant, and radius 0
    #    (8 columns, the UASTC ETC1 hint).
    base5 = torch.as_tensor(rng.integers(0, 32, (b_n, 3)), dtype=torch.float32,
                            device=dev)
    for label, kw in (("D27", dict(radius=1)),
                      ("D27 cluster base", dict(radius=1, base5=base5)),
                      ("D125", dict(radius=2)),
                      ("D27 perceptual", dict(radius=1, perceptual=True)),
                      ("D1", dict(radius=0))):
        got = ck.factorized_scan(px, **kw)
        want = ck.factorized_scan_reference(px, **kw)
        torch.cuda.synchronize()
        err = _close(got, want, scan_term_magnitude(px, **kw),
                     f"factorized_scan {label}")
        measure("factorized_scan", label,
                lambda: ck.factorized_scan(px, **kw),
                lambda: ck.factorized_scan_reference(px, **kw), err)

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
        err = _close(got, want, 0.0, f"palette_errs_packed {label}")
        measure("palette_errs_packed", label,
                lambda: ck.palette_errs_packed(px, pk, perceptual=perceptual),
                lambda: ck.palette_errs_packed_reference(
                    px, pk, perceptual=perceptual), err)

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
                lambda: ck.palette_errs_reference(x, pl), err)

    # -- find_best_selector_patterns: S = 2,731 patterns, distances to each
    #    block's own encode_blocks palette
    n_pat = 2731
    enc = ops.encode_blocks(px, radius=1)
    pal = torch.clamp(
        ops.expand5(enc["color5"]).float()[:, None, :]
        + tabs[enc["inten"].long()][:, :, None], 0.0, 255.0)
    dists = ops.block_selector_distances(px, pal).contiguous()
    pats = torch.as_tensor(rng.integers(0, 4, (n_pat, 16)), dtype=torch.int32,
                           device=dev)
    best, val = ck.find_best_selector_patterns(dists, pats, n_pat)
    best_p, val_p = ck.find_best_selector_patterns_reference(dists, pats,
                                                             n_pat)
    torch.cuda.synchronize()
    err = _close(val, val_p, 0.0, "find_best_selector_patterns min_err")
    # an index may differ only where the two patterns' errors tie
    d_bf = dists.reshape(b_n, 64).to(torch.bfloat16).float()
    onehot = torch.nn.functional.one_hot(pats.long(), 4).reshape(n_pat, 64)
    err_of_best = (d_bf * onehot[best.long()].float()).sum(-1)
    differ = best != best_p
    if not torch.all(~differ | ((err_of_best - val_p).abs()
                                <= RTOL * val_p.abs())):
        raise AssertionError("find_best_selector_patterns: index differs "
                             "without a tie")
    print(f"find_best_selector_patterns: index ties {int(differ.sum())}/{b_n}")
    measure("find_best_selector_patterns", f"S{n_pat}",
            lambda: ck.find_best_selector_patterns(dists, pats, n_pat),
            lambda: ck.find_best_selector_patterns_reference(dists, pats,
                                                             n_pat), err)
    return results


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
    return launches


def _expect(launches, per_image, n, what):
    """Every kernel launched per_image[name] * n times (0 if unnamed)."""
    print(f"{what} launch counts: {launches}")
    for name, got in launches.items():
        want = per_image.get(name, 0) * n
        if got != want:
            raise AssertionError(f"{what}: {name} launched {got} times, "
                                 f"expected {want}")


def _hold(label, p, size, ref):
    dp = p - ref["psnr"]
    print(f"{label} vs JAX-CPU reference: PSNR {dp:+.6f} dB, "
          f"{size} vs {ref['basis_bytes']} B")
    if abs(dp) > PSNR_TOL_DB or size != ref["basis_bytes"]:
        raise AssertionError(f"{label} drifted from the reference")


def _uastc_params(compressor, device="cuda"):
    from basis_universal_tpu.formats.constants import BasisTexFormat

    return compressor.CompressorParams(
        tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=UASTC_EFFORT,
        device=device)


def phase_uastc(torch, images, rgba):
    """UASTC LDR 4x4: compress_batch of the four textures (after a warm-up
    run), then compress of the RGBA texture. Returns (launches of the two
    counted runs, image 0's output)."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.testing.checks import uastc_psnr

    params = _uastc_params(compressor)
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
    batch = dict(ck.LAUNCHES)
    print(f"UASTC: {len(images)} x {WIDTH}x{HEIGHT} effort {UASTC_EFFORT}: "
          f"{dt:.3f} s = {mpix / dt:.3f} Mpix/s (first run {t_first:.3f} s)")
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

    ck.reset_launch_counts()
    out = compressor.compress(rgba, params)
    torch.cuda.synchronize()
    single = dict(ck.LAUNCHES)
    _expect(single, EXPECTED_UASTC_PER_IMAGE, 1, "UASTC compress RGBA")
    _hold("UASTC RGBA", uastc_psnr(out.basis_data, rgba),
          len(out.basis_data), REFERENCE_UASTC_RGBA)
    return {k: batch[k] + single[k] for k in batch}, outs[0]


def phase_transcoder(torch, uastc_out):
    """The port's transcoder on image 0's UASTC file: ETC1_RGB (ETC1S
    re-encode at radius 1 on the card), ASTC_4x4_RGBA (host conversion of
    the stored blocks), and the engine's ASTC re-encode of the decoded
    pixels (the UASTC search on the card). Each is held to the port on the
    CPU. Returns the launches of the two re-encodes."""
    from basis_universal_tpu.codecs.uastc import astc_pack
    from basis_universal_tpu.codecs.uastc.decode import decode_rgba
    from basis_universal_tpu.formats.basis_file import BasisFile
    from basis_universal_tpu.formats.constants import \
        TranscoderTextureFormat as TF
    from basis_universal_tpu.ops.etc1 import unpack_etc1_blocks
    from basis_universal_tpu_torch import transcoder
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
    _expect(etc1_launches, {"factorized_scan": 1, "palette_errs_packed": 1}, 1,
            "transcode ETC1_RGB")
    etc1_cpu = cpu.convert_rgba(TF.ETC1_RGB, rgba, nbx, nby, WIDTH, HEIGHT)

    def etc1_psnr(e):
        dec = unpack_etc1_blocks(e)[..., :3].reshape(-1, 16, 3)
        return psnr(dec, px)

    # the scan's float rounding (kernel vs plain) can reorder candidates
    # near the shortlist's 16th place, and so a block's winner
    differ = float((etc1 != etc1_cpu).any(-1).mean())
    p_card, p_cpu = etc1_psnr(etc1), etc1_psnr(etc1_cpu)
    print(f"transcode ETC1_RGB: PSNR vs the decoded UASTC pixels {p_card:.4f}"
          f" dB (CPU run {p_cpu:.4f} dB); {differ:.6f} of the blocks differ "
          "from the CPU run")
    if abs(p_card - p_cpu) > PSNR_TOL_DB or differ > 0.01:
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
    re_cpu = cpu.convert_rgba(TF.ASTC_4x4_RGBA, rgba, nbx, nby, WIDTH, HEIGHT)
    same = float((re == re_cpu).all(-1).mean())
    print(f"ASTC 4x4 re-encode on the card: {dt:.3f} s, {same:.6f} of the "
          "blocks identical to the CPU run")
    if same < 0.99:
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
    print(f"profile {path.stem}: traced wall {wall:.3f} s, device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%, device {1e3 * busy / n_images:.2f}"
          " ms/image")
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
    n_images at effort 2, the search alone (device work and one fetch per
    image), the host packing alone (serial), and one traced run."""
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
    t0 = time.time()
    for c, px in zip(compacts, pxs):
        pack._pack_from_compact(c, px, modes, extra)
    t_pack = time.time() - t0
    print(f"profile UASTC: search alone {t_search:.3f} s "
          f"({1e3 * t_search / n_images:.2f} ms/image), host packing alone "
          f"(serial) {t_pack:.3f} s ({1e3 * t_pack / n_images:.2f} ms/image)")
    _trace(torch, lambda: compressor.compress_batch(images, params),
           pathlib.Path(out_dir) / "profile_uastc_device_time.txt", n_images)


def main():
    import torch

    card = phase_env(torch)
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
    kernels = phase_kernels(torch, blocks)
    # each path's launches, counted from 0 just before it
    paths = {"etc1s": phase_main_path(torch, images)}
    paths["uastc"], uastc0 = phase_uastc(torch, images, rgba)
    paths["transcoder"] = phase_transcoder(torch, uastc0)
    phase_determinism(torch, images[0])
    phase_cuda_vs_cpu(torch)
    if "--profile" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--profile") + 1]
        phase_profile(torch, out_dir)
        phase_profile_uastc(torch, out_dir)

    record = [dict(name=name, route="cuda", source=SOURCE,
                   replaces=REPLACES[name],
                   launches=sum(p[name] for p in paths.values()),
                   launches_by_path={k: p[name] for k, p in paths.items()},
                   **kernels[name]) for name in REPLACES]
    print(f"card: {card}")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
