#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's ETC1S encode path once on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the process exits nonzero with no final line):
1. require CUDA; print versions, the card's name and power limit, and
   whether the native host backend is available;
2. build the hand-written kernels from `basis_universal_tpu_torch/csrc/`;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (B = 24,576 blocks of one 768x512 image) and time
   both with CUDA events;
4. encode four synthetic 768x512 textures with `compressor.compress_batch`
   at quality 128, effort 1 on the card: check that each kernel was launched
   the expected number of times, decode every .basis with the reference's
   host decoder (slice CRCs, PSNR), and hold image 0 against values recorded
   from the JAX reference compressor on the CPU;
5. encode one 256x256 texture on the card and on the CPU and compare;
6. with `--profile OUT_DIR` only: time 16 images and profile one run
   (device time by kernel written to OUT_DIR/profile_device_time.txt).

The last two lines are the kernels' JSON record and the result line.
"""

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
# the bound the CPU tests hold the port to; on the card image 0 has drifted
# by at most 0.0142 dB and 0.304% (atomic sums make runs differ)
PSNR_TOL_DB = 0.05
SIZE_TOL = 0.015

HEIGHT, WIDTH, N_IMAGES = 512, 768, 4
QUALITY, EFFORT = 128, 1
# kernel launches per image at q128 / effort 1: the scan in encode_blocks
# and in the one refine pass, the rescore in encode_blocks, the refine's
# cluster rescore and its reassignment, the selector search in the two
# selector iterations and the final assignment
EXPECTED_PER_IMAGE = {"factorized_scan": 2, "palette_errs_packed": 3,
                      "find_best_selector_patterns": 3}
PALLAS = "basis_universal_tpu/ops/pallas_etc1s.py"
REPLACES = {"factorized_scan": f"{PALLAS}:343",
            "palette_errs_packed": f"{PALLAS}:137",
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
    """Each kernel against its plain version at the main path's shapes."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    px = torch.as_tensor(blocks, dtype=torch.float32, device=dev).contiguous()
    b_n = px.shape[0]
    results = {}

    # -- factorized_scan: radius 1 (216 columns) with and without a cluster
    #    base, radius 2 (1,000 columns), and the perceptual variant.
    base5 = torch.as_tensor(rng.integers(0, 32, (b_n, 3)), dtype=torch.float32,
                            device=dev)
    worst = 0.0
    timed = None
    for label, kw in (("r1", dict(radius=1)),
                      ("r1 base5", dict(radius=1, base5=base5)),
                      ("r2", dict(radius=2)),
                      ("r1 perceptual", dict(radius=1, perceptual=True))):
        got = ck.factorized_scan(px, **kw)
        want = ck.factorized_scan_reference(px, **kw)
        torch.cuda.synchronize()
        err = _close(got, want, scan_term_magnitude(px, **kw),
                     f"factorized_scan {label}")
        worst = max(worst, err)
        ms = _time_ms(lambda: ck.factorized_scan(px, **kw), torch)
        pms = _time_ms(lambda: ck.factorized_scan_reference(px, **kw), torch,
                       reps=5)
        print(f"factorized_scan {label}: B={b_n} cols={got.shape[1]} "
              f"max_abs_err={err:.4g} kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if timed is None:
            timed = (ms, pms)
    results["factorized_scan"] = dict(max_abs_err=worst, ms=timed[0],
                                      plain_ms=timed[1])

    # -- palette_errs_packed: K = 16 packed candidates, plain and perceptual
    c5 = rng.integers(0, 32, (b_n, 16, 3))
    tt = rng.integers(0, 8, (b_n, 16))
    packed = torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
                             | (tt << 15), dtype=torch.int32, device=dev)
    worst = 0.0
    timed = None
    for perceptual in (False, True):
        got = ck.palette_errs_packed(px, packed, perceptual=perceptual)
        want = ck.palette_errs_packed_reference(px, packed,
                                                perceptual=perceptual)
        torch.cuda.synchronize()
        err = _close(got, want, 0.0, f"palette_errs_packed perc={perceptual}")
        worst = max(worst, err)
        ms = _time_ms(lambda: ck.palette_errs_packed(
            px, packed, perceptual=perceptual), torch)
        pms = _time_ms(lambda: ck.palette_errs_packed_reference(
            px, packed, perceptual=perceptual), torch, reps=5)
        print(f"palette_errs_packed perceptual={perceptual}: B={b_n} K=16 "
              f"max_abs_err={err:.4g} kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if timed is None:
            timed = (ms, pms)
    results["palette_errs_packed"] = dict(max_abs_err=worst, ms=timed[0],
                                          plain_ms=timed[1])

    # -- find_best_selector_patterns: S = 2,731 patterns, distances to each
    #    block's own encode_blocks palette
    n_pat = 2731
    enc = ops.encode_blocks(px, radius=1)
    pal = torch.clamp(
        ops.expand5(enc["color5"]).float()[:, None, :]
        + torch.as_tensor(ck.ETC1_INTEN_TABLES, dtype=torch.float32,
                          device=dev)[enc["inten"].long()][:, :, None],
        0.0, 255.0)
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
    ms = _time_ms(lambda: ck.find_best_selector_patterns(dists, pats, n_pat),
                  torch)
    pms = _time_ms(lambda: ck.find_best_selector_patterns_reference(
        dists, pats, n_pat), torch, reps=5)
    print(f"find_best_selector_patterns: B={b_n} S={n_pat} max_abs_err={err:.4g}"
          f" index ties {int(differ.sum())}/{b_n} kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms")
    results["find_best_selector_patterns"] = dict(max_abs_err=err, ms=ms,
                                                  plain_ms=pms)
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
    print(f"launch counts: {launches}")
    for name, per in EXPECTED_PER_IMAGE.items():
        if launches[name] != per * len(images):
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{per * len(images)}")

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

    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        compressor.compress_batch(images, params)
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
    print(f"profile: traced wall {wall:.3f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    k_lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
               f"{e.key[:110]}" for e in kernels]
    o_lines = [f"{e.device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
               f"{e.key[:110]}" for e in ops_rows]
    (out / "profile_device_time.txt").write_text(
        "kernels (self device time)\n" + "\n".join(k_lines)
        + "\n\noperators (device time of the kernels they launched)\n"
        + "\n".join(o_lines) + "\n")
    for line in k_lines[:12]:
        print(f"profile kernel: {line}")
    for line in o_lines[:12]:
        print(f"profile op: {line}")


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
    phase_build()
    blocks = compressor._prepare_slices(
        [images[0]], compressor.CompressorParams())[0]["blocks"]
    kernels = phase_kernels(torch, blocks)
    launches = phase_main_path(torch, images)
    phase_cuda_vs_cpu(torch)
    if "--profile" in sys.argv:
        phase_profile(torch, sys.argv[sys.argv.index("--profile") + 1])

    record = [dict(name=name, route="cuda", source=SOURCE,
                   replaces=REPLACES[name], launches=launches[name],
                   **kernels[name]) for name in EXPECTED_PER_IMAGE]
    print(f"card: {card}")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
