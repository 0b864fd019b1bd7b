"""Copy of `basis_universal_tpu/cli.py`.

Command-line tool (basisu_tool analog, core modes).

Modes mirror the reference CLI (basisu_tool.cpp enum tool_mode): compress
(default), -unpack, -compare, -version. More modes (bench, test_codecs,
image utilities) land with their subsystems.

In this copy every compressor, transcoder and metric runs on `-device`
("cuda" unless the caller asks for the CPU); images load through
`utils/image_io.load_image` (PNG/JPEG through Pillow, QOI and DDS without
it); `-test_codecs` takes its golden table from `-golden` and its codecs
from `-codecs`.
"""

import argparse
import pathlib
import sys

import numpy as np


def _load_image(path):
    from .utils.image_io import load_image

    return load_image(path)


def _save_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def cmd_compress(args):
    import pathlib as _p

    from . import compressor
    from .formats.constants import BasisTexFormat

    for src in args.inputs:
        if args.hdr or args.hdr_6x6 or args.hdr_6x6i \
                or _p.Path(src).suffix.lower() in (".exr", ".hdr"):
            return cmd_compress_hdr(args)
        img = _load_image(src)
        if args.output_path:
            pathlib.Path(args.output_path).mkdir(parents=True, exist_ok=True)
        if args.xuastc_size:
            fmt = getattr(BasisTexFormat, f"XUASTC_LDR_{args.xuastc_size}")
        elif args.ldr_size:
            fmt = getattr(BasisTexFormat, f"ASTC_LDR_{args.ldr_size}")
        elif args.uastc:
            fmt = BasisTexFormat.UASTC_LDR_4x4
        else:
            fmt = BasisTexFormat.ETC1S
        params = compressor.CompressorParams(
            tex_format=fmt,
            quality_level=args.q,
            effort=args.effort,
            mip_gen=args.mipmap,
            perceptual=not args.linear,
            rdo_uastc_quality=args.uastc_rdo_l if args.uastc else 0.0,
            device=args.device,
        )
        out = compressor.compress(img, params)
        stem = pathlib.Path(args.output_file).stem if args.output_file else pathlib.Path(src).stem
        outdir = pathlib.Path(args.output_path or ".")
        if args.basis:
            p = outdir / f"{stem}.basis"
            p.write_bytes(out.basis_data)
        else:
            p = outdir / f"{stem}.ktx2"
            p.write_bytes(out.ktx2_data)
        pix = img.shape[0] * img.shape[1]
        data = out.basis_data if args.basis else out.ktx2_data
        print(f"Wrote {p} ({len(data)} bytes, {len(data)*8.0/pix:.3f} bits/texel, "
              f"{out.num_endpoints} endpoints, {out.num_selectors} selectors)")
    return 0


def cmd_compress_hdr(args):
    from . import compressor
    from .formats.constants import BasisTexFormat
    from .utils.image_io import load_image_hdr

    if args.output_path:
        pathlib.Path(args.output_path).mkdir(parents=True, exist_ok=True)
    if args.hdr_6x6i:
        fmt = BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE
    elif args.hdr_6x6:
        fmt = BasisTexFormat.ASTC_HDR_6x6
    else:
        fmt = BasisTexFormat.UASTC_HDR_4x4
    for src in args.inputs:
        img = load_image_hdr(src)
        params = compressor.CompressorParams(
            tex_format=fmt, effort=args.effort, device=args.device)
        out = compressor.compress([img], params)
        stem = pathlib.Path(args.output_file).stem if args.output_file \
            else pathlib.Path(src).stem
        outdir = pathlib.Path(args.output_path or ".")
        if args.basis:
            p = outdir / f"{stem}.basis"
            p.write_bytes(out.basis_data)
        else:
            p = outdir / f"{stem}.ktx2"
            p.write_bytes(out.ktx2_data)
        pix = img.shape[0] * img.shape[1]
        data = out.basis_data if args.basis else out.ktx2_data
        print(f"Wrote {p} ({fmt.name}, {len(data)} bytes, "
              f"{len(data)*8.0/pix:.3f} bits/texel)")
    return 0


def cmd_unpack(args):
    from .api import Transcoder

    tr = Transcoder(device=args.device)
    if args.output_path:
        pathlib.Path(args.output_path).mkdir(parents=True, exist_ok=True)
    for src in args.inputs:
        data = pathlib.Path(src).read_bytes()
        h = tr.open(data)
        stem = pathlib.Path(src).stem
        outdir = pathlib.Path(args.output_path or ".")
        for level in range(tr.get_levels(h)):
            rgba = tr.decode_rgba(h, level=level)
            p = outdir / f"{stem}_unpacked_rgba_{level:04}.png"
            _save_png(p, rgba)
            print(f"Wrote {p} ({rgba.shape[1]}x{rgba.shape[0]})")
    return 0


def cmd_compare(args):
    from .ops import metrics

    a = _load_image(args.inputs[0]).astype(np.float32)
    b = _load_image(args.inputs[1]).astype(np.float32)
    if a.shape != b.shape:
        print(f"image size mismatch: {a.shape} vs {b.shape}")
        return 1
    dev = args.device
    m = metrics.image_metrics(a, b, device=dev)
    for k, v in m.items():
        print(f"{k}: {float(v):.4f} dB")
    print(f"ssim: {float(metrics.ssim(a[..., :3], b[..., :3], device=dev)):.6f}")
    print(f"psnr_hvs_m: "
          f"{float(metrics.psnr_hvs_m(a[..., :3], b[..., :3], device=dev)):.4f} dB")
    return 0


def cmd_info(args):
    """Print container structure without transcoding (basisu -info,
    basisu_tool.cpp tool_mode cInfo)."""
    for src in args.inputs:
        data = pathlib.Path(src).read_bytes()
        print(f"=== {src} ({len(data)} bytes)")
        suffix = pathlib.Path(src).suffix.lower()
        if suffix == ".dds" or data[:4] == b"DDS ":
            from .formats.dds import DdsFile

            d = DdsFile(data)
            print(f"DDS {d.format} {d.width}x{d.height} mips={d.mips} "
                  f"layers={d.layers} faces={d.faces} srgb={d.srgb}")
            continue
        if data[:4] == b"\xabKTX":
            from .formats import ktx2 as K
            from .transcoder import Ktx2Transcoder

            t = Ktx2Transcoder(data, device=args.device)
            f = t.file
            fmt = t.get_basis_tex_format()
            print(f"KTX2 vk_format={f.vk_format} "
                  f"{f.pixel_width}x{f.pixel_height} "
                  f"levels={t.get_levels()} layers={t.get_layers()} "
                  f"faces={t.get_faces()} "
                  f"scheme={f.supercompression_scheme} "
                  f"basis_format={fmt.name if fmt else 'raw'}")
            for i, lvl in enumerate(f.levels):
                print(f"  level {i}: offset={lvl.byte_offset} "
                      f"length={lvl.byte_length} "
                      f"uncompressed={lvl.uncompressed_byte_length}")
            for k, v in (f.key_values or {}).items():
                print(f"  kv {k}: {v[:40]!r}")
            continue
        from .transcoder import BasisTranscoder

        t = BasisTranscoder(data, device=args.device)
        h = t.file.header
        print(f".basis {t.tex_format.name} images={h.total_images} "
              f"slices={h.total_slices} endpoints={h.total_endpoints} "
              f"selectors={h.total_selectors} flags={h.flags:#x} "
              f"ver={h.ver}")
        for i, sd in enumerate(t.file.slices):
            print(f"  slice {i}: image={sd.image_index} "
                  f"level={sd.level_index} {sd.orig_width}x{sd.orig_height} "
                  f"blocks={sd.num_blocks_x}x{sd.num_blocks_y} "
                  f"flags={sd.flags:#x} len={sd.file_size} "
                  f"crc16={sd.slice_data_crc16:#06x}")
    return 0


def cmd_bench(args):
    """Encode+transcode benchmark per input (basisu -bench analog): times
    the compressor, then reports transcode PSNR and throughput, on the
    device it names."""
    import time

    from .codecs.etc1s.frontend import resolve_device

    from . import compressor
    from .formats.constants import (
        BasisTexFormat, TranscoderTextureFormat as TF)
    from .ops import metrics
    from .transcoder import BasisTranscoder

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch

        where = f"{torch.cuda.get_device_name(dev)} ({dev})"
    else:
        where = "cpu"
    modes = [("etc1s", BasisTexFormat.ETC1S)]
    if args.uastc:
        modes = [("uastc", BasisTexFormat.UASTC_LDR_4x4)]
    for src in args.inputs:
        img = _load_image(src)
        pix = img.shape[0] * img.shape[1]
        for name, fmt in modes:
            params = compressor.CompressorParams(
                tex_format=fmt, quality_level=args.q, effort=args.effort,
                device=args.device)
            compressor.compress(img, params)       # warmup (kernel build)
            best = None
            for _ in range(max(1, args.bench_reps)):
                t0 = time.perf_counter()
                out = compressor.compress(img, params)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            tr = BasisTranscoder(out.basis_data, device=args.device)
            t0 = time.perf_counter()
            rgba = tr.transcode_image_level(0, 0, TF.RGBA32)
            t_dec = time.perf_counter() - t0
            m = metrics.image_metrics(rgba, img, device=args.device)
            print(f"{src} [{name} q={args.q} e={args.effort}]: "
                  f"{len(out.basis_data)} B "
                  f"({len(out.basis_data) * 8.0 / pix:.3f} bpt) | "
                  f"encode {best * 1e3:.1f} ms "
                  f"({pix / best / 1e6:.2f} Mpix/s) | "
                  f"transcode {t_dec * 1e3:.1f} ms | "
                  f"rgb_psnr {float(m['rgb_psnr']):.2f} dB | on {where}")
    return 0


def cmd_test_codecs(args):
    from .testing import codec_sweep

    test_dir = args.inputs[0] if args.inputs else "/root/reference/test_files"
    codecs = args.codecs.split(",") if args.codecs else None
    rows = codec_sweep.run_sweep(test_dir, codecs=codecs, device=args.device)
    golden = pathlib.Path(args.golden) if args.golden else \
        pathlib.Path(__file__).parent.parent / "tests" / "golden_sweep.json"
    if args.test_codecs_gen or not golden.exists():
        codec_sweep.save_golden(rows, golden)
        print(f"Wrote golden table: {golden} ({len(rows)} rows)")
        return 0
    failures = codec_sweep.check_against_golden(rows, golden)
    for f in failures:
        print("FAIL:", f)
    print(f"{len(rows) - len(failures)}/{len(rows)} rows within tolerance")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="basisu_tpu_torch",
        description="Basis Universal compressor/transcoder in PyTorch + CUDA")
    ap.add_argument("inputs", nargs="*", help="input files")
    ap.add_argument("-version", action="store_true")
    ap.add_argument("-unpack", action="store_true")
    ap.add_argument("-info", action="store_true",
                    help="print container structure without transcoding")
    ap.add_argument("-bench", action="store_true",
                    help="encode+transcode benchmark per input")
    ap.add_argument("-bench_reps", type=int, default=3)
    ap.add_argument("-compare", action="store_true")
    ap.add_argument("-test_codecs", action="store_true")
    ap.add_argument("-test_codecs_gen", action="store_true")
    ap.add_argument("-golden", default=None,
                    help="golden table of -test_codecs (default "
                         "tests/golden_sweep.json)")
    ap.add_argument("-codecs", default=None,
                    help="comma-separated codecs of -test_codecs (default: "
                         "the whole sweep grid)")
    ap.add_argument("-device", default="cuda",
                    help="torch device of every encode, transcode and "
                         "metric (cuda, cuda:N, cpu)")
    ap.add_argument("-basis", action="store_true", help="write .basis instead of .ktx2")
    ap.add_argument("-uastc", action="store_true", help="UASTC LDR 4x4 mode")
    ap.add_argument("-hdr", "-hdr_4x4", action="store_true", dest="hdr",
                    help="UASTC HDR 4x4 mode (default for .exr/.hdr inputs)")
    ap.add_argument("-uastc_rdo_l", type=float, default=0.0,
                    help="UASTC RDO lambda (0 = off, 1.0 = default strength)")
    ap.add_argument("-hdr_6x6", action="store_true",
                    help="ASTC HDR 6x6 mode")
    ap.add_argument("-hdr_6x6i", action="store_true",
                    help="UASTC HDR 6x6 intermediate (supercompressed) mode")
    for s in ("4x4", "5x4", "5x5", "6x5", "6x6", "8x5", "8x6", "10x5",
              "10x6", "8x8", "10x8", "10x10", "12x10", "12x12"):
        ap.add_argument(f"-ldr_{s}", f"-astc_ldr_{s}", dest="ldr_size",
                        action="store_const", const=s,
                        help=argparse.SUPPRESS)
        ap.add_argument(f"-ldr_{s}i", f"-xuastc_ldr_{s}", dest="xuastc_size",
                        action="store_const", const=s,
                        help=argparse.SUPPRESS)
    ap.set_defaults(ldr_size=None, xuastc_size=None)
    ap.add_argument("-q", type=int, default=128, help="ETC1S quality 1-255")
    ap.add_argument("-effort", "-comp_level", type=int, default=1, dest="effort")
    ap.add_argument("-mipmap", action="store_true")
    ap.add_argument("-linear", action="store_true")
    ap.add_argument("-output_file", default=None)
    ap.add_argument("-output_path", default=None)
    args = ap.parse_args(argv)

    if args.version:
        from . import __version__

        print(f"basis_universal_tpu_torch {__version__}")
        return 0
    if args.test_codecs or args.test_codecs_gen:
        return cmd_test_codecs(args)
    if not args.inputs:
        ap.print_help()
        return 1
    if args.unpack:
        return cmd_unpack(args)
    if args.info:
        return cmd_info(args)
    if args.bench:
        return cmd_bench(args)
    if args.compare:
        return cmd_compare(args)
    return cmd_compress(args)


if __name__ == "__main__":
    sys.exit(main())
