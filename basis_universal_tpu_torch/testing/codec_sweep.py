"""Copy of `basis_universal_tpu/testing/codec_sweep.py`.

Codec regression sweep (the reference's -test_codecs analog,
basisu_tool.cpp:7610-8050): drive the compressor over codec x quality x
effort x image grids, record KTX2 size + PSNRs, and compare against a golden
table with the reference's tolerances (PSNR +-0.125 dB tightened to our
deterministic pipeline; size +-4.5% relative). Every encode and transcode
runs on `device` ("cuda" unless the caller asks for the CPU); LDR images
load through `utils/image_io.load_image` (QOI and DDS need no Pillow)."""

import dataclasses
import json
import pathlib
from typing import List, Optional

import numpy as np

from .. import compressor
from ..formats.constants import BasisTexFormat, TranscoderTextureFormat as TF
from ..ops import metrics
from ..transcoder import Ktx2Transcoder

PSNR_TOLERANCE_DB = 0.125
SIZE_TOLERANCE_REL = 0.045
SIZE_TOLERANCE_MIN_BYTES = 1024

DEFAULT_IMAGES = ["kodim01.png", "kodim03.png", "kodim05.png",
                  "kodim13.png", "kodim18.png", "kodim23.png", "alpha0.png"]
DEFAULT_HDR_IMAGES = ["Desk.exr", "hdr_2.exr", "memorial.exr"]
DEFAULT_QUALITIES = [10, 30, 50, 75, 100, 128, 160, 192, 224, 255]
DEFAULT_EFFORTS = [0, 1, 3]

_CODEC_FORMATS = {
    "etc1s": BasisTexFormat.ETC1S,
    "uastc": BasisTexFormat.UASTC_LDR_4x4,
    "astc_ldr_4x4": BasisTexFormat.ASTC_LDR_4x4,
    "astc_ldr_5x5": BasisTexFormat.ASTC_LDR_5x5,
    "astc_ldr_6x6": BasisTexFormat.ASTC_LDR_6x6,
    "astc_ldr_10x10": BasisTexFormat.ASTC_LDR_10x10,
    "astc_ldr_12x12": BasisTexFormat.ASTC_LDR_12x12,
    "xuastc_ldr_4x4": BasisTexFormat.XUASTC_LDR_4x4,
    "xuastc_ldr_6x6": BasisTexFormat.XUASTC_LDR_6x6,
    "xuastc_ldr_8x8": BasisTexFormat.XUASTC_LDR_8x8,
    "xubc7": BasisTexFormat.XUBC7,
    "uastc_hdr": BasisTexFormat.UASTC_HDR_4x4,
    "astc_hdr_6x6": BasisTexFormat.ASTC_HDR_6x6,
    "uastc_hdr_6x6i": BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE,
}
HDR_CODECS = {"uastc_hdr", "astc_hdr_6x6", "uastc_hdr_6x6i"}

# (codec, qualities, efforts) — etc1s runs the full quality ladder, the
# fixed-rate codecs one row per effort (or a single effort)
DEFAULT_GRID = [
    ("etc1s", DEFAULT_QUALITIES, DEFAULT_EFFORTS),
    ("uastc", [0], [0, 1, 2, 3, 4]),
    ("astc_ldr_4x4", [0], [1]),
    ("astc_ldr_5x5", [0], [1]),
    ("astc_ldr_6x6", [0], [1]),
    ("astc_ldr_10x10", [0], [1]),
    ("astc_ldr_12x12", [0], [1]),
    ("xuastc_ldr_4x4", [0], [1]),
    ("xuastc_ldr_6x6", [0], [1]),
    ("xuastc_ldr_8x8", [0], [1]),
    ("xubc7", [0], [1]),
]
DEFAULT_HDR_GRID = [
    ("uastc_hdr", [0], [1]),
    ("astc_hdr_6x6", [0], [1]),
    ("uastc_hdr_6x6i", [0], [1]),
]


@dataclasses.dataclass
class SweepRow:
    codec: str
    image: str
    quality: int
    effort: int
    ktx2_size: int
    rgb_psnr: float
    rgba_psnr: float

    def key(self):
        return f"{self.codec}:{self.image}:q{self.quality}:e{self.effort}"


def _run_one(codec: str, name: str, img, q: int, effort: int,
             device="cuda") -> SweepRow:
    fmt = _CODEC_FORMATS[codec]
    params = compressor.CompressorParams(
        tex_format=fmt, quality_level=q, effort=effort, device=device)
    if codec in HDR_CODECS:
        out = compressor.compress([img], params)
        tr = Ktx2Transcoder(out.ktx2_data, device=device)
        rgb = tr.transcode_image_level(0, 0, 0, TF.RGB_HALF)
        # HDR rows store float-space PSNR in rgb_psnr and the log2 PSNR in
        # the rgba_psnr column (ops/metrics.hdr_image_metrics)
        m = metrics.hdr_image_metrics(_half_to_float(rgb), img[..., :3],
                                      device=device)
        return SweepRow(codec=codec, image=name, quality=q, effort=effort,
                       ktx2_size=len(out.ktx2_data),
                       rgb_psnr=round(float(m["rgb_psnr"]), 3),
                       rgba_psnr=round(float(m["log2_rgb_psnr"]), 3))
    out = compressor.compress(img, params)
    tr = Ktx2Transcoder(out.ktx2_data, device=device)
    rgba = tr.transcode_image_level(0, 0, 0, TF.RGBA32)
    m = metrics.image_metrics(rgba, img, device=device)
    return SweepRow(
        codec=codec, image=name, quality=q, effort=effort,
        ktx2_size=len(out.ktx2_data),
        rgb_psnr=round(float(m["rgb_psnr"]), 3),
        rgba_psnr=round(float(m.get("rgba_psnr", m["rgb_psnr"])), 3))


def _half_to_float(half_img):
    a = np.asarray(half_img)
    if a.dtype == np.uint16:
        return a.view(np.float16).astype(np.float32)
    return a.astype(np.float32)


def run_sweep(test_files_dir, images=None, qualities=None, efforts=None,
              codecs=None, hdr: bool = True, progress=print,
              device="cuda") -> List[SweepRow]:
    from ..utils.image_io import load_image, load_image_hdr

    test_files_dir = pathlib.Path(test_files_dir)
    if codecs:
        grid = []
        for c in codecs:
            default_qs = DEFAULT_QUALITIES if c == "etc1s" else [0]
            grid.append((c, qualities or default_qs, efforts or [1]))
        hdr_grid = []
    else:
        grid = DEFAULT_GRID
        hdr_grid = DEFAULT_HDR_GRID if hdr else []

    rows = []
    for name in images or DEFAULT_IMAGES:
        p = test_files_dir / name
        if not p.exists():
            continue
        img = load_image(p)
        for codec, qs, es in grid:
            for effort in es:
                for q in qs:
                    row = _run_one(codec, name, img, q, effort, device)
                    rows.append(row)
                    progress(f"{row.key()}: {row.ktx2_size} B, "
                             f"{row.rgb_psnr:.2f}/{row.rgba_psnr:.2f} dB")
    for name in (DEFAULT_HDR_IMAGES if hdr_grid else []):
        p = test_files_dir / name
        if not p.exists():
            continue
        img = np.asarray(load_image_hdr(p), np.float32)
        for codec, qs, es in hdr_grid:
            for effort in es:
                for q in qs:
                    row = _run_one(codec, name, img, q, effort, device)
                    rows.append(row)
                    progress(f"{row.key()}: {row.ktx2_size} B, "
                             f"{row.rgb_psnr:.2f}/{row.rgba_psnr:.2f} dB")
    return rows


def save_golden(rows: List[SweepRow], path):
    data = {r.key(): dataclasses.asdict(r) for r in rows}
    pathlib.Path(path).write_text(json.dumps(data, indent=1, sort_keys=True))


def check_against_golden(rows: List[SweepRow], path) -> List[str]:
    """Returns a list of failure strings (empty = pass)."""
    golden = json.loads(pathlib.Path(path).read_text())
    failures = []
    for r in rows:
        g = golden.get(r.key())
        if g is None:
            failures.append(f"{r.key()}: no golden entry")
            continue
        size_tol = max(SIZE_TOLERANCE_MIN_BYTES * SIZE_TOLERANCE_REL,
                       g["ktx2_size"] * SIZE_TOLERANCE_REL)
        if abs(r.ktx2_size - g["ktx2_size"]) > max(size_tol, 64):
            failures.append(
                f"{r.key()}: size {r.ktx2_size} vs golden {g['ktx2_size']}")
        for field in ("rgb_psnr", "rgba_psnr"):
            if abs(getattr(r, field) - g[field]) > PSNR_TOLERANCE_DB:
                failures.append(
                    f"{r.key()}: {field} {getattr(r, field)} vs golden {g[field]}")
    return failures
