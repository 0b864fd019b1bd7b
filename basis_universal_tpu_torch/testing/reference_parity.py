"""Copy of `basis_universal_tpu/testing/reference_parity.py`.

Reference-parity regression harness — every codec family.

The codec sweep (codec_sweep.py) gates against OUR OWN golden table; this
module gates against the REFERENCE ENCODER's results at the same
(image, codec, quality, effort) grid — the actual competitiveness bar
(reference runner: basisu_tool.cpp:7610-8050; its tolerances :7039-7042,
:7950-7960: PSNR ±0.125 dB, size ±4.5%).

Coverage: all 14 sweep codecs (g_codec_sweep, basisu_tool.cpp:7636-7656)
— ETC1S, UASTC LDR 4x4, XUBC7, ASTC LDR 4x4/6x6/8x8/10x10/12x12,
XUASTC LDR 4x4/6x6/10x10/12x12, UASTC HDR 4x4, ASTC HDR 6x6, UASTC HDR
6x6 intermediate. Quality/effort use the reference's UNIFIED scales
(-quality 1-100, -effort 0-10, basisu_tool.cpp:331-346 →
basis_compressor_params::set_format_mode_and_quality_effort,
basisu_comp.cpp:158-270), except the two legacy codecs which keep their
native knobs for cache-key stability (etc1s: -q 0-255 / -comp_level;
uastc: -uastc_level).

Oracle results are produced by running the reference CLI (/tmp/refbuild/
basisu) and are CACHED in tests/reference_parity.json (they are
deterministic), so the parity test runs without the oracle binary.
Regenerate after intentional grid changes with:

    python -m basis_universal_tpu_torch.testing.reference_parity --regen

Both sides are measured identically: the encoded file is decoded by OUR
transcoder (bit-exactness vs the reference transcoder is covered by the
conformance tests) and PSNR computed by ops/metrics.py. LDR rows carry
RGB + RGBA PSNR; HDR rows carry the log2 PSNR (the reference's headline
HDR metric, m_basis_rgb_avg_astc_hdr_log2_psnr) in BOTH columns.

This copy encodes and transcodes with the PyTorch port on `device` ("cuda"
unless the caller asks for the CPU). It needs the oracle binary (only to
regenerate) and the reference's test images under TEST_FILES; where the
images are absent, as in a checkout of this repository alone, `run_parity`
skips every row and `main` says so and returns 0, so no parity figure
comes of it there.
"""

import dataclasses
import json
import pathlib
import subprocess
import tempfile
from typing import Dict, List, Optional

import numpy as np

ORACLE = pathlib.Path("/tmp/refbuild/basisu")
TEST_FILES = pathlib.Path("/root/reference/test_files")
CACHE = pathlib.Path(__file__).resolve().parents[2] / "tests" / "reference_parity.json"

# ---------------------------------------------------------------------------
# Gate thresholds (ours vs reference at the same settings), PER CODEC.
# The north star is PSNR within 0.1 dB and size within 4.5%; gates start at
# each codec's measured gap plus a small noise margin and ratchet DOWN as
# encoders improve — tightening is a deliberate commit, loosening is a
# regression. (deficit_db, size_excess_rel); None = rate-only / psnr-only.
# ---------------------------------------------------------------------------
GATES = {
    # mature codecs: at/near reference quality already (uastc e<=2 rows
    # measure <= 0.23 dB; the e3 rows sit at 0.37 — next ratchet target)
    "etc1s":           (0.30, 0.08),
    "uastc":           (0.40, 0.08),
    # ASTC LDR direct (round-5 ratchet: rich trit/quint weight-grid configs
    # + 3-partition + RGB dual-plane landed every row within 0.70 dB at
    # 3-6% SMALLER files; 10x10 beats the reference)
    "astc_ldr_4x4":    (0.80, 0.10),
    "astc_ldr_6x6":    (0.80, 0.05),
    "astc_ldr_8x8":    (0.70, 0.05),
    "astc_ldr_10x10":  (0.30, 0.05),
    "astc_ldr_12x12":  (0.60, 0.05),
    # XUASTC: solid-RDO + DCT-quality calibration landed the lossy ladder
    # on the reference RD curve (round 4); size gates drop 0.90 → ~0.30
    "xuastc_ldr_4x4":  (1.10, 0.25),
    "xuastc_ldr_6x6":  (2.10, 0.30),
    "xuastc_ldr_10x10": (1.00, 0.30),
    "xuastc_ldr_12x12": (1.50, 0.30),
    # XUBC7 (round-5 ratchet: bc7e-class all-mode base (modes 0/2/3/4)
    # landed lossless rows at +3.5-4.7% size with PSNR +1.1-1.3 dB ABOVE
    # the reference; lossy rows -7..+5% at +1.7-2.7 dB)
    "xubc7":           (0.30, 0.06),
    # HDR (round-4 multi-mode encoders: measured -1.0/-0.55 dB 4x4,
    # 6x6/6x6i now BEAT the reference's PSNR at q0)
    "uastc_hdr_4x4":   (1.50, 0.10),
    "astc_hdr_6x6":    (0.80, 0.30),
    "uastc_hdr_6x6i":  (0.80, 0.40),
}

# The reference's own regression runner relaxes the size check for tiny
# files (basisu_tool.cpp:7950-7960); below this absolute excess a
# percentage gate is noise
SIZE_FLOOR_BYTES = 1024

# ---------------------------------------------------------------------------
# Codec registry: oracle CLI flags + our CompressorParams construction.
# q/e in a row are the reference's unified quality (1-100; 0 = "not set")
# and effort (0-10) — EXCEPT etc1s (native -q 0-255) and uastc (effort =
# native -uastc_level 0-4), kept for cache-key stability with round 1/2.
# ---------------------------------------------------------------------------
_ASTC_SIZES = ("4x4", "6x6", "8x8", "10x10", "12x12")
_XUASTC_SIZES = ("4x4", "6x6", "10x10", "12x12")
HDR_CODECS = {"uastc_hdr_4x4", "astc_hdr_6x6", "uastc_hdr_6x6i"}


def _oracle_args(codec: str, quality: int, effort: int) -> List[str]:
    if codec == "etc1s":
        return ["-basis", "-q", str(quality), "-comp_level", str(effort)]
    if codec == "uastc":
        return ["-basis", "-uastc", "-uastc_level", str(effort)]
    args = ["-ktx2", "-effort", str(effort)]
    if codec == "xubc7":
        args += ["-xubc7"]
    elif codec.startswith("astc_ldr_"):
        args += ["-" + codec]                      # -astc_ldr_4x4 ...
    elif codec.startswith("xuastc_ldr_"):
        args += ["-" + codec]                      # -xuastc_ldr_4x4 ...
    elif codec == "uastc_hdr_4x4":
        args += ["-hdr_4x4"]
    elif codec == "astc_hdr_6x6":
        args += ["-hdr_6x6"]
    elif codec == "uastc_hdr_6x6i":
        args += ["-hdr_6x6i"]
    else:
        raise ValueError(codec)
    if quality > 0:
        args += ["-quality", str(quality)]
    return args


def _our_format(codec: str):
    from ..formats.constants import BasisTexFormat as F

    table = {"etc1s": F.ETC1S, "uastc": F.UASTC_LDR_4x4, "xubc7": F.XUBC7,
             "uastc_hdr_4x4": F.UASTC_HDR_4x4, "astc_hdr_6x6": F.ASTC_HDR_6x6,
             "uastc_hdr_6x6i": F.UASTC_HDR_6x6_INTERMEDIATE}
    if codec in table:
        return table[codec]
    if codec.startswith("astc_ldr_"):
        return F["ASTC_LDR_" + codec.split("_")[-1]]
    if codec.startswith("xuastc_ldr_"):
        return F["XUASTC_LDR_" + codec.split("_")[-1]]
    raise ValueError(codec)


# ---------------------------------------------------------------------------
# Default grid. Images: kodim pair + alpha for LDR; EXRs for HDR
# (reference HDR test corpus, basisu_tool.cpp:7656).
# ---------------------------------------------------------------------------
_K2 = ("kodim03.png", "kodim23.png")
_HDR2 = ("Desk.exr", "memorial.exr")

DEFAULT_GRID = [
    # --- legacy rows (native quality scales, cache-stable keys) ---
    *[("etc1s", img, q, 1)
      for img in ("kodim01.png", "kodim03.png", "kodim18.png", "kodim23.png")
      for q in (10, 50, 128, 255)],
    *[("etc1s", img, 128, 3) for img in _K2],
    *[("uastc", img, 0, 2)
      for img in ("kodim03.png", "kodim23.png", "alpha0.png")],
    *[("uastc", img, 0, 3) for img in _K2],
    # --- XUBC7 (lossless q100 + lossy DCT qualities) ---
    *[("xubc7", img, 100, 2)
      for img in ("kodim03.png", "kodim23.png", "alpha0.png")],
    *[("xubc7", img, q, 2) for img in _K2 for q in (50, 75)],
    # --- ASTC LDR direct, all sweep footprints ---
    *[("astc_ldr_" + s, img, 100, 2) for s in _ASTC_SIZES for img in _K2],
    ("astc_ldr_4x4", "alpha0.png", 100, 2),
    # --- XUASTC LDR, quality ladder per footprint ---
    *[("xuastc_ldr_" + s, img, q, 2)
      for s in _XUASTC_SIZES for img in _K2 for q in (25, 50, 75, 100)],
    ("xuastc_ldr_6x6", "alpha0.png", 100, 2),
    # --- HDR ---
    *[("uastc_hdr_4x4", img, 0, 2) for img in _HDR2],
    *[("astc_hdr_6x6", img, 0, 2) for img in _HDR2],
    *[("astc_hdr_6x6", img, 50, 2) for img in _HDR2],
    *[("uastc_hdr_6x6i", img, 0, 2) for img in _HDR2],
    *[("uastc_hdr_6x6i", img, 50, 2) for img in _HDR2],
]


@dataclasses.dataclass
class ParityRow:
    codec: str
    image: str
    quality: int
    effort: int
    ref_size: int
    ref_rgb_psnr: float
    our_size: int
    our_rgb_psnr: float
    ref_rgba_psnr: float = 0.0
    our_rgba_psnr: float = 0.0

    def key(self):
        return f"{self.codec}:{self.image}:q{self.quality}:e{self.effort}"

    @property
    def psnr_delta(self):
        return self.our_rgb_psnr - self.ref_rgb_psnr

    @property
    def rgba_psnr_delta(self):
        return self.our_rgba_psnr - self.ref_rgba_psnr

    @property
    def size_rel(self):
        return self.our_size / max(self.ref_size, 1) - 1.0


def _load_image(name: str, hdr: bool = False):
    if hdr:
        from ..utils.image_io import load_image_hdr

        return np.asarray(load_image_hdr(TEST_FILES / name), np.float32)
    from PIL import Image

    return np.asarray(Image.open(TEST_FILES / name).convert("RGBA"))


def _measure(data: bytes, src: np.ndarray, hdr: bool,
             device="cuda") -> dict:
    """Decode encoded bytes (either container) with OUR transcoder and
    compute the gate metrics vs the source image."""
    from ..formats.constants import TranscoderTextureFormat as TF
    from ..ops import metrics
    from ..transcoder import BasisTranscoder, Ktx2Transcoder

    if data[:4] == bytes([0xAB, 0x4B, 0x54, 0x58]):
        tr = Ktx2Transcoder(data, device=device)
        tr.start_transcoding()
        dec = lambda fmt: tr.transcode_image_level(0, 0, 0, fmt)
    else:
        tr = BasisTranscoder(data, device=device)
        tr.start_transcoding()
        dec = lambda fmt: tr.transcode_image_level(0, 0, fmt)
    if hdr:
        half = np.asarray(dec(TF.RGB_HALF))
        if half.dtype == np.uint16:
            half = half.view(np.float16)
        m = metrics.hdr_image_metrics(half.astype(np.float32), src[..., :3],
                                      device=device)
        p = round(float(m["log2_rgb_psnr"]), 3)
        return {"size": len(data), "rgb_psnr": p, "rgba_psnr": p}
    rgba = dec(TF.RGBA32)
    m = metrics.image_metrics(rgba, src, device=device)
    return {"size": len(data),
            "rgb_psnr": round(float(m["rgb_psnr"]), 3),
            "rgba_psnr": round(float(m.get("rgba_psnr", m["rgb_psnr"])), 3)}


def _oracle_encode(codec: str, image: str, quality: int, effort: int) -> bytes:
    """Run the reference CLI; returns the container bytes."""
    args = _oracle_args(codec, quality, effort)
    ext = ".basis" if "-basis" in args else ".ktx2"
    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(td) / ("out" + ext)
        cmd = [str(ORACLE), str(TEST_FILES / image),
               "-output_file", str(out)] + args
        subprocess.run(cmd, check=True, capture_output=True, timeout=1800)
        return out.read_bytes()


def _our_encode(codec: str, img: np.ndarray, quality: int, effort: int,
                device="cuda") -> bytes:
    from .. import compressor

    fmt = _our_format(codec)
    if codec == "etc1s":
        q_native = quality                       # native 0-255 scale rows
    elif quality > 0:
        q_native = quality                       # unified 1-100
    else:
        q_native = 100                           # "not set" = lossless/no RDO
    params = compressor.CompressorParams(
        tex_format=fmt, quality_level=q_native, effort=effort,
        perceptual=codec not in HDR_CODECS, device=device)
    out = compressor.compress(img, params)
    return out.basis_data if codec in ("etc1s", "uastc") else out.ktx2_data


def _missing_image(image: str, progress) -> bool:
    """True (and says so) where the grid row's image is absent."""
    if (TEST_FILES / image).exists():
        return False
    progress(f"skipped {image}: not in {TEST_FILES}")
    return True


def regen_reference(grid=None, progress=print,
                    device="cuda") -> Dict[str, dict]:
    """Run the oracle over the grid and write the cache file."""
    if not ORACLE.exists():
        raise RuntimeError(f"oracle not built at {ORACLE}")
    table = {}
    errors = []
    for codec, image, q, e in grid or DEFAULT_GRID:
        key = f"{codec}:{image}:q{q}:e{e}"
        if _missing_image(image, progress):
            continue
        try:
            hdr = codec in HDR_CODECS
            src = _load_image(image, hdr)
            data = _oracle_encode(codec, image, q, e)
            table[key] = _measure(data, src, hdr, device)
            progress(f"ref {key}: {table[key]['size']} B "
                     f"{table[key]['rgb_psnr']} dB")
        except Exception as exc:  # keep going; a partial table is usable
            errors.append(f"{key}: {type(exc).__name__}: {exc}")
            progress(f"ref {key}: FAILED {exc}")
    CACHE.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    if errors:
        progress(f"{len(errors)} rows failed: " + "; ".join(errors))
    return table


def load_reference() -> Optional[Dict[str, dict]]:
    if not CACHE.exists():
        return None
    return json.loads(CACHE.read_text())


def run_parity(grid=None, reference=None, progress=print,
               device="cuda") -> List[ParityRow]:
    reference = reference or load_reference()
    if reference is None:
        raise RuntimeError("no cached reference table; run --regen")
    rows = []
    for codec, image, q, e in grid or DEFAULT_GRID:
        key = f"{codec}:{image}:q{q}:e{e}"
        if key not in reference or _missing_image(image, progress):
            continue
        hdr = codec in HDR_CODECS
        src = _load_image(image, hdr)
        data = _our_encode(codec, src, q, e, device)
        ours = _measure(data, src, hdr, device)
        ref = reference[key]
        row = ParityRow(
            codec=codec, image=image, quality=q, effort=e,
            ref_size=ref["size"], ref_rgb_psnr=ref["rgb_psnr"],
            our_size=ours["size"], our_rgb_psnr=ours["rgb_psnr"],
            ref_rgba_psnr=ref.get("rgba_psnr", ref["rgb_psnr"]),
            our_rgba_psnr=ours["rgba_psnr"])
        rows.append(row)
        progress(f"{key}: ours {row.our_size} B {row.our_rgb_psnr} dB | "
                 f"ref {row.ref_size} B {row.ref_rgb_psnr} dB | "
                 f"Δpsnr {row.psnr_delta:+.3f} size {row.size_rel:+.1%}")
    return rows


def check_rows(rows: List[ParityRow]) -> List[str]:
    """Returns a list of violation strings (empty = all rows in tolerance)."""
    bad = []
    for r in rows:
        max_deficit, max_excess = GATES[r.codec]
        if r.psnr_delta < -max_deficit:
            bad.append(f"{r.key()}: PSNR {r.our_rgb_psnr} vs ref "
                       f"{r.ref_rgb_psnr} ({r.psnr_delta:+.3f} dB, "
                       f"gate {max_deficit})")
        if r.rgba_psnr_delta < -max_deficit:
            bad.append(f"{r.key()}: RGBA PSNR {r.our_rgba_psnr} vs ref "
                       f"{r.ref_rgba_psnr} ({r.rgba_psnr_delta:+.3f} dB, "
                       f"gate {max_deficit})")
        if (r.size_rel > max_excess
                and r.our_size - r.ref_size > SIZE_FLOOR_BYTES):
            bad.append(f"{r.key()}: size {r.our_size} vs ref {r.ref_size} "
                       f"({r.size_rel:+.1%}, gate {max_excess:.0%})")
    return bad


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="re-run the oracle and rewrite the cached table")
    ap.add_argument("--codec", help="only rows for this codec")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's encodes (cuda, cpu)")
    args = ap.parse_args(argv)
    if not TEST_FILES.is_dir():
        print(f"skipped: no test images at {TEST_FILES}; no parity figure")
        return 0
    grid = None
    if args.codec:
        grid = [r for r in DEFAULT_GRID if r[0] == args.codec]
    if args.regen:
        regen_reference(grid=grid, device=args.device)
    rows = run_parity(grid=grid, device=args.device)
    bad = check_rows(rows)
    if bad:
        print("\nVIOLATIONS:")
        for b in bad:
            print(" ", b)
        return 1
    print(f"\nall {len(rows)} rows within per-codec tolerance (GATES)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
