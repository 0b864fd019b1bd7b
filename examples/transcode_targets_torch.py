"""Transcode example on the PyTorch port (twin of transcode_targets.py):
one .basis/.ktx2 file -> every GPU target it supports.

  python examples/transcode_targets_torch.py [texture.ktx2] [-device cpu]

Without a file it first encodes a synthetic 256x256 texture. Targets that
re-encode pixels (ETC1/ETC2 from non-ETC1S files, ASTC 4x4) run on the
CUDA card unless another device is named.
"""

import pathlib
import sys

from basis_universal_tpu_torch.api import Encoder, Transcoder
from basis_universal_tpu_torch.formats.constants import \
    TranscoderTextureFormat as TF

TARGETS = [
    TF.ETC1_RGB, TF.ETC2_RGBA, TF.BC1_RGB, TF.BC3_RGBA, TF.BC4_R,
    TF.BC5_RG, TF.BC7_RGBA, TF.ASTC_4x4_RGBA, TF.ATC_RGB,
    TF.PVRTC1_4_RGB, TF.FXT1_RGB, TF.ETC2_EAC_R11,
    TF.RGBA32, TF.RGB565, TF.RGBA4444,
]


def main(argv):
    device = "cuda"
    if "-device" in argv:
        i = argv.index("-device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        from basis_universal_tpu_torch.testing.synthetic import \
            synthetic_texture

        img, _ = synthetic_texture(256, 256, seed=3, alpha=True)
        data = Encoder(device=device).compress(img, quality=50)
        print("encoded a synthetic 256x256 texture ->", len(data), "bytes")
    else:
        data = pathlib.Path(argv[0]).read_bytes()

    tr = Transcoder(device=device)
    h = tr.open(data)
    print(f"{tr.get_width(h)}x{tr.get_height(h)}, "
          f"{tr.get_levels(h)} level(s)")
    for fmt in TARGETS:
        try:
            out = tr.transcode_tfmt(h, fmt)
        except (ValueError, NotImplementedError) as e:  # PVRTC1 needs pow2
            print(f"  {fmt.name:16} skipped ({type(e).__name__}: {e})")
            continue
        print(f"  {fmt.name:16} {out.shape} {out.dtype}")


if __name__ == "__main__":
    main(sys.argv[1:])
