"""Basic encode example on the PyTorch port (twin of encode_basic.py):

  python examples/encode_basic_torch.py input.png [output.ktx2] [-device cpu]

Encodes an image (PNG/JPEG through Pillow; QOI and DDS without it; a
synthetic 256x256 texture where none is given) to an ETC1S .KTX2 on the
CUDA card (or the device named), prints the stats, then transcodes it back
and reports PSNR.
"""

import pathlib
import sys

from basis_universal_tpu_torch.api import Encoder, Transcoder
from basis_universal_tpu_torch.formats.constants import \
    TranscoderTextureFormat as TF
from basis_universal_tpu_torch.ops import metrics
from basis_universal_tpu_torch.utils.image_io import load_image


def main(argv):
    device = "cuda"
    if "-device" in argv:
        i = argv.index("-device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv:
        img = load_image(argv[0])
        stem = pathlib.Path(argv[0]).stem
    else:
        from basis_universal_tpu_torch.testing.synthetic import \
            synthetic_texture

        img, stem = synthetic_texture(256, 256, seed=1)[0], "synthetic"
    dst = argv[1] if len(argv) > 1 else stem + ".ktx2"

    ktx2 = Encoder(device=device).compress(img, quality=128)
    pathlib.Path(dst).write_bytes(ktx2)
    bpt = len(ktx2) * 8.0 / (img.shape[0] * img.shape[1])
    print(f"wrote {dst}: {len(ktx2)} bytes ({bpt:.3f} bits/texel)")

    tr = Transcoder(device=device)
    h = tr.open(ktx2)
    rgba = tr.decode_rgba(h)
    m = metrics.image_metrics(rgba, img, device=device)
    print(f"round-trip rgb PSNR: {float(m['rgb_psnr']):.2f} dB")

    # GPU block formats come straight from the same handle
    bc7 = tr.transcode_tfmt(h, TF.BC7_RGBA)
    etc1 = tr.transcode_tfmt(h, TF.ETC1_RGB)
    print(f"BC7 blocks: {bc7.shape}, ETC1 blocks: {etc1.shape}")


if __name__ == "__main__":
    main(sys.argv[1:])
