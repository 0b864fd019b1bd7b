"""Batch + multi-device example on the PyTorch port (twin of
batch_mesh.py): compress a set of same-sized textures.

  python examples/batch_mesh_torch.py [DIR] [-device cpu]

Reads up to 8 kodim*.png from DIR (Pillow), or makes 4 synthetic 768x512
textures where DIR is not given. Uses compress_batch (one image at a time
on the device; host entropy coding overlaps it), then
compress_batch_sharded over every visible CUDA device (or the device named,
twice), which gives the same bytes, N-way data parallel.
"""

import pathlib
import sys
import time

from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.parallel import mesh as pmesh


def _images(d):
    if d is None:
        from basis_universal_tpu_torch.testing.synthetic import \
            synthetic_texture

        return [synthetic_texture(512, 768, seed=s)[0] for s in range(4)]
    import numpy as np

    from basis_universal_tpu_torch.utils.image_io import load_image

    imgs = []
    for p in sorted(pathlib.Path(d).glob("kodim*.png"))[:8]:
        a = load_image(p)[..., :3]
        if a.shape[:2] != (512, 768):
            a = np.ascontiguousarray(np.transpose(a, (1, 0, 2)))
        imgs.append(a)
    return imgs


def main(argv):
    device = None
    if "-device" in argv:
        i = argv.index("-device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    imgs = _images(argv[0] if argv else None)
    devices = pmesh.texture_batch_mesh(
        None if device is None else [device, device])
    print(f"{len(imgs)} textures, devices {[str(d) for d in devices]}")

    params = compressor.CompressorParams(quality_level=128, effort=1,
                                         device=str(devices[0]))
    outs = compressor.compress_batch(imgs, params)   # warm-up, kernel build
    t0 = time.time()
    outs = compressor.compress_batch(imgs, params)
    dt = time.time() - t0
    mpix = sum(i.shape[0] * i.shape[1] for i in imgs) / 1e6
    print(f"{mpix:.2f} Mpix in {dt * 1e3:.0f} ms = {mpix / dt:.2f} Mpix/s "
          f"on {devices[0]}")
    for i, out in enumerate(outs):
        print(f"  texture {i}: {len(out.basis_data)} B")

    sharded = pmesh.compress_batch_sharded(imgs, params, devices)
    assert all(a.basis_data == b.basis_data for a, b in zip(outs, sharded))
    print("device-sharded outputs byte-identical")


if __name__ == "__main__":
    main(sys.argv[1:])
