"""basis_universal_tpu_torch: the PyTorch + CUDA port of basis_universal_tpu.

It does everything the reference does: every encode mode of
`compressor.compress` / `compressor.compress_batch` (ETC1S, UASTC LDR 4x4,
XUBC7, ASTC LDR, XUASTC LDR and the three HDR modes), the transcoder
(`transcoder.py`, whose re-encodes run on the card), the image metrics and
the front doors (`api`, the CLI of `python -m basis_universal_tpu_torch`,
image I/O, the codec sweep, the parity harness, telemetry, `parallel.mesh`),
with the reference's four TPU kernels written by hand in CUDA C++ for Hopper
(`csrc/etc1s_kernels.cu`). Host stages (containers, entropy coding,
decoders, the native backend's loader) are this package's own copies of the
reference's jax-free modules: the port imports nothing of
`basis_universal_tpu`, and never jax. Its entry points run on "cuda" unless
the caller passes device="cpu".
"""

__version__ = "0.1.0"
