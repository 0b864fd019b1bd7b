"""basis_universal_tpu_torch: the PyTorch + CUDA port of basis_universal_tpu.

Ported: ETC1S and UASTC LDR 4x4 encode (`compressor.compress` /
`compressor.compress_batch`) and the transcoder (`transcoder.py`, whose
re-encodes run on the card), with the reference's four TPU kernels written
by hand in CUDA C++ for Hopper (`csrc/etc1s_kernels.cu`). Host stages
(containers, entropy coding, decoders, the native backend's loader) are this
package's own copies of the reference's jax-free modules: the port imports
nothing of `basis_universal_tpu`, and never jax.
"""

__version__ = "0.1.0"
