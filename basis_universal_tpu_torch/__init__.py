"""basis_universal_tpu_torch: the PyTorch + CUDA port of basis_universal_tpu.

Ported: ETC1S and UASTC LDR 4x4 encode (`compressor.compress` /
`compressor.compress_batch`) and the transcoder's re-encodes
(`transcoder.py`), with the reference's four TPU kernels written by hand in
CUDA C++ for Hopper (`csrc/etc1s_kernels.cu`). Host stages
(containers, entropy coding, the native backend) are the reference package's
own jax-free modules. This package never imports jax, even where it is
installed: the reference package's `__init__` imports jax only to set up its
compilation cache, so that package is first imported here with its switch
for that set (and the caller's environment left as it was).
"""

import os as _os
import sys as _sys

__version__ = "0.1.0"


def _import_reference_without_jax():
    if "basis_universal_tpu" in _sys.modules:
        return
    switch = "BASISU_TPU_DISABLE_COMPILE_CACHE"
    prev = _os.environ.get(switch)
    _os.environ[switch] = "1"
    try:
        import basis_universal_tpu  # noqa: F401
    finally:
        if prev is None:
            del _os.environ[switch]
        else:
            _os.environ[switch] = prev


_import_reference_without_jax()
