"""Build and load the hand-written CUDA kernels (csrc/etc1s_kernels.cu).

The source is compiled at first use with nvcc into a shared library with a
plain C interface, for sm_90a (Hopper), and loaded with ctypes. The library
is cached under `build/torch_kernels/` at the repository root, keyed by the
hash of the source, as `native.py` does for the host runtime, with ptxas'
report of each kernel's registers and spills beside it. A failed build or
load raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "etc1s_kernels.cu"
_BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_CUDA_ROOTS = ("/usr/local/cuda",)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *_CUDA_ROOTS):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{_SRC.name}")


def library_path() -> pathlib.Path:
    """Builds the library if it is missing; returns its path."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"etc1s_kernels_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    _report_path(out).write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _report_path(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(lib: pathlib.Path) -> str:
    """ptxas' resource report (registers, spills, shared memory per kernel)
    of the build that made `lib` ("" for a library built elsewhere)."""
    path = _report_path(lib)
    return path.read_text() if path.exists() else ""


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.etc1s_factorized_scan.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.etc1s_factorized_scan_shortlist.argtypes = [vp, vp, vp, ci, ci, ci,
                                                    ci, vp]
    lib.etc1s_palette_errs_packed.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.etc1s_palette_errs.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.etc1s_find_best_selector_patterns.argtypes = [vp, vp, vp, vp, ci, ci,
                                                      vp]
    for fn in (lib.etc1s_factorized_scan, lib.etc1s_factorized_scan_shortlist,
               lib.etc1s_palette_errs_packed,
               lib.etc1s_palette_errs, lib.etc1s_find_best_selector_patterns):
        fn.restype = ci
    return lib


def get_lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(library_path())))
        return _lib
