"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source (`etc1s_kernels.cu`, the ETC1S encoder's kernels,
`xla_order_kernels.cu`, XLA-CPU's float32 orders, and
`uastc_pack_kernels.cu`, the UASTC block packing) is compiled at first use
with nvcc into a shared library with a plain C interface, for sm_90a
(Hopper), and loaded with ctypes. The libraries are cached under
`build/torch_kernels/` at the repository root, keyed by the hash of their
source and the headers beside it, as `native.py` does for the host
runtime, with ptxas' report of each kernel's registers and spills beside
it. `build_all()` starts one nvcc
per missing library, all at once. A failed build or load raises: there is
no fallback.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCES = ("etc1s_kernels", "xla_order_kernels", "uastc_pack_kernels")
_BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_CUDA_ROOTS = ("/usr/local/cuda",)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *_CUDA_ROOTS):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (csrc/*.cu)")


def _target(name: str) -> pathlib.Path:
    csrc = _PKG / "csrc"
    # the source and every header beside it that it may include
    data = (csrc / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.h")))
    tag = hashlib.sha256(data).hexdigest()[:16]
    return _BUILD_DIR / f"{name}_{tag}.so"


def build_all(names=SOURCES):
    """Builds every missing library of `names`, one nvcc each, all started
    together; returns their paths."""
    outs = {name: _target(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if todo:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(_PKG / "csrc" / f"{name}.cu")]
            procs.append((out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for out, tmp, cmd, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            _report_path(out).write_text(stdout + stderr)
            os.replace(tmp, out)
    return outs


def library_path(name: str = "etc1s_kernels") -> pathlib.Path:
    """Builds the library of csrc/<name>.cu if it is missing; returns its
    path."""
    return build_all((name,))[name]


def _report_path(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(lib: pathlib.Path) -> str:
    """ptxas' resource report (registers, spills, shared memory per kernel)
    of the build that made `lib` ("" for a library built elsewhere)."""
    path = _report_path(lib)
    return path.read_text() if path.exists() else ""


def _declare_xla_order(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.xla_fma.argtypes = [vp, vp, vp, f32, f32, f32, vp, ll, ci, vp, vp]
    lib.xla_reduce.argtypes = [vp, vp, vp, ll, ci, ll, ll, ci, ci, vp, vp]
    lib.uastc_line_fit.argtypes = [vp, ll, ll, ll, vp, ci, vp, ci, ci, vp, vp,
                                   ci, ci, vp]
    lib.uastc_mode_trial.argtypes = [vp, ll, ll, ll, vp, vp, ci, vp, ci, ci,
                                     ci, vp, vp, vp, ci, vp]
    lib.uastc_subset_trial.argtypes = [vp, ll, ll, ll, vp, ci, vp, vp, ci, vp,
                                       ci, ci, ci, ci, ci, vp, vp, vp, vp, ci,
                                       vp]
    lib.uastc_dualplane_trial.argtypes = [vp, ll, ll, ll, vp, vp, ci, vp, ci,
                                          ci, ci, vp, vp, vp, vp, ci, vp]
    # the trials' per-step split (`chip_smoke.py`): the same and a stop
    for name in ("uastc_subset_trial", "uastc_dualplane_trial"):
        fn = getattr(lib, name + "_split")
        fn.argtypes = getattr(lib, name).argtypes[:-1] + [ci, vp]
    # the mode trial's: a stop, blocks per warp and warps per CTA
    lib.uastc_mode_trial_split.argtypes = \
        lib.uastc_mode_trial.argtypes[:-1] + [ci, ci, ci, vp]
    for fn in (lib.xla_fma, lib.xla_reduce, lib.uastc_line_fit,
               lib.uastc_mode_trial, lib.uastc_subset_trial,
               lib.uastc_dualplane_trial, lib.uastc_subset_trial_split,
               lib.uastc_dualplane_trial_split, lib.uastc_mode_trial_split):
        fn.restype = ci
    return lib


def _declare_uastc_pack(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.uastc_pack.argtypes = [vp, vp, vp, ci, vp, ctypes.c_longlong, vp]
    lib.uastc_pack_split.argtypes = [vp, vp, vp, ci, vp, ctypes.c_longlong,
                                     ci, ci, vp]
    lib.uastc_pack.restype = lib.uastc_pack_split.restype = ci
    return lib


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.etc1s_factorized_scan.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.etc1s_factorized_scan_shortlist.argtypes = [vp, vp, vp, ci, ci, ci,
                                                    ci, vp]
    lib.etc1s_palette_errs_packed.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.etc1s_palette_errs.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.etc1s_find_best_selector_patterns.argtypes = [vp, vp, vp, vp, ci, ci,
                                                      vp]
    lib.etc1s_bisect_rows.argtypes = [vp, vp, vp, vp, ci, vp]
    lib.etc1s_bisect_round.argtypes = [vp, vp, vp, vp, vp, ci, vp]
    lib.etc1s_xla_cpu_min_k.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.etc1s_min_k_scratch_bytes.argtypes = [ci]
    lib.etc1s_min_k_scratch_bytes.restype = ctypes.c_longlong
    for fn in (lib.etc1s_factorized_scan, lib.etc1s_factorized_scan_shortlist,
               lib.etc1s_palette_errs_packed,
               lib.etc1s_palette_errs, lib.etc1s_find_best_selector_patterns,
               lib.etc1s_bisect_rows, lib.etc1s_bisect_round,
               lib.etc1s_xla_cpu_min_k):
        fn.restype = ci
    return declare_codebook(lib)


def declare_codebook(lib):
    """The C entries of `csrc/etc1s_codebook.h`'s kernels, which the
    tests also build for the host."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.etc1s_cross6_argmin.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.etc1s_cross6_distances.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.etc1s_cluster_scan_assemble.argtypes = [vp] * 11 + [ci, ci, vp]
    for fn in (lib.etc1s_cross6_argmin, lib.etc1s_cross6_distances,
               lib.etc1s_cluster_scan_assemble):
        fn.restype = ci
    return lib


def get_lib(name: str = "etc1s_kernels"):
    """The loaded library of csrc/<name>.cu (built on first call)."""
    with _lock:
        if name not in _libs:
            declare = {"xla_order_kernels": _declare_xla_order,
                       "uastc_pack_kernels": _declare_uastc_pack}.get(
                           name, _declare)
            _libs[name] = declare(ctypes.CDLL(str(library_path(name))))
        return _libs[name]
