"""Copy of `basis_universal_tpu/native.py`.

ctypes loader for the native C++ host runtime (native/slice_codec.cpp at the
repository root, the one C++ source both packages build).

Builds the shared library on first use into `build/native/` at the
repository root, keyed by the hash of the source; every entry point has a
bit-identical Python fallback in codecs/etc1s/{backend,stream}.py so the
framework degrades gracefully without a compiler.

The port's own host source `basis_universal_tpu_torch/csrc/host_sort.cpp`
(the refine shortlist in the tie order of the reference's `approx_min_k`
on XLA-CPU, with its header `xla_cpu_sort.h`) builds the same way, with
`get_host_sort()`; it has no fallback: a failed build or load raises.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading

_REPO = pathlib.Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "slice_codec.cpp"
_SORT_SRC = _REPO / "basis_universal_tpu_torch" / "csrc" / "host_sort.cpp"
_SORT_HEADER = _SORT_SRC.with_name("xla_cpu_sort.h")
_CACHE_DIR = _REPO / "build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def _build(src_path=_SRC, extra=(), headers=()) -> pathlib.Path:
    src = src_path.read_bytes() + b"".join(h.read_bytes() for h in headers)
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _CACHE_DIR / f"{src_path.stem}_{tag}.so"
    if out.exists():
        return out
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-funroll-loops",
         "-shared", "-fPIC", "-std=c++17", *extra,
         str(src_path), "-o", str(tmp)],
        check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """Returns the loaded CDLL or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _build()
            lib = ctypes.CDLL(str(path))
        except Exception as e:  # pragma: no cover - depends on toolchain
            print("[basis_universal_tpu_torch] native runtime unavailable: "
                  f"{e}", file=sys.stderr)
            _lib = None
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)

        lib.etc1s_collect_slice_symbols.restype = ctypes.c_int64
        lib.etc1s_collect_slice_symbols.argtypes = [
            i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i64p, i64p, i64p, i64p]

        lib.etc1s_emit_slice_bits.restype = ctypes.c_int64
        lib.etc1s_emit_slice_bits.argtypes = [
            i32p, i32p, ctypes.c_int64,
            u32p, u8p, u32p, u8p, u32p, u8p, u32p, u8p,
            u8p, ctypes.c_int64]

        lib.etc1s_rdo_pred_pass.restype = ctypes.c_int64
        lib.etc1s_rdo_pred_pass.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32,
            u8p, u8p, i32p,
            ctypes.c_int32, ctypes.c_float,
            u8p, u8p, i32p, ctypes.c_int32]

        lib.etc1s_rdo_collect_slice_symbols.restype = ctypes.c_int64
        lib.etc1s_rdo_collect_slice_symbols.argtypes = [
            i32p, i32p, u8p, u8p, ctypes.c_int32, ctypes.c_int32,
            u8p, i32p, u8p, u8p, u8p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_int32,
            i32p, i32p, i64p, i64p, i64p, i64p, ctypes.c_int32]

        lib.etc1s_pack_physical.restype = None
        lib.etc1s_pack_physical.argtypes = [
            i32p, i32p, ctypes.c_int64, u8p, u8p, u8p, u8p]

        lib.huffman_build.restype = ctypes.c_int64
        lib.huffman_build.argtypes = [
            i64p, ctypes.c_int32, ctypes.c_int32,
            u8p, u32p, u8p, ctypes.c_int64]

        lib.greedy_chain_order.restype = None
        lib.greedy_chain_order.argtypes = [u8p, ctypes.c_int32, i32p]

        lib.selector_chain_order.restype = None
        lib.selector_chain_order.argtypes = [u32p, ctypes.c_int32, i32p]

        lib.cooccurrence_order.restype = None
        lib.cooccurrence_order.argtypes = [
            i64p, ctypes.c_int64, i64p, ctypes.c_int32, i32p]

        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.exr_huf_decode.restype = ctypes.c_int32
        lib.exr_huf_decode.argtypes = [u8p, ctypes.c_int64,
                                       u16p, ctypes.c_int64]

        lib.etc1s_decode_slice.restype = ctypes.c_int32
        lib.etc1s_decode_slice.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, u8p, ctypes.c_int32,
            i32p, u8p, ctypes.c_int32,
            i32p, u8p, ctypes.c_int32,
            i32p, u8p, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p,
            i32p, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


_sort_lib = None


def get_host_sort():
    """The loaded library of csrc/host_sort.cpp (built on first call);
    raises if it cannot be built or loaded."""
    global _sort_lib
    with _lock:
        if _sort_lib is None:
            try:
                path = _build(_SORT_SRC, ("-pthread",), (_SORT_HEADER,))
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"g++ failed on {_SORT_SRC}: {e.stderr.decode()}") from e
            lib = ctypes.CDLL(str(path))
            lib.xla_cpu_min_k_rows.restype = ctypes.c_int
            lib.xla_cpu_min_k_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            _sort_lib = lib
        return _sort_lib
