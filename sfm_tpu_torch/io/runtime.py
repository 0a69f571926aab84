"""Build and load the C++ host runtime: point-cloud export
(``pc_*``) and the prefetching y4m frame source (``fs_*``).

The sources are the JAX package's ``sfm_tpu/native/pointcloud.cpp`` and
``framesource.cpp``, read where they stand.  They are compiled with the
host C++ compiler (``$CXX``, else ``c++``) and the flags of their Makefile
at first use into ``build/sfm_tpu_torch/<hash>/libsfm_native.so`` at the
repository root (git-ignored), keyed on a hash of the sources and flags,
and loaded with ``ctypes``.  Nothing runs at import time, and a failed
build raises: callers choose the numpy versions explicitly instead."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_SOURCES = tuple(_ROOT / "sfm_tpu" / "native" / n
                 for n in ("pointcloud.cpp", "framesource.cpp"))
_BUILD_ROOT = _ROOT / "build" / "sfm_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib = None

_P = ctypes.c_void_p
_FP = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)
# C entry point -> (argument types, return type)
_SIGNATURES = {
    "pc_center": ([_FP, _I64], None),
    "pc_scale": ([_FP, _I64, ctypes.c_float], ctypes.c_float),
    "pc_normalize": ([_FP, _I64], None),
    "pc_write_ply": ([ctypes.c_char_p, _FP, _P, _I64], ctypes.c_int),
    "pc_read_ply": ([ctypes.c_char_p, _FP, _P, _I64], _I64),
    "fs_open": ([ctypes.c_char_p, ctypes.c_int], _P),
    "fs_info": ([_P, _IP, _IP, ctypes.POINTER(ctypes.c_double)], None),
    "fs_next": ([_P, _P, _P], ctypes.c_int),
    "fs_close": ([_P], None),
}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or install c++ "
                           "(the native runtime is built from "
                           "sfm_tpu/native/*.cpp)")
    return cxx


def build() -> Path:
    """Compile the runtime into its cached shared library (once per hash
    of the sources and flags); returns the library's path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in _SOURCES:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _BUILD_ROOT / h.hexdigest()[:16] / "libsfm_native.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libsfm_native.{os.getpid()}.so")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(s) for s in _SOURCES), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native runtime build failed ({proc.returncode})"
                           f":\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: no reader sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded runtime (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
