"""Build and load the hand-written CUDA kernels under ``csrc/``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds).  The build happens at first use,
from the sources in this package only, into ``build/sfm_tpu_torch/<hash>``
at the repository root (git-ignored), keyed on a hash of the sources and
the flags.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.

Each wrapper keeps a launch count in ``LAUNCHES``: it adds one where it
launches its kernel, and nowhere else, so a run can show that the main
path went through the kernels."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "sfm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

LAUNCHES = {"hamming_match": 0, "patch_sampler": 0}
BUILD_INFO = {}
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sfm_hamming_match": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                          _P, _P, _P, _P, _P],
    "sfm_extract_patches": [_P, _I, _I, _P, _P, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile csrc/*.cu into the cached shared library; returns its path.
    ``BUILD_INFO`` records the seconds spent and the compiler's report."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libsfm_kernels.so"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, path=str(lib))
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libsfm_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    BUILD_INFO.update(seconds=secs, cached=False, path=str(lib),
                      ptxas=proc.stderr)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def require_cuda(name: str, t, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` where given; None entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
