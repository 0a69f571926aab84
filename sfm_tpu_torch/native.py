"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The ``nvcc``
processes of all sources start together and run in parallel.  The build
happens at first use, from the sources in this package only, into
``build/sfm_tpu_torch/<hash>`` at the repository root (git-ignored), keyed
on a hash of ``csrc/`` and the flags.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

Each wrapper counts its launches with ``count_launch``: it adds one where it
launches its kernel, and nowhere else, so a run can show that the main
path went through the kernels.  ``LAUNCHES`` holds the counts by kernel and
``STREAM_LAUNCHES`` by kernel and CUDA stream.  Kernels launch from more
than one thread (the pipeline's mapping worker, the server's connections),
so the counts and the first build are taken under locks."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "sfm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

LAUNCHES = {"hamming_match": 0, "patch_sampler": 0, "ba_linearize": 0,
            "schur_apply": 0, "schur_gather": 0, "schur_scatter": 0}
# (kernel, stream handle) -> launches
STREAM_LAUNCHES = {}
BUILD_INFO = {}
_lib = None
_build_lock = threading.Lock()
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry point -> (source stem in csrc/, argument types)
_SIGNATURES = {
    "sfm_hamming_match": ("match", [_P, _L] * 6 + [_I, _I, _I, _F, _F, _F, _F,
                                                   _I, _I, _D, _D]
                          + [_P] * 8),
    "sfm_extract_patches": ("patches", [_P, _I, _I, _I, _P, _P, _I, _P, _P]),
    "sfm_ba_linearize": ("linearize", [_P] * 11 + [_I, _I, _I, _F]
                         + [_P] * 7),
    "sfm_schur_apply": ("schur", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _P, _P, _P, _P]),
}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        STREAM_LAUNCHES.clear()


def count_launch(name: str, stream: ctypes.c_void_p) -> None:
    """One launch of kernel ``name`` on ``stream`` (the handle the wrapper
    passed to it)."""
    key = (name, stream.value or 0)
    with _count_lock:
        LAUNCHES[name] += 1
        STREAM_LAUNCHES[key] = STREAM_LAUNCHES.get(key, 0) + 1


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
    """Compile every csrc/*.cu into its cached shared library, one ``nvcc``
    per source, all started together; returns the build directory.
    ``BUILD_INFO`` records the wall seconds and the compilers' reports."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(_CSRC.iterdir()):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in sources}
    if all(p.exists() for p in libs.values()):
        BUILD_INFO.update(seconds=0.0, cached=True, path=str(out_dir))
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for s in sources:
        tmp = out_dir / (f"lib{s.stem}.{os.getpid()}."
                         f"{threading.get_ident()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(s)]
        procs.append((s.stem, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failed = [], []
    for stem, tmp, cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
            continue
        os.replace(tmp, libs[stem])  # atomic: no reader sees half a file
        reports.append(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(out_dir), ptxas="".join(reports))
    return out_dir


class _Library:
    """The C entry points of every kernel library, as attributes."""

    def __init__(self, out_dir: Path):
        loaded = {}
        for name, (stem, argtypes) in _SIGNATURES.items():
            if stem not in loaded:
                loaded[stem] = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
            fn = getattr(loaded[stem], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def library() -> _Library:
    """The loaded kernel libraries (built on first call; a caller on
    another thread meanwhile waits for that build)."""
    global _lib
    if _lib is None:
        with _build_lock:
            if _lib is None:
                _lib = _Library(build())
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


# the BA kernels (K2, K3) take 1..256 observation slots per landmark
MAX_KMAX = 256


def check_kmax(kmax: int) -> None:
    if not 1 <= kmax <= MAX_KMAX:
        raise ValueError(f"kmax={kmax}: the BA kernels take 1..{MAX_KMAX} "
                         "observation slots per landmark")
