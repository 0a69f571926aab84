"""Point-cloud export: add points, centre, scale, normalise, and write or
read a binary PLY.

Each operation has two versions: the C++ runtime (``io/runtime.py``, the
JAX package's ``sfm_tpu/native/pointcloud.cpp``) and numpy.  The caller
picks one with ``native``; a runtime that cannot be built raises rather
than falling back.  Both write the same bytes."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import runtime


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PointCloud:
    """Mutable host-side cloud.  ``native`` picks the C++ runtime (True)
    or numpy (False) for every operation."""

    def __init__(self, xyz: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None, native: bool = True):
        self.native = native
        self.xyz = np.ascontiguousarray(
            np.zeros((0, 3), np.float32) if xyz is None else
            np.asarray(xyz, np.float32))
        self.colors = None if colors is None else np.ascontiguousarray(
            np.asarray(colors, np.uint8))

    def add_points(self, xyz: np.ndarray,
                   colors: Optional[np.ndarray] = None):
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        self.xyz = np.ascontiguousarray(np.concatenate([self.xyz, xyz]))
        if colors is not None:
            cur = self.colors if self.colors is not None else \
                np.zeros((0, 3), np.uint8)
            self.colors = np.ascontiguousarray(
                np.concatenate([cur, np.asarray(colors, np.uint8)
                                .reshape(-1, 3)]))
        return self

    def center(self):
        if not len(self.xyz):
            return self
        if self.native:
            runtime.library().pc_center(_fptr(self.xyz), len(self.xyz))
        else:
            self.xyz -= self.xyz.mean(0, keepdims=True)
        return self

    def scale(self, target: float = 500.0):
        if not len(self.xyz):
            return self
        if self.native:
            runtime.library().pc_scale(_fptr(self.xyz), len(self.xyz),
                                       float(target))
        else:
            mx = np.abs(self.xyz).max()
            if mx > 0:
                self.xyz *= target / mx
        return self

    def normalize(self):
        if not len(self.xyz):
            return self
        if self.native:
            runtime.library().pc_normalize(_fptr(self.xyz), len(self.xyz))
        else:
            rms = np.sqrt((self.xyz ** 2).sum(1).mean())
            if rms > 0:
                self.xyz /= rms
        return self

    def write_ply(self, path: str):
        if self.native:
            cptr = (self.colors.ctypes.data_as(ctypes.c_void_p)
                    if self.colors is not None else None)
            rc = runtime.library().pc_write_ply(
                str(path).encode(), _fptr(self.xyz), cptr, len(self.xyz))
            if rc != 0:
                raise IOError(f"native PLY write failed (code {rc})")
            return self
        with open(path, "wb") as f:
            has_c = self.colors is not None
            hdr = ("ply\nformat binary_little_endian 1.0\n"
                   f"element vertex {len(self.xyz)}\n"
                   "property float x\nproperty float y\nproperty float z\n"
                   + ("property uchar red\nproperty uchar green\n"
                      "property uchar blue\n" if has_c else "")
                   + "end_header\n")
            f.write(hdr.encode())
            if has_c:
                rec = np.zeros(len(self.xyz),
                               dtype=[("xyz", np.float32, 3),
                                      ("rgb", np.uint8, 3)])
                rec["xyz"] = self.xyz
                rec["rgb"] = self.colors
                f.write(rec.tobytes())
            else:
                f.write(self.xyz.astype("<f4").tobytes())
        return self


def _header(path):
    """(vertex count, has colour) from a PLY header."""
    with open(path, "rb") as f:
        head = f.read(4096).decode("latin-1").split("end_header")[0]
    n = int([ln for ln in head.splitlines()
             if ln.startswith("element vertex")][0].split()[-1])
    return n, "property uchar red" in head


def read_ply(path: str, max_points: int = 10_000_000, native: bool = True):
    """Read a PLY written by this module.  Returns (xyz, colors or None).
    A file of more than ``max_points`` points is refused (IOError), as the
    C++ runtime refuses it; no more than the header's count is read."""
    n, has_c = _header(path)
    if n > max_points:
        raise IOError(f"PLY read failed: {path} holds {n} points, more "
                      f"than max_points={max_points}")
    if native:
        xyz = np.zeros((n, 3), np.float32)
        rgb = np.zeros((n, 3), np.uint8)
        got = runtime.library().pc_read_ply(
            str(path).encode(), _fptr(xyz),
            rgb.ctypes.data_as(ctypes.c_void_p), n)
        if got != n:
            raise IOError(f"native PLY read failed: {path} ({got} of {n} "
                          "points)")
        return xyz, (rgb if has_c else None)
    with open(path, "rb") as f:
        body = f.read().partition(b"end_header\n")[2]
    if has_c:
        rec = np.frombuffer(body, dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)], count=n)
        return rec["xyz"].copy(), rec["rgb"].copy()
    xyz = np.frombuffer(body, dtype="<f4", count=3 * n).reshape(n, 3)
    return xyz.copy(), None
