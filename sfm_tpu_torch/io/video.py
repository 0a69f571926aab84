"""Frame sources, a numpy copy of ``sfm_tpu.io.video`` (cv::VideoCapture
replacement — SURVEY.md §2.13 I/O):
  - a directory of image files (PNG/JPG via PIL), sorted by name;
  - a .npy/.npz stack [T, H, W] or [T, H, W, 3];
  - a raw .y4m (YUV4MPEG2) file, parsed in Python (``Y4MSource``) or by
    the C++ runtime on a prefetch thread (``NativeY4MSource``).
All readers yield float32 grayscale [H, W] plus optional RGB [H, W, 3].
``open_source`` takes the choice of y4m reader as an argument; a runtime
that cannot be built raises rather than falling back."""

from __future__ import annotations

import ctypes
import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np


def to_gray(rgb: np.ndarray) -> np.ndarray:
    if rgb.ndim == 2:
        return rgb.astype(np.float32)
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2]).astype(np.float32)


class FrameSource:
    """Iterator of (gray [H,W] f32, rgb [H,W,3] u8 or None)."""

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        raise NotImplementedError


class ImageDirSource(FrameSource):
    def __init__(self, path: str, pattern: str = r"\.(png|jpe?g|bmp)$"):
        rx = re.compile(pattern, re.I)
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if rx.search(f))
        if not self.files:
            raise FileNotFoundError(f"no frames matching {pattern} in {path}")

    def __iter__(self):
        from PIL import Image
        for f in self.files:
            img = np.asarray(Image.open(f))
            if img.ndim == 3:
                yield to_gray(img), img[..., :3].astype(np.uint8)
            else:
                yield img.astype(np.float32), None


class NpyStackSource(FrameSource):
    def __init__(self, path: str, key: Optional[str] = None):
        if path.endswith(".npz"):
            z = np.load(path)
            self.stack = z[key or list(z.keys())[0]]
        else:
            self.stack = np.load(path)

    def __iter__(self):
        for fr in self.stack:
            if fr.ndim == 3:
                yield to_gray(fr), fr[..., :3].astype(np.uint8)
            else:
                yield fr.astype(np.float32), None


class Y4MSource(FrameSource):
    """Minimal YUV4MPEG2 parser (420/422/444 planar, 8-bit)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path, "rb") as f:
            header = f.readline().decode("latin-1").strip()
            if not header.startswith("YUV4MPEG2"):
                raise ValueError("not a y4m file")
            params = dict()
            for tok in header.split()[1:]:
                params[tok[0]] = tok[1:]
            w = int(params["W"]); h = int(params["H"])
            cs = params.get("C", "420")
            if cs.startswith("420"):
                cw, ch = w // 2, h // 2
            elif cs.startswith("422"):
                cw, ch = w // 2, h
            else:
                cw, ch = w, h
            frame_bytes = w * h + 2 * cw * ch
            while True:
                marker = f.readline()
                if not marker:
                    return
                if not marker.startswith(b"FRAME"):
                    return
                raw = f.read(frame_bytes)
                if len(raw) < frame_bytes:
                    return
                y = np.frombuffer(raw[:w * h], np.uint8).reshape(h, w)
                u = np.frombuffer(raw[w * h:w * h + cw * ch], np.uint8
                                  ).reshape(ch, cw)
                v = np.frombuffer(raw[w * h + cw * ch:], np.uint8
                                  ).reshape(ch, cw)
                if (ch, cw) != (h, w):
                    u = u.repeat(h // ch, 0).repeat(w // cw, 1)
                    v = v.repeat(h // ch, 0).repeat(w // cw, 1)
                yf = y.astype(np.float32)
                uf = u.astype(np.float32) - 128.0
                vf = v.astype(np.float32) - 128.0
                r = yf + 1.402 * vf
                g = yf - 0.344136 * uf - 0.714136 * vf
                b = yf + 1.772 * uf
                rgb = np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
                yield yf, rgb


class NativeY4MSource(FrameSource):
    """y4m via the C++ runtime (``io/runtime.py``): demux and YUV -> grey /
    RGB conversion on a background prefetch thread, so decode overlaps the
    engine's device work.  Bit-compatible with Y4MSource."""

    def __init__(self, path: str, prefetch: int = 4):
        from . import runtime
        self._lib = runtime.library()
        self.path = path
        self.prefetch = prefetch

    def __iter__(self):
        ct = ctypes
        h = self._lib.fs_open(self.path.encode(), self.prefetch)
        if not h:
            raise ValueError(f"not a y4m file: {self.path}")
        try:
            w = ct.c_int()
            ht = ct.c_int()
            fps = ct.c_double()
            self._lib.fs_info(h, ct.byref(w), ct.byref(ht), ct.byref(fps))
            W, H = w.value, ht.value
            while True:
                gray = np.empty((H, W), np.float32)
                rgb = np.empty((H, W, 3), np.uint8)
                ok = self._lib.fs_next(
                    h, gray.ctypes.data_as(ct.c_void_p),
                    rgb.ctypes.data_as(ct.c_void_p))
                if not ok:
                    return
                yield gray, rgb
        finally:
            self._lib.fs_close(h)


def open_source(path: str, native: bool = True) -> FrameSource:
    """The frame source for an image directory, a .npy/.npz stack or a
    .y4m file (the C++ reader when ``native``, else the Python one)."""
    if os.path.isdir(path):
        return ImageDirSource(path)
    if path.endswith((".npy", ".npz")):
        return NpyStackSource(path)
    if path.endswith(".y4m"):
        return NativeY4MSource(path) if native else Y4MSource(path)
    raise ValueError(f"unsupported frame source: {path} "
                     "(expected image dir, .npy/.npz, or .y4m)")
