"""Debug visualization, a numpy copy of ``sfm_tpu.viz`` (the reference's
always-on overlay + optional video writer, CSfM.cpp:91-104, 780-796;
Display2D::drawRotatedRectangle / display3DProjections — SURVEY.md §2.9).

Host-side numpy drawing (keypoints, reprojected landmarks, guidance bbox,
status banner) plus a Y4M video writer (no OpenCV/ffmpeg in the image; Y4M
is raw and every player/ffmpeg elsewhere reads it)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_rgb(gray_or_rgb: np.ndarray) -> np.ndarray:
    img = np.asarray(gray_or_rgb)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.clip(img, 0, 255).astype(np.uint8).copy()


def draw_points(img: np.ndarray, xy: np.ndarray, color=(0, 255, 0),
                radius: int = 2, mask: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """Draw square markers at xy [N,2] (x, y)."""
    out = _to_rgb(img)
    h, w = out.shape[:2]
    xy = np.asarray(xy)
    if mask is None:
        mask = np.ones(len(xy), bool)
    for (x, y), ok in zip(xy.astype(int), np.asarray(mask)):
        if not ok or not (0 <= x < w and 0 <= y < h):
            continue
        x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
        y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
        out[y0:y1, x0:x1] = color
    return out


def draw_line(img: np.ndarray, p0, p1, color=(255, 255, 0)) -> np.ndarray:
    """Bresenham-ish line via dense sampling."""
    out = _to_rgb(img)
    h, w = out.shape[:2]
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    n = int(np.abs(p1 - p0).max()) + 1
    for t in np.linspace(0.0, 1.0, n):
        x, y = (p0 + t * (p1 - p0)).astype(int)
        if 0 <= x < w and 0 <= y < h:
            out[y, x] = color
    return out


def draw_rotated_rect(img: np.ndarray, center, axes, extent,
                      color=(255, 128, 0)) -> np.ndarray:
    """Display2D::drawRotatedRectangle equivalent: oriented box from the
    guidance output (center [2], axes [2,2] rows, extent [2])."""
    c = np.asarray(center, float)
    a0 = np.asarray(axes, float)[0] * float(extent[0])
    a1 = np.asarray(axes, float)[1] * float(extent[1])
    corners = [c + a0 + a1, c + a0 - a1, c - a0 - a1, c - a0 + a1]
    out = img
    for i in range(4):
        out = draw_line(out, corners[i], corners[(i + 1) % 4], color)
    return out


def overlay_frame(gray: np.ndarray, metrics: dict,
                  reproj_xy: Optional[np.ndarray] = None,
                  reproj_mask: Optional[np.ndarray] = None,
                  kp_xy: Optional[np.ndarray] = None,
                  kp_mask: Optional[np.ndarray] = None,
                  guidance=None) -> np.ndarray:
    """The per-frame debug overlay: detected keypoints (green), reprojected
    map points (red), guidance bbox (orange), status text as a color strip
    (green RUNNING / yellow INIT / red LOST)."""
    out = _to_rgb(gray)
    if kp_xy is not None:
        out = draw_points(out, kp_xy, (0, 255, 0), 1, kp_mask)
    if reproj_xy is not None:
        out = draw_points(out, reproj_xy, (255, 0, 0), 2, reproj_mask)
    if guidance is not None:
        out = draw_rotated_rect(out, np.asarray(guidance.bbox_center),
                                np.asarray(guidance.bbox_axes),
                                np.asarray(guidance.bbox_extent))
    status = int(metrics.get("status", 0))
    band = {0: (255, 255, 0), 1: (0, 200, 0), 2: (255, 0, 0)}[status]
    out[:6, :] = band
    return out


class Y4MWriter:
    """Debug video writer (startVideoOutput equivalent; the reference wrote
    25 fps at 0.5x scale, CSfM.cpp:780-796)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 scale: float = 0.5):
        self.scale = scale
        self.w = int(width * scale) // 2 * 2
        self.h = int(height * scale) // 2 * 2
        self.f = open(path, "wb")
        self.f.write(f"YUV4MPEG2 W{self.w} H{self.h} F{fps}:1 Ip A1:1 "
                     "C444\n".encode())

    def write(self, rgb: np.ndarray):
        img = _to_rgb(rgb).astype(np.float32)
        if self.scale != 1.0:
            ys = (np.arange(self.h) / self.scale).astype(int)
            xs = (np.arange(self.w) / self.scale).astype(int)
            img = img[np.clip(ys, 0, img.shape[0] - 1)][:,
                      np.clip(xs, 0, img.shape[1] - 1)]
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        self.f.write(b"FRAME\n")
        for plane in (y, u, v):
            self.f.write(np.clip(plane, 0, 255).astype(np.uint8).tobytes())

    def close(self):
        self.f.close()
