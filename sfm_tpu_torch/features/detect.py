"""Scale-space FAST corner detection -> fixed-size keypoint tensor.

Pyramid canvas (every level side by side in one [H, sum(W >> l)] image),
dense FAST-9/16 score, non-max suppression, a global top-K and subpixel
refinement.  The arithmetic follows the JAX package step for step, so the
canvas, the scores and the keypoints agree exactly on the same image."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import count

# FAST-16 Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
_CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
           (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3),
           (-2, -2), (-3, -1))


class Keypoints(NamedTuple):
    """Leaves [N, ...], or [B, N, ...] for a batch of images."""
    xy: torch.Tensor      # [N, 2] full-resolution (x, y) pixel coords
    score: torch.Tensor   # [N] detector response
    level: torch.Tensor   # [N] int32 pyramid level
    valid: torch.Tensor   # [N] bool


class CanvasLayout(NamedTuple):
    """Static geometry of the side-by-side pyramid canvas: level l occupies
    columns [offsets[l], offsets[l] + W >> l), top-aligned."""
    offsets: tuple
    width: int
    heights: tuple
    widths: tuple
    inside: np.ndarray       # [H, width] f32 detection-border mask
    lvl_of_col: np.ndarray   # [width] int32
    xoff_of_col: np.ndarray  # [width] int32


_LAYOUTS = {}


def canvas_layout(H: int, W: int, levels: int, border: int = 20
                  ) -> CanvasLayout:
    key = (H, W, levels, border)
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    offsets, heights, widths = [], [], []
    off, h, w = 0, H, W
    for _ in range(levels):
        offsets.append(off)
        heights.append(h)
        widths.append(w)
        off += w
        h, w = h // 2, w // 2
    inside = np.zeros((H, off), np.float32)
    lvl_of_col = np.zeros(off, np.int32)
    xoff_of_col = np.zeros(off, np.int32)
    for l in range(levels):
        o, h, w = offsets[l], heights[l], widths[l]
        inside[border:h - border, o + border:o + w - border] = 1.0
        lvl_of_col[o:o + w] = l
        xoff_of_col[o:o + w] = o
    _LAYOUTS[key] = CanvasLayout(tuple(offsets), off, tuple(heights),
                                 tuple(widths), inside, lvl_of_col,
                                 xoff_of_col)
    return _LAYOUTS[key]


def _down2(cur: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample of [..., h, w]: rows first, then columns (each
    0.5 a + 0.5 b, the values the JAX package's averaging matmuls
    produce)."""
    h, w = cur.shape[-2:]
    cur = cur[..., :h // 2 * 2, :w // 2 * 2]
    rows = 0.5 * cur[..., 0::2, :] + 0.5 * cur[..., 1::2, :]
    return 0.5 * rows[..., 0::2] + 0.5 * rows[..., 1::2]


def build_canvas(img: torch.Tensor, levels: int) -> torch.Tensor:
    """Grey image(s) [..., H, W] -> side-by-side pyramid canvas
    [..., H, sum(W >> l)] (zero padding below shorter levels)."""
    H = img.shape[-2]
    cols = [img]
    cur = img
    for _ in range(levels - 1):
        cur = _down2(cur)
        cols.append(F.pad(cur, (0, 0, 0, H - cur.shape[-2])))
    return torch.cat(cols, dim=-1)


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img [..., H, W] shifted by (dy, dx) with edge replication."""
    H, W = img.shape[-2:]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 response [..., H, W]: a pixel is a corner when >= 9
    contiguous circle pixels are all brighter than centre + t or all darker
    than centre - t; the score is the sum of thresholded absolute
    differences over the circle, gated by the corner test."""
    shifted = [_shifted(img, dy, dx) for dy, dx in _CIRCLE]
    bright = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    for k, s in enumerate(shifted):
        diff = s - img
        bright = bright | ((diff > threshold).to(torch.int32) << k)
        dark = dark | ((-diff > threshold).to(torch.int32) << k)

    def has_run(m):
        # circular run of >= 9 set bits among the low 16
        m2 = m | (m << 16)
        a = m2 & (m2 >> 1)
        a = a & (a >> 2)
        a = a & (a >> 4)
        a = a & (m2 >> 8)
        return (a & 0xFFFF) != 0

    corner = has_run(bright) | has_run(dark)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = zero
    for s in shifted:
        score = score + torch.maximum(torch.abs(s - img) - threshold, zero)
    return torch.where(corner, score, zero)


def shi_tomasi_score(img: torch.Tensor, sigma_window: int = 3
                     ) -> torch.Tensor:
    """Dense minimum-eigenvalue corner response of img [H, W] (the
    goodFeaturesToTrack analogue): central differences with wrap-around
    at the border, structure tensor summed over a ``sigma_window`` box
    with zero padding."""
    dx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    dy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    k = sigma_window
    lo, hi = (k - 1) // 2, k // 2
    w = torch.full((1, 1, k, k), 1.0 / (k * k), dtype=img.dtype,
                   device=img.device)

    def box(x):
        return F.conv2d(F.pad(x[None, None], (lo, hi, lo, hi)), w)[0, 0]

    a, b, c = box(dx * dx), box(dx * dy), box(dy * dy)
    tr = a + c
    det = a * c - b * b
    return tr / 2.0 - torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))


def nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Suppress non-maxima of [..., H, W] within a (2r+1)^2 window (ties
    keep all)."""
    k = 2 * radius + 1
    planes = score.reshape(-1, 1, *score.shape[-2:])
    pooled = F.max_pool2d(planes, k, stride=1,
                          padding=radius).reshape(score.shape)
    return torch.where(score >= pooled, score, torch.zeros_like(score))


def detect(img: torch.Tensor, *, max_keypoints: int, levels: int = 4,
           threshold: float = 20.0, nms_radius: int = 2, border: int = 20,
           return_canvas: bool = False):
    """Pyramid canvas -> FAST -> NMS -> top-K per image -> subpixel
    refinement, for one image [H, W] or a batch [B, H, W] (each image's
    keypoints as ``detect`` of that image alone gives them; the leaves
    then have a leading B).  Keypoints are full-resolution (distorted)
    pixel coords sorted by descending score; equal scores keep canvas
    order (the reference's top-k order)."""
    batched = img.dim() == 3
    imgs = img if batched else img[None]
    B, H, W = imgs.shape
    lay = canvas_layout(H, W, levels, border)
    dev = img.device
    canvas = build_canvas(imgs, levels)
    WC = lay.width
    raw = fast_score(canvas, threshold)
    count("implicit_sync", 4)  # the layout's four tables copied to the card
    s = nms(raw, nms_radius) * torch.as_tensor(lay.inside, device=dev)
    # tie-break equal scores toward finer pyramid levels
    bias = torch.as_tensor(
        1e-3 * (levels - 1 - lay.lvl_of_col)[None, :].astype(np.float32),
        device=dev)
    s = torch.where(s > 0, s + bias, torch.zeros_like(s))
    top_vals, idx = torch.sort(s.reshape(B, -1), dim=-1, descending=True,
                               stable=True)
    top_vals, idx = top_vals[:, :max_keypoints], idx[:, :max_keypoints]
    yi = idx // WC
    xc = idx % WC
    sel_lvl = torch.as_tensor(lay.lvl_of_col, device=dev)[xc]
    xi = xc - torch.as_tensor(lay.xoff_of_col, device=dev)[xc]

    # subpixel: 1D quadratic fit on the pre-NMS score along each axis
    raw_flat = raw.reshape(B, -1)

    def at(y, x):
        return torch.gather(raw_flat, 1, y * WC + x)

    s0 = at(yi, xc)
    sl = at(yi, torch.clamp(xc - 1, min=0))
    sr = at(yi, torch.clamp(xc + 1, max=WC - 1))
    su = at(torch.clamp(yi - 1, min=0), xc)
    sd = at(torch.clamp(yi + 1, max=H - 1), xc)
    cx = sl + sr - 2 * s0
    cy = su + sd - 2 * s0
    zero = torch.zeros_like(cx)
    dx = torch.where(torch.abs(cx) > 1e-6, (sl - sr) / (2 * cx), zero)
    dy = torch.where(torch.abs(cy) > 1e-6, (su - sd) / (2 * cy), zero)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    y = yi.to(torch.float32) + dy
    x = xi.to(torch.float32) + dx
    scale = torch.exp2(sel_lvl.to(torch.float32))
    xy = torch.stack([x * scale + 0.5 * (scale - 1.0),
                      y * scale + 0.5 * (scale - 1.0)], dim=-1)
    kps = Keypoints(xy=xy, score=top_vals, level=sel_lvl.to(torch.int32),
                    valid=top_vals > 0.0)
    if not batched:
        kps, canvas = Keypoints(*(t[0] for t in kps)), canvas[0]
    if return_canvas:
        return kps, canvas
    return kps
