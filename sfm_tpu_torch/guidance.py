"""Scan guidance: object centroid, colour-histogram segmentation and an
oriented bounding box, as image ops on the engine's device.

Per RUNNING RGB frame: the 3D centroid of the live map; all landmarks
projected (clamped to the image); the image downscaled; a convex-hull mask
of the projections; a Hue-Saturation histogram inside the mask, EMA-blended
with its history; back-projection thresholded by backproj / hull area; and
an oriented box from the principal axes of the segmented pixels.

As in the JAX package, the hull is a support-function polygon over 32
fixed directions and the box is a PCA box.  The 2x2 covariance is
diagonalised in closed form (no solver call, no host read); its axes are
fixed only up to sign, which nothing downstream sees (the extent takes
absolute values and the box is symmetric)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .config import SfMConfig
from .geometry.camera import project
from .mapstore import _Tree
from .utils.profiling import count

_N_HULL_DIRS = 32


@dataclasses.dataclass
class GuidanceState(_Tree):
    centroid: torch.Tensor     # [3] object centroid
    hist: torch.Tensor         # [bins_h, bins_s] EMA H-S histogram
    initialized: torch.Tensor  # [] bool


class GuidanceOutput(NamedTuple):
    centroid: torch.Tensor     # [3]
    bbox_center: torch.Tensor  # [2] full-resolution pixels
    bbox_axes: torch.Tensor    # [2, 2] principal axes (rows, unit)
    bbox_extent: torch.Tensor  # [2] half-lengths along the axes, pixels
    mask: torch.Tensor         # [H/ds, W/ds] float segmentation


def init_guidance(cfg: SfMConfig, device) -> GuidanceState:
    count("implicit_sync")  # initialized's copy to the card
    return GuidanceState(
        centroid=torch.zeros(3, device=device),
        hist=torch.zeros((cfg.guidance_hist_bins_h, cfg.guidance_hist_bins_s),
                         device=device),
        initialized=torch.tensor(False, device=device))


def rgb_to_hs(rgb: torch.Tensor):
    """RGB [..., 3] in [0, 255] -> (hue [0, 360), saturation [0, 1])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe_c = torch.where(c < 1e-6, 1.0, c)
    # the hue of a red maximum is a floor modulo (a negative g - b wraps)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe_c, 6.0),
        torch.where(mx == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    h = torch.where(c < 1e-6, 0.0, h * 60.0)
    s = torch.where(mx < 1e-6, 0.0, c / torch.clamp(mx, min=1e-6))
    return h, s


def _hull_dirs(device) -> torch.Tensor:
    th = 2.0 * np.pi * np.arange(_N_HULL_DIRS) / _N_HULL_DIRS
    return torch.as_tensor(np.stack([np.cos(th), np.sin(th)], -1)
                           .astype(np.float32), device=device)   # [D, 2]


def _grid(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def hull_mask(points: torch.Tensor, valid: torch.Tensor, h: int, w: int
              ) -> torch.Tensor:
    """Convex-hull mask [h, w] of the valid 2D points [N, 2] via support
    functions; empty with fewer than 3 valid points."""
    dirs = _hull_dirs(points.device)
    proj = points @ dirs.T                                   # [N, D]
    support = torch.where(valid[:, None], proj, -1e9).amax(0)  # [D]
    yy, xx = _grid(h, w, points.device)
    pix = torch.stack([xx, yy], -1)                          # [h, w, 2]
    inside = (pix @ dirs.T <= support + 0.5).all(-1)
    return inside & (valid.sum() >= 3)


def _downscale(img: torch.Tensor, ds: int) -> torch.Tensor:
    h, w = img.shape[:2]
    hh, ww = h // ds, w // ds
    crop = img[:hh * ds, :ww * ds]
    return crop.reshape(hh, ds, ww, ds, *img.shape[2:]).mean((1, 3))


def _principal_axes(cov: torch.Tensor) -> torch.Tensor:
    """Rows: the unit eigenvectors of a symmetric 2x2 matrix, major first.
    An isotropic matrix gets the axes that a symmetric eigensolver returns
    for it (y first: the eigenvalues tie and the order is kept)."""
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    th = 0.5 * torch.atan2(2.0 * b, a - c)
    ct, st = torch.cos(th), torch.sin(th)
    axes = torch.stack([torch.stack([ct, st]), torch.stack([-st, ct])])
    iso = (a == c) & (b == 0)
    swap = torch.tensor([[0.0, 1.0], [1.0, 0.0]], device=cov.device)
    return torch.where(iso, swap, axes)


def update_guidance(cfg: SfMConfig, state: GuidanceState, rgb: torch.Tensor,
                    lms_xyz: torch.Tensor, lms_valid: torch.Tensor,
                    K: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor):
    """One guidance update.  rgb: [H, W, 3] float in [0, 255].  Returns
    (state, GuidanceOutput)."""
    ds = cfg.guidance_downscale
    H, W = cfg.image_size
    hh, ww = H // ds, W // ds
    nb_h, nb_s = cfg.guidance_hist_bins_h, cfg.guidance_hist_bins_s
    dev = rgb.device

    # centroid: the plain mean of the live map, every frame
    n = torch.clamp(lms_valid.sum(), min=1)
    centroid = torch.where(lms_valid[:, None], lms_xyz, 0.0).sum(0) / n

    # landmarks projected and clamped to the image
    uv = project(K, rvec, tvec, lms_xyz)
    uv = torch.stack([torch.clamp(uv[:, 0], 0.0, W - 1.0),
                      torch.clamp(uv[:, 1], 0.0, H - 1.0)], -1)

    small = _downscale(rgb, ds)
    mask = hull_mask(uv / ds, lms_valid, hh, ww)
    hull_area = torch.clamp(mask.sum().to(torch.float32), min=1.0)

    # H-S histogram of the pixels inside the mask (raw counts: the
    # threshold below expects count scale); bins truncate toward zero.  The
    # hue scale is one float32 constant, as XLA folds the JAX package's
    # ``hch / 360.0 * nb_h`` (the exact division puts a hue just below a
    # bin edge in the bin beneath)
    hch, sch = rgb_to_hs(small)
    hb = torch.clamp((hch * (nb_h / 360.0)).to(torch.int64), 0, nb_h - 1)
    sb = torch.clamp((sch * nb_s).to(torch.int64), 0, nb_s - 1)
    flat_bin = (hb * nb_s + sb).reshape(-1)
    hist = torch.zeros(nb_h * nb_s, device=dev).index_add(
        0, flat_bin, mask.reshape(-1).to(torch.float32)).reshape(nb_h, nb_s)

    # the EMA blend with one rounding of a * old + new, as the fused
    # multiply-add that XLA makes of the JAX package's blend (float64 holds
    # the float32 product exactly)
    a = float(np.float32(cfg.guidance_ema_alpha))
    blend = (a * state.hist.double() + ((1 - cfg.guidance_ema_alpha) * hist)
             .double()).float()
    hist = torch.where(state.initialized, blend, hist)

    # back-projection and threshold
    backproj = hist.reshape(-1)[flat_bin].reshape(hh, ww)
    obj = ((backproj / hull_area) > cfg.guidance_backproj_threshold) & mask

    # oriented box from the principal axes of the segmented pixels
    yy, xx = _grid(hh, ww, dev)
    wobj = obj.to(torch.float32)
    m = torch.clamp(wobj.sum(), min=1.0)
    cx = (xx * wobj).sum() / m
    cy = (yy * wobj).sum() / m
    dx = (xx - cx) * wobj
    dy = (yy - cy) * wobj
    sxy = (dx * dy).sum()
    cov = torch.stack([torch.stack([(dx * dx).sum(), sxy]),
                       torch.stack([sxy, (dy * dy).sum()])]) / m
    axes = _principal_axes(cov)
    along = torch.stack([xx - cx, yy - cy], -1) @ axes.T    # [hh, ww, 2]
    ext = torch.where(obj[..., None], torch.abs(along), 0.0).amax((0, 1))

    out = GuidanceOutput(
        centroid=centroid,
        bbox_center=torch.stack([cx, cy]) * ds + (ds - 1) / 2.0,
        bbox_axes=axes, bbox_extent=ext * ds, mask=wobj)
    new_state = GuidanceState(centroid=centroid, hist=hist,
                              initialized=torch.tensor(True, device=dev))
    return new_state, out
