"""Pinhole camera model: projection, distortion, undistortion.

Poses are world-to-camera (x_cam = R x_world + t).  The pipeline works in
the undistorted pinhole model ``Kopt``; distortion is OpenCV's
radial-tangential (k1, k2, p1, p2, k3).  Functions broadcast over leading
dimensions: a batch of poses [B, 3] against points [N, 3] gives [B, N]."""

from __future__ import annotations

import numpy as np
import torch

from .rotations import exp_so3


def apply_intrinsics(K: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    z = cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9,
                    torch.where(z < 0, -1e-9, 1e-9).to(z.dtype), z)
    xy = cam[..., :2] / z
    fx, fy, cx, cy, skew = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    u = fx * xy[..., 0] + skew * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def to_camera(rvec, tvec, xyz):
    """World points [..., N, 3] into the camera frame of pose(s) [..., 3]."""
    R = exp_so3(rvec)
    return xyz @ R.transpose(-1, -2) + tvec[..., None, :]


def project(K, rvec, tvec, xyz) -> torch.Tensor:
    """Project world points [..., N, 3] -> pixels [..., N, 2]."""
    return apply_intrinsics(K, to_camera(rvec, tvec, xyz))


def depths(rvec, tvec, xyz) -> torch.Tensor:
    """Camera-frame depth (z) of world points [..., N]."""
    R = exp_so3(rvec)
    return (xyz @ R[..., 2, :, None])[..., 0] + tvec[..., 2:3]


def pixel_to_norm(K, uv):
    fx, fy, cx, cy, skew = K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[0, 1]
    y = (uv[..., 1] - cy) / fy
    x = (uv[..., 0] - cx - skew * y) / fx
    return torch.stack([x, y], dim=-1)


def undistort_norm(d, xy_dist, iters: int = 8):
    """Invert the distortion by fixed-point iteration (as
    cv::undistortPoints does)."""
    k1, k2, p1, p2, k3 = d[0], d[1], d[2], d[3], d[4]
    xy = xy_dist
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_dist[..., 0] - dx) / radial,
                          (xy_dist[..., 1] - dy) / radial], dim=-1)
    return xy


def undistort_pixels(K, d, Kopt, uv):
    """Distorted pixels (under K, d) -> undistorted pixels under Kopt."""
    norm = undistort_norm(d, pixel_to_norm(K, uv))
    cam = torch.cat([norm, torch.ones_like(norm[..., :1])], dim=-1)
    return apply_intrinsics(Kopt, cam)


def optimal_new_camera_matrix(K, d, image_size, alpha: float = 0.0):
    """Host-side analogue of cv::getOptimalNewCameraMatrix (numpy): fit the
    new K so the inner (alpha=0) or outer (alpha=1) rectangle of the
    undistorted image border maps to the image."""
    K = np.asarray(K, np.float32)
    h, w = image_size
    n = 32
    xs = np.linspace(0, w - 1, n)
    ys = np.linspace(0, h - 1, n)
    border = np.concatenate([
        np.stack([xs, np.zeros(n)], -1),
        np.stack([xs, np.full(n, h - 1.0)], -1),
        np.stack([np.zeros(n), ys], -1),
        np.stack([np.full(n, w - 1.0), ys], -1),
    ]).astype(np.float32)
    norm = undistort_norm(
        torch.as_tensor(np.asarray(d, np.float32)),
        pixel_to_norm(torch.as_tensor(K), torch.as_tensor(border))).numpy()
    x0o, x1o = norm[:, 0].min(), norm[:, 0].max()
    y0o, y1o = norm[:, 1].min(), norm[:, 1].max()
    top, bot = norm[0:n], norm[n:2 * n]
    left, right = norm[2 * n:3 * n], norm[3 * n:4 * n]
    x0i, x1i = left[:, 0].max(), right[:, 0].min()
    y0i, y1i = top[:, 1].max(), bot[:, 1].min()
    x0 = alpha * x0o + (1 - alpha) * x0i
    x1 = alpha * x1o + (1 - alpha) * x1i
    y0 = alpha * y0o + (1 - alpha) * y0i
    y1 = alpha * y1o + (1 - alpha) * y1i
    fxn = (w - 1) / (x1 - x0)
    fyn = (h - 1) / (y1 - y0)
    return np.array([[fxn, 0, -x0 * fxn], [0, fyn, -y0 * fyn], [0, 0, 1]],
                    dtype=np.float32)
