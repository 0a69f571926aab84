"""Reprojection residuals and analytic Jacobian blocks for bundle
adjustment: 2 residuals per observation, intrinsics with the skew term, no
distortion (points are pre-undistorted).

Pose increments use the left-multiplicative parameterisation
(R <- exp(dw) R, t <- t + dt):
    d(p_cam)/d(dw) = -hat(R X),  d(p_cam)/d(dt) = I,  d(p_cam)/dX = R,
chained with the pinhole 2x3 d(uv)/d(p_cam)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.rotations import exp_so3, hat, log_so3


class Observations(NamedTuple):
    """COO observation list."""
    cam_idx: torch.Tensor   # [O] int64
    lm_idx: torch.Tensor    # [O] int64
    uv: torch.Tensor        # [O, 2] f32 measured (undistorted) pixels
    w: torch.Tensor         # [O] f32 weights (0 = padding / invalid)


def residuals_and_jacobians(K, R, tvec, xyz, obs: Observations):
    """Per-observation residual r [O, 2] and blocks A = dr/d(dw, dt)
    [O, 2, 6], B = dr/dX [O, 2, 3].  R [C, 3, 3], tvec [C, 3], xyz [L, 3]."""
    Rc = R[obs.cam_idx]
    RX = (Rc @ xyz[obs.lm_idx][:, :, None])[..., 0]
    p = RX + tvec[obs.cam_idx]
    z = p[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6,
                         torch.where(z < 0, -1e-6, 1e-6).to(z.dtype), z)
    inv_z = 1.0 / z_safe
    fx, fy, skew, cx, cy = K[0, 0], K[1, 1], K[0, 1], K[0, 2], K[1, 2]
    u = fx * p[:, 0] * inv_z + skew * p[:, 1] * inv_z + cx
    v = fy * p[:, 1] * inv_z + cy
    r = torch.stack([u, v], -1) - obs.uv
    zero = torch.zeros_like(inv_z)
    duv_dp = torch.stack([
        torch.stack([fx * inv_z, skew * inv_z,
                     -(fx * p[:, 0] + skew * p[:, 1]) * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], -1),
    ], dim=1)
    A = torch.cat([duv_dp @ -hat(RX), duv_dp], -1)
    B = duv_dp @ Rc
    return r, A, B


def huber_weights(r, delta: float):
    """Per-observation IRLS weight of the Huber loss (delta <= 0: ones)."""
    if delta <= 0:
        return torch.ones(r.shape[0], dtype=r.dtype, device=r.device)
    nrm = torch.linalg.norm(r, dim=-1)
    return torch.where(nrm <= delta, torch.ones_like(nrm),
                       delta / torch.clamp(nrm, min=1e-12))


def robust_cost(r, w, huber_delta: float):
    """Sum of (Huber-)robustified squared residuals, weighted by w."""
    sq = torch.sum(r * r, -1)
    if huber_delta > 0:
        d = huber_delta
        nrm = torch.sqrt(sq + 1e-12)
        sq = torch.where(nrm <= d, sq, 2 * d * nrm - d * d)
    return torch.sum(sq * w)


def apply_pose_update(rvec, tvec, dw, dt):
    """R <- exp(dw) R, t <- t + dt (batched over leading dims)."""
    return log_so3(exp_so3(dw) @ exp_so3(rvec)), tvec + dt
