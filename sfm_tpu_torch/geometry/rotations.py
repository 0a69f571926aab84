"""SO(3) utilities: Rodrigues exp/log maps and the nearest rotation.

Every function broadcasts over leading dimensions."""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of 3-vectors [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def exp_so3(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: angle-axis [..., 3] -> rotation matrix [..., 3, 3], with
    series coefficients near zero."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a * K + b * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: rotation matrix [..., 3, 3] -> angle-axis
    [..., 3].  Near pi the axis comes from the diagonal of (R + I) / 2."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)[..., None]
    generic = w * (theta[..., None] / (2.0 * sin_t + _EPS))
    rvec = torch.where(theta[..., None] < 1e-4, w * 0.5, generic)

    d = torch.clamp(torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]],
                                dim=-1) * 0.5 + 0.5, 0.0, 1.0)
    axis = torch.sqrt(d)
    imax = torch.argmax(axis, dim=-1)
    off = torch.stack([R[..., 1, 0] + R[..., 0, 1],
                       R[..., 2, 0] + R[..., 0, 2],
                       R[..., 2, 1] + R[..., 1, 2]], dim=-1)
    sgn = torch.sign(off + _EPS)
    one = torch.ones_like(theta)
    sx = torch.where(imax == 0, one,
                     torch.where(imax == 1, sgn[..., 0], sgn[..., 1]))
    sy = torch.where(imax == 1, one,
                     torch.where(imax == 0, sgn[..., 0], sgn[..., 2]))
    sz = torch.where(imax == 2, one,
                     torch.where(imax == 0, sgn[..., 1], sgn[..., 2]))
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    near_pi = axis * theta[..., None]
    return torch.where(theta[..., None] > 3.1066, near_pi, rvec)


def nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    """argmax_{R in SO(3)} tr(R^T M) for [..., 3, 3] M: U diag(1, 1,
    det(U V^T)) V^T from the SVD (the JAX package computes the same optimum
    with Horn's closed-form quaternion because batched SVD was slow on the
    TPU)."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    d = torch.where(det < 0, -1.0, 1.0).to(M.dtype)
    ones = torch.ones_like(d)
    D = torch.stack([ones, ones, d], dim=-1)
    return U @ (D[..., :, None] * Vh)
