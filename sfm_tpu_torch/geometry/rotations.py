"""SO(3) utilities: Rodrigues exp/log maps, quaternions, point rotation
and the nearest rotation.

Every function broadcasts over leading dimensions."""

from __future__ import annotations

import torch

from ..utils.profiling import count

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
    [..., 3].  Within 0.035 rad of pi the angle comes from atan2 of the
    skew and trace parts, the axis from the symmetric part
    (R + R^T) / 2 - cos(theta) I = (1 - cos(theta)) k k^T, and its sign
    from the skew part (2 sin(theta) k).  The JAX package takes the axis
    from the diagonal of (R + I) / 2 with its largest component made
    positive, which turns a rotation by pi - e about -k into one about
    +k: an error of 2e, up to 4 degrees, on every pose an outward-looking
    orbit estimates near half a turn."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)[..., None]
    generic = w * (theta[..., None] / (2.0 * sin_t + _EPS))
    rvec = torch.where(theta[..., None] < 1e-4, w * 0.5, generic)

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    S = (R + R.transpose(-1, -2)) * 0.5 - cos_t[..., None, None] * eye
    imax = torch.argmax(torch.diagonal(S, dim1=-2, dim2=-1), dim=-1)
    col = torch.gather(S, -1, imax[..., None, None].expand(
        *S.shape[:-1], 1))[..., 0]
    axis = col / (torch.linalg.norm(col, dim=-1, keepdim=True) + _EPS)
    axis = torch.where((axis * w).sum(-1, keepdim=True) < 0, -axis, axis)
    theta_pi = torch.atan2(0.5 * torch.linalg.norm(w, dim=-1),
                           (trace - 1.0) * 0.5)
    near_pi = axis * theta_pi[..., None]
    return torch.where(theta[..., None] > 3.1066, near_pi, rvec)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation matrix
    [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rotate_points(rvec: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., N, 3] by angle-axis rvec [..., 3] (the
    reference's ceres::AngleAxisRotatePoint)."""
    return pts @ exp_so3(rvec).transpose(-1, -2)


def nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    """argmax_{R in SO(3)} tr(R^T M) for [..., 3, 3] M: U diag(1, 1,
    det(U V^T)) V^T from the SVD (the JAX package computes the same optimum
    with Horn's closed-form quaternion because batched SVD was slow on the
    TPU)."""
    count("implicit_sync", 2)  # the SVD's two checks on the card
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    d = torch.where(det < 0, -1.0, 1.0).to(M.dtype)
    ones = torch.ones_like(d)
    D = torch.stack([ones, ones, d], dim=-1)
    return U @ (D[..., :, None] * Vh)
