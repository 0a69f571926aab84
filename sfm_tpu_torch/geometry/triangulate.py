"""DLT triangulation: two-view (inhomogeneous and homogeneous) and
N-view, batched over points and leading dims."""

from __future__ import annotations

import torch

from .rotations import exp_so3


def projection_matrix(rvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """[R|t] [..., 3, 4] (no intrinsics)."""
    return torch.cat([exp_so3(rvec), tvec[..., :, None]], dim=-1)


def _dlt_rows(P, uv):
    """Rows u*P3 - P1 and v*P3 - P2 for P [..., 3, 4], uv [..., N, 2]
    -> two [..., N, 4] tensors."""
    P = P[..., None, :, :]
    return (uv[..., 0:1] * P[..., 2, :] - P[..., 0, :],
            uv[..., 1:2] * P[..., 2, :] - P[..., 1, :])


def solve3_sym(M, rhs):
    """Closed-form solve of symmetric 3x3 systems (adjugate)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f, i = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    A_ = e * i - f * f
    B_ = c * f - b * i
    C_ = b * f - c * e
    E_ = a * i - c * c
    F_ = b * c - a * f
    I_ = a * e - b * b
    det = a * A_ + b * B_ + c * C_
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18),
                      det)
    x, y, z = rhs.unbind(-1)
    return torch.stack([A_ * x + B_ * y + C_ * z,
                        B_ * x + E_ * y + F_ * z,
                        C_ * x + F_ * y + I_ * z], dim=-1) / det[..., None]


def _unit_rows(A):
    return A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)


def triangulate_pair(P0, P1, uv0, uv1) -> torch.Tensor:
    """Inhomogeneous two-view DLT: P0, P1 [..., 3, 4] (K @ [R|t]), uv0, uv1
    [..., N, 2] pixels -> world points [..., N, 3].  Rows are normalised
    for f32 conditioning; the 4x3 system is solved through its 3x3 normal
    equations (finite points only, as in the reference)."""
    rows = torch.broadcast_tensors(*_dlt_rows(P0, uv0), *_dlt_rows(P1, uv1))
    A = _unit_rows(torch.stack(rows, dim=-2))
    A3 = A[..., :3]
    b = -A[..., 3]
    M = A3.transpose(-1, -2) @ A3
    rhs = (A3.transpose(-1, -2) @ b[..., None])[..., 0]
    return solve3_sym(M, rhs)


def _null_point(A):
    """The point of the homogeneous DLT system A [..., R, 4]: the
    eigenvector of A^T A with the least eigenvalue, dehomogenised ->
    [..., 3]."""
    X = torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                    torch.sign(w) * 1e-12 + 1e-12, w)


def triangulate_pair_h(P0, P1, uv0, uv1) -> torch.Tensor:
    """Homogeneous two-view DLT (the least eigenvector of A^T A): P0, P1
    [..., 3, 4], uv0, uv1 [..., N, 2] -> [..., N, 3]; handles points near
    infinity, which ``triangulate_pair`` does not."""
    rows = torch.broadcast_tensors(*_dlt_rows(P0, uv0), *_dlt_rows(P1, uv1))
    return _null_point(_unit_rows(torch.stack(rows, dim=-2)))


def triangulate_nviews(Ps, uvs, mask) -> torch.Tensor:
    """N-view DLT for one point: Ps [..., V, 3, 4], uvs [..., V, 2], mask
    [..., V] bool (a masked view adds zero rows) -> [..., 3]."""
    r0, r1 = _dlt_rows(Ps, uvs[..., None, :])          # [..., V, 1, 4]
    rows = _unit_rows(torch.cat([r0, r1], dim=-2))
    rows = rows * mask[..., None, None].to(rows.dtype)
    return _null_point(rows.flatten(-3, -2))
