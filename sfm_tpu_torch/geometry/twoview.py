"""Two-view motion: E/H decomposition with a cheirality vote.

Every candidate motion triangulates every match in one batched pass and
votes by the count of points in front of both cameras with acceptable
reprojection error."""

from __future__ import annotations

import torch

from .camera import apply_intrinsics
from .rotations import log_so3
from .triangulate import triangulate_pair


def decompose_essential(E):
    """E -> 4 candidate (R, t) with |t| = 1: (Rs [4, 3, 3], ts [4, 3])."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H, K0, K1):
    """Faugeras SVD decomposition of a Euclidean homography into 8
    candidate (R, t) motions: (Rs [8, 3, 3], ts [8, 3])."""
    A = torch.linalg.inv(K1) @ H @ K0
    U, D, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = D[0], D[1], D[2]
    eps = 1e-9
    denom13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom13, min=0.0))
    x1s = (1.0, 1.0, -1.0, -1.0)
    x3s = (1.0, -1.0, 1.0, -1.0)
    flips = (1.0, -1.0, -1.0, 1.0)
    zero = torch.zeros_like(d1)
    Rs, ts = [], []
    for positive_d2 in (True, False):
        if positive_d2:
            denom = torch.clamp((d1 + d3) * d2, min=eps)
            c = (d2 * d2 + d1 * d3) / denom
            t_scale, t_z_sign, ryy, czz = d1 - d3, -1.0, 1.0, 1.0
        else:
            denom = torch.clamp((d1 - d3) * d2, min=eps)
            c = (d1 * d3 - d2 * d2) / denom
            t_scale, t_z_sign, ryy, czz = d1 + d3, 1.0, -1.0, -1.0
        aux_s = torch.sqrt(torch.clamp(
            (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) / denom
        for i in range(4):
            st = flips[i] * aux_s
            Rp = torch.stack([
                torch.stack([c, zero, -st * czz]),
                torch.stack([zero, zero + ryy, zero]),
                torch.stack([st, zero, c * czz]),
            ])
            R = s * (U @ Rp @ Vh)
            tp = t_scale * torch.stack([x1s[i] * aux1, zero,
                                        t_z_sign * x3s[i] * aux3])
            tp = tp / (torch.linalg.norm(tp) + eps)
            Rs.append(R)
            ts.append(U @ tp)
    return torch.stack(Rs), torch.stack(ts)


def cheirality_vote(Rs, ts, K0, K1, uv0, uv1, valid,
                    max_reproj_err: float = 7.0):
    """Pick the candidate (camera 0 at the origin, camera 1 at (R, t))
    with the most matches in front of both cameras and within
    max_reproj_err px in both views.  Returns (R, t, X [N, 3], good [N],
    n_good); ties go to the first candidate."""
    eye34 = torch.eye(3, 4, dtype=K0.dtype, device=K0.device)
    P0 = K0 @ eye34
    P1 = K1 @ torch.cat([Rs, ts[:, :, None]], dim=-1)          # [C, 3, 4]
    X = triangulate_pair(P0, P1, uv0, uv1)                     # [C, N, 3]
    z0 = X[..., 2]
    cam1 = X @ Rs.transpose(-1, -2) + ts[:, None, :]
    z1 = cam1[..., 2]
    e0 = torch.sum((apply_intrinsics(K0, X) - uv0) ** 2, -1)
    e1 = torch.sum((apply_intrinsics(K1, cam1) - uv1) ** 2, -1)
    m2 = max_reproj_err * max_reproj_err
    good = (z0 > 1e-6) & (z1 > 1e-6) & (e0 < m2) & (e1 < m2) & valid
    ns = good.sum(-1)
    best = torch.argmax(ns)
    return Rs[best], ts[best], X[best], good[best], ns[best]


def recover_pose_from_essential(E, K0, K1, uv0, uv1, valid,
                                max_reproj_err: float = 7.0):
    """Returns (rvec, tvec, X, good, n_good)."""
    Rs, ts = decompose_essential(E)
    R, t, X, good, n = cheirality_vote(Rs, ts, K0, K1, uv0, uv1, valid,
                                       max_reproj_err)
    return log_so3(R), t, X, good, n


def recover_pose_from_homography(H, K0, K1, uv0, uv1, valid,
                                 max_reproj_err: float = 7.0):
    """Returns (rvec, tvec, X, good, n_good)."""
    Rs, ts = decompose_homography(H, K0, K1)
    R, t, X, good, n = cheirality_vote(Rs, ts, K0, K1, uv0, uv1, valid,
                                       max_reproj_err)
    return log_so3(R), t, X, good, n
