"""Epipolar geometry: F from poses, epipolar distances, match filtering,
and the ORB-SLAM-style H/F model-selection scores.  Functions broadcast
over leading dimensions (a batch of models against one match set)."""

from __future__ import annotations

import torch

from .camera import depths
from .rotations import exp_so3, hat


def essential_from_poses(rvec0, tvec0, rvec1, tvec1):
    """E of the relative pose cam0 -> cam1: x1^T E x0 = 0."""
    R0, R1 = exp_so3(rvec0), exp_so3(rvec1)
    R = R1 @ R0.transpose(-1, -2)
    t = tvec1 - (R @ tvec0[..., None])[..., 0]
    return hat(t) @ R


def fundamental_from_poses(K0, rvec0, tvec0, K1, rvec1, tvec1):
    """F = K1^-T E K0^-1."""
    E = essential_from_poses(rvec0, tvec0, rvec1, tvec1)
    return torch.linalg.inv(K1).T @ E @ torch.linalg.inv(K0)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def epiline_distance_sq(F, uv0, uv1):
    """Squared point-to-epipolar-line distances (d1: x1 to F x0, d0: x0 to
    F^T x1).  F [..., 3, 3], uv [..., N, 2] -> [..., N] each."""
    x0, x1 = _homog(uv0), _homog(uv1)
    l1 = x0 @ F.transpose(-1, -2)
    l0 = x1 @ F
    num = torch.sum(x1 * l1, dim=-1)
    d1 = num * num / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    d0 = num * num / (l0[..., 0] ** 2 + l0[..., 1] ** 2 + 1e-12)
    return d1, d0


def filter_matches_epipolar(F, uv0, uv1, xyz, rvec0, tvec0, rvec1, tvec1,
                            max_err: float, valid=None):
    """Keep matches with symmetric epipolar distance below max_err px and a
    triangulated point in front of both cameras."""
    d1, d0 = epiline_distance_sq(F, uv0, uv1)
    max2 = max_err * max_err
    ok = (d1 < max2) & (d0 < max2)
    ok = ok & (depths(rvec0, tvec0, xyz) > 0) & (depths(rvec1, tvec1, xyz) > 0)
    if valid is not None:
        ok = ok & valid
    return ok


def homography_transfer_error_sq(H, uv0, uv1):
    """(|x1 - H x0|^2, |x0 - H^-1 x1|^2) per match."""
    Hinv = torch.linalg.inv(H)
    p1 = _homog(uv0) @ H.transpose(-1, -2)
    p0 = _homog(uv1) @ Hinv.transpose(-1, -2)

    def dehom(p):
        w = p[..., 2:3]
        return p[..., :2] / (w + torch.where(torch.abs(w) < 1e-12, 1e-12, 0.0))

    e_fwd = torch.sum((uv1 - dehom(p1)) ** 2, dim=-1)
    e_bwd = torch.sum((uv0 - dehom(p0)) ** 2, dim=-1)
    return e_fwd, e_bwd


def homography_score(H, uv0, uv1, valid, th: float = 5.99):
    """ORB-SLAM S_H: sum of (th - e) over directions with e < th; inliers
    pass both directions."""
    e_fwd, e_bwd = homography_transfer_error_sq(H, uv0, uv1)
    zero = torch.zeros_like(e_fwd)
    s = torch.sum(torch.where((e_fwd < th) & valid, th - e_fwd, zero), -1)
    s = s + torch.sum(torch.where((e_bwd < th) & valid, th - e_bwd, zero), -1)
    return s, (e_fwd < th) & (e_bwd < th) & valid


def fundamental_score(F, uv0, uv1, valid, th: float = 3.84,
                      th_score: float = 5.99):
    """ORB-SLAM S_F: epipolar distances, inlier threshold th, score term
    (th_score - d)."""
    d1, d0 = epiline_distance_sq(F, uv0, uv1)
    zero = torch.zeros_like(d1)
    s = torch.sum(torch.where((d1 < th) & valid, th_score - d1, zero), -1)
    s = s + torch.sum(torch.where((d0 < th) & valid, th_score - d0, zero), -1)
    return s, (d1 < th) & (d0 < th) & valid


def _masked_mean(e, valid):
    n = torch.clamp(valid.sum(-1), min=1)
    return torch.sum(torch.where(valid, e, torch.zeros_like(e)), -1) / n


def mean_transfer_error(H, uv0, uv1, valid):
    e_fwd, e_bwd = homography_transfer_error_sq(H, uv0, uv1)
    return _masked_mean(0.5 * (torch.sqrt(e_fwd) + torch.sqrt(e_bwd)), valid)


def mean_epipolar_error(F, uv0, uv1, valid):
    d1, d0 = epiline_distance_sq(F, uv0, uv1)
    return _masked_mean(0.5 * (torch.sqrt(d1) + torch.sqrt(d0)), valid)
