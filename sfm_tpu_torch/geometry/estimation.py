"""Masked, Hartley-normalised DLT estimators for H and F.

Each takes a weight mask, so one call serves a full match set and a batch
of minimal RANSAC samples alike: weights [..., N] broadcast against the
points [N, 2]."""

from __future__ import annotations

import math

import torch


def _normalize_points(uv, w):
    """Weighted Hartley normalisation: centroid to the origin, mean distance
    sqrt(2).  Returns (uv_n [..., N, 2], T [..., 3, 3])."""
    wsum = torch.clamp(torch.sum(w, -1), min=1e-6)
    mean = torch.sum(uv * w[..., None], -2) / wsum[..., None]
    centered = uv - mean[..., None, :]
    dist = torch.sqrt(torch.sum(centered ** 2, -1) + 1e-12)
    mean_dist = torch.sum(dist * w, -1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-6)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], -1),
        torch.stack([zero, s, -s * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return centered * s[..., None, None], T


def smallest_eigvec(AtA):
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, 0]


def estimate_homography(uv0, uv1, w):
    """Weighted DLT homography x1 ~ H x0, H[2, 2] scaled to 1 where
    possible."""
    w = w.to(uv0.dtype)
    p0, T0 = _normalize_points(uv0, w)
    p1, T1 = _normalize_points(uv1, w)
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    h = smallest_eigvec(A.transpose(-1, -2) @ A)
    H = torch.linalg.inv(T1) @ h.reshape(*h.shape[:-1], 3, 3) @ T0
    scale = H[..., 2, 2]
    scale = torch.where(torch.abs(scale) > 1e-8, scale, torch.ones_like(scale))
    return H / scale[..., None, None]


def estimate_fundamental(uv0, uv1, w):
    """Weighted normalised 8-point F (x1^T F x0 = 0), rank 2 enforced,
    unit Frobenius norm."""
    w = w.to(uv0.dtype)
    p0, T0 = _normalize_points(uv0, w)
    p1, T1 = _normalize_points(uv1, w)
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                     torch.ones_like(x)], -1) * w[..., None]
    f = smallest_eigvec(A.transpose(-1, -2) @ A)
    U, S, Vh = torch.linalg.svd(f.reshape(*f.shape[:-1], 3, 3))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    Fn = (U * S[..., None, :]) @ Vh
    F = T1.transpose(-1, -2) @ Fn @ T0
    nrm = torch.linalg.norm(F, dim=(-2, -1)) + 1e-12
    return F / nrm[..., None, None]
