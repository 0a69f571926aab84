"""Perspective-n-Point: DLT pose from 2D-3D correspondences, the Grunert
P3P minimal solver, and Gauss-Newton pose refinement."""

from __future__ import annotations

import math

import torch

from .camera import project
from .poly import quartic_roots
from .rotations import exp_so3, hat, log_so3, nearest_rotation


def pnp_dlt(K, xyz, uv, w):
    """Weighted DLT pose.  xyz [N, 3] world, uv [N, 2] pixels, w [..., N]
    weights (a leading batch of weight masks gives a batch of poses).
    Returns (rvec [..., 3], tvec [..., 3]).  Needs >= 6 effective,
    non-coplanar points."""
    w = w.to(xyz.dtype)
    Kinv = torch.linalg.inv(K)
    xn = (torch.cat([uv, torch.ones_like(uv[:, :1])], 1) @ Kinv.T)[:, :2]
    wsum = torch.clamp(torch.sum(w, -1), min=1e-6)
    mean3 = torch.sum(xyz * w[..., None], -2) / wsum[..., None]
    Xc = xyz - mean3[..., None, :]
    scale3 = torch.sum(torch.linalg.norm(Xc, dim=-1) * w, -1) / wsum
    s3 = math.sqrt(3.0) / torch.clamp(scale3, min=1e-9)
    Xn = Xc * s3[..., None, None]

    x, y = xn[:, 0], xn[:, 1]
    X0, X1, X2 = Xn.unbind(-1)
    zero, one = torch.zeros_like(X0), torch.ones_like(X0)
    r1 = torch.stack([X0, X1, X2, one, zero, zero, zero, zero,
                      -x * X0, -x * X1, -x * X2, -x + zero], -1)
    r2 = torch.stack([zero, zero, zero, zero, X0, X1, X2, one,
                      -y * X0, -y * X1, -y * X2, -y + zero], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = V[..., :, 0].reshape(*V.shape[:-2], 3, 4)
    M = P[..., :3]
    # global sign: most weighted points in front of the camera
    z = (Xn @ M[..., 2, :, None])[..., 0] + P[..., 2, 3:4]
    z_sign = torch.sum(torch.sign(z) * w, -1)
    P = P * torch.where(z_sign < 0, -1.0, 1.0).to(P.dtype)[..., None, None]
    M = P[..., :3]
    R = nearest_rotation(M)
    scale = torch.sum(R * M, dim=(-2, -1)) / 3.0
    t_n = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    t = t_n / s3[..., None] - (R @ mean3[..., None])[..., 0]
    return log_so3(R), t


def p3p(K, xyz3, uv3):
    """Grunert P3P: up to 4 camera poses from exactly 3 correspondences,
    batched over leading dimensions.  xyz3 [..., 3, 3] world points, uv3
    [..., 3, 2] pixels.  Returns (rvecs [..., 4, 3], tvecs [..., 4, 3],
    valid [..., 4]); invalid candidates are zeros.

    A quartic in the distance ratio v = s3/s1 (Haralick et al.'s review of
    the three-point problem), Newton-polished together with u = s2/s1, then
    the rigid transform of the three camera-frame points by Kabsch."""
    Kinv = torch.linalg.inv(K)
    f = torch.cat([uv3, torch.ones_like(uv3[..., :1])], -1) @ Kinv.T
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)   # bearing vectors
    P1, P2, P3 = xyz3.unbind(-2)
    f1, f2, f3 = f.unbind(-2)
    ca = torch.sum(f2 * f3, -1)    # angle opposite side a = |P2 - P3|
    cb = torch.sum(f1 * f3, -1)    # angle opposite side b = |P1 - P3|
    cg = torch.sum(f1 * f2, -1)    # angle opposite side c = |P1 - P2|
    a2 = torch.sum((P2 - P3) ** 2, -1)
    b2 = torch.clamp(torch.sum((P1 - P3) ** 2, -1), min=1e-12)
    c2 = torch.sum((P1 - P2) ** 2, -1)
    A = a2 / b2
    C = c2 / b2
    qr = (a2 - c2) / b2
    A4 = (qr - 1.0) ** 2 - 4.0 * C * ca * ca
    A3 = 4.0 * (qr * (1.0 - qr) * cb - (1.0 - (A + C)) * ca * cg
                + 2.0 * C * ca * ca * cb)
    A2_ = 2.0 * (qr * qr - 1.0 + 2.0 * qr * qr * cb * cb
                 + 2.0 * (1.0 - C) * ca * ca
                 - 4.0 * (A + C) * ca * cb * cg + 2.0 * (1.0 - A) * cg * cg)
    A1 = 4.0 * (-qr * (1.0 + qr) * cb + 2.0 * A * cg * cg * cb
                - (1.0 - (A + C)) * ca * cg)
    A0 = (1.0 + qr) ** 2 - 4.0 * A * cg * cg
    v, v_ok = quartic_roots(A4, A3, A2_, A1, A0)         # [..., 4]

    A, C, qr, ca, cb, cg, b2 = (x[..., None] for x in (A, C, qr, ca, cb, cg,
                                                       b2))
    den = 2.0 * (cg - v * ca)
    den = torch.where(torch.abs(den) < 1e-9, torch.sign(den) * 1e-9 + 1e-12,
                      den)
    u = ((qr - 1.0) * v * v - 2.0 * qr * cb * v + 1.0 + qr) / den
    # Newton-polish (u, v) on the two distance-ratio equations
    for _ in range(3):
        g1 = u * u + v * v - 2 * u * v * ca - A * (1 + v * v - 2 * v * cb)
        g2 = 1 + u * u - 2 * u * cg - C * (1 + v * v - 2 * v * cb)
        J11 = 2 * u - 2 * v * ca
        J12 = 2 * v - 2 * u * ca - A * (2 * v - 2 * cb)
        J21 = 2 * u - 2 * cg
        J22 = -C * (2 * v - 2 * cb)
        det = J11 * J22 - J12 * J21
        det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
        u = u - (J22 * g1 - J12 * g2) / det
        v = v - (-J21 * g1 + J11 * g2) / det

    s1 = torch.sqrt(b2 / torch.clamp(1 + v * v - 2 * v * cb, min=1e-12))
    s = torch.stack([s1, u * s1, v * s1], -1)            # [..., 4, 3]
    ok = v_ok & (s > 0).all(-1)

    # Kabsch for each candidate: camera-frame points s_i f_i against xyz3
    C_pts = s[..., :, :, None] * f[..., None, :, :]     # [..., 4, 3, 3]
    Pm = xyz3.mean(-2)
    Cm = C_pts.mean(-2)
    M = (C_pts - Cm[..., None, :]).transpose(-1, -2) @ (
        xyz3 - Pm[..., None, :])[..., None, :, :]
    finite = torch.isfinite(M).all(-1).all(-1)
    R = nearest_rotation(torch.where(finite[..., None, None], M, 0.0))
    t = Cm - (R @ Pm[..., None, :, None])[..., 0]
    rvs = log_so3(R)
    ok = ok & finite & torch.isfinite(rvs).all(-1) & torch.isfinite(t).all(-1)
    rvs = torch.where(ok[..., None], torch.nan_to_num(rvs), 0.0)
    tvs = torch.where(ok[..., None], torch.nan_to_num(t), 0.0)
    return rvs, tvs, ok


def _pose_residual_jac(K, rvec, tvec, xyz, uv, w):
    """Masked residuals [N, 2] and pose-Jacobian blocks [N, 2, 6] under the
    left-multiplicative parameterisation (R <- exp(dw) R, t <- t + dt)."""
    R = exp_so3(rvec)
    RX = xyz @ R.T
    p = RX + tvec
    z = p[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6,
                         torch.where(z < 0, -1e-6, 1e-6).to(z.dtype), z)
    inv_z = 1.0 / z_safe
    fx, fy, skew, cx, cy = K[0, 0], K[1, 1], K[0, 1], K[0, 2], K[1, 2]
    u = fx * p[:, 0] * inv_z + skew * p[:, 1] * inv_z + cx
    v = fy * p[:, 1] * inv_z + cy
    r = (torch.stack([u, v], -1) - uv) * w[:, None]
    zero = torch.zeros_like(inv_z)
    duv_dp = torch.stack([
        torch.stack([fx * inv_z, skew * inv_z,
                     -(fx * p[:, 0] + skew * p[:, 1]) * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], -1),
    ], dim=1)
    A = torch.cat([duv_dp @ -hat(RX), duv_dp], -1) * w[:, None, None]
    return r, A


def refine_pose(K, rvec, tvec, xyz, uv, w, iters: int = 10,
                damping: float = 1e-4):
    """Pose-only damped Gauss-Newton on the masked reprojection residual;
    a step is kept only when it lowers the cost.  Fixed trip count, no
    host synchronisation.  Returns (rvec, tvec)."""
    def cost_of(rv, tv):
        return torch.sum(((project(K, rv, tv, xyz) - uv) * w[:, None]) ** 2)

    eye = torch.eye(6, dtype=xyz.dtype, device=xyz.device)
    rv, tv, cost = rvec, tvec, cost_of(rvec, tvec)
    for _ in range(iters):
        r, A = _pose_residual_jac(K, rv, tv, xyz, uv, w)
        H = torch.einsum("oia,oib->ab", A, A)
        g = torch.einsum("oia,oi->a", A, r)
        H = H + damping * torch.diag(torch.diag(H)) + 1e-9 * eye
        step = torch.linalg.solve_ex(H, g, check_errors=False)[0]
        rv_new = log_so3(exp_so3(-step[:3]) @ exp_so3(rv))
        tv_new = tv - step[3:]
        new_cost = cost_of(rv_new, tv_new)
        ok = new_cost < cost
        rv = torch.where(ok, rv_new, rv)
        tv = torch.where(ok, tv_new, tv)
        cost = torch.where(ok, new_cost, cost)
    return rv, tv


def reprojection_errors(K, rvec, tvec, xyz, uv):
    """Per-point reprojection error in pixels [..., N]."""
    return torch.linalg.norm(project(K, rvec, tvec, xyz) - uv, dim=-1)
