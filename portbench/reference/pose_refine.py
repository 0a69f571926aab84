"""Plain pose-only Gauss-Newton: the reference of the tracker's last step,
the refinement of a frame's pose over its tracked 2D-3D matches.

The textbook method on the pinhole reprojection residual, in plain torch
operations and nothing of the port: left-multiplicative updates
(R <- exp(-dw) R, t <- t - dt) from the normal equations damped by 1e-4
of their diagonal plus 1e-9, solved by Gaussian elimination written out
(there is no bfloat16 solver), and a step kept only where the weighted
cost falls.  It runs in any floating dtype: float32 to agree with the
program, bfloat16 for the scan cells' control."""

from __future__ import annotations

import torch

from .ba_lm import exp_so3, hat, log_so3


def _solve(H, g):
    """x with H x = g for SPD H [..., n, n] by elimination without pivots
    (the damped normal equations need none), in H's dtype."""
    n = H.shape[-1]
    A = torch.cat([H, g[..., None]], -1).clone()
    for k in range(n):
        A[..., k, :] = A[..., k, :] / A[..., k, k:k + 1]
        for i in range(n):
            if i != k:
                A[..., i, :] = A[..., i, :] - A[..., i, k:k + 1] * A[..., k, :]
    return A[..., -1]


def _residuals(K, rv, tv, xyz, uv, w, jacobians=True):
    """Weighted residuals [..., N, 2] and, with ``jacobians``, their
    derivatives [..., N, 2, 6] for the update (dw, dt) added."""
    RX = xyz @ exp_so3(rv).transpose(-1, -2)
    p = RX + tv[..., None, :]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    iz = 1.0 / p[..., 2]
    r = (torch.stack([fx * p[..., 0] * iz + cx, fy * p[..., 1] * iz + cy],
                     -1) - uv) * w[..., None]
    if not jacobians:
        return r
    z = torch.zeros_like(iz)
    duv = torch.stack([
        torch.stack([fx * iz, z, -fx * p[..., 0] * iz * iz], -1),
        torch.stack([z, fy * iz, -fy * p[..., 1] * iz * iz], -1)], -2)
    A = torch.cat([duv @ -hat(RX), duv], -1) * w[..., None, None]
    return r, A


def refine(K, rvec, tvec, xyz, uv, w, iters: int, dtype=torch.float32,
           damping: float = 1e-4):
    """(rvec, tvec) after ``iters`` Gauss-Newton steps, computed in
    ``dtype`` and returned in the inputs' dtype."""
    out = rvec.dtype
    K, xyz, uv, w = (K.to(dtype), xyz.to(dtype), uv.to(dtype), w.to(dtype))
    rv, tv = rvec.to(dtype), tvec.to(dtype)
    eye = torch.eye(6, dtype=dtype, device=xyz.device)

    def cost(rv, tv):
        r = _residuals(K, rv, tv, xyz, uv, w, jacobians=False)
        return (r * r).sum((-2, -1))

    c = cost(rv, tv)
    for _ in range(iters):
        r, A = _residuals(K, rv, tv, xyz, uv, w)
        H = torch.einsum("...nia,...nib->...ab", A, A)
        g = torch.einsum("...nia,...ni->...a", A, r)
        H = H + damping * torch.diag_embed(torch.diagonal(H, 0, -2, -1)) \
            + 1e-9 * eye
        step = _solve(H, g)
        rv_new = log_so3(exp_so3(-step[..., :3]) @ exp_so3(rv))
        tv_new = tv - step[..., 3:]
        c_new = cost(rv_new, tv_new)
        ok = (c_new < c) & torch.isfinite(c_new)
        rv = torch.where(ok[..., None], rv_new, rv)
        tv = torch.where(ok[..., None], tv_new, tv)
        c = torch.where(ok, c_new, c)
    return rv.to(out), tv.to(out)
