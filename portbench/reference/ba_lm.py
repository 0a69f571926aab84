"""Plain Levenberg-Marquardt bundle adjustment: the reference that
``ba1k.solve`` holds ``run_large_ba`` to.

The same problem and the same method as the solver under test, written
from the textbook in plain torch operations and nothing of the port: a
pinhole reprojection residual per observation, left-multiplicative pose
updates (R <- exp(dw) R, t <- t + dt), the normal equations reduced to the
cameras by the Schur complement, solved by a fixed number of block-Jacobi
preconditioned CG iterations (the damped camera blocks as the
preconditioner, x0 = 0), and the LM damping schedule (diagonal times
1 + lam plus 1e-6; a step is taken when the cost falls, then lam / down,
else lam * up).  The coupling is applied as sums over the observation list
(``index_add_``), never as a table: nothing the program derived from the
problem is read.

A Huber loss (``huber_delta`` > 0) weights each residual by
min(1, delta / |r|) in the normal equations and costs it as Huber's rho.

It runs in any floating dtype: float64 for the reference, bfloat16 for
the control that must fail the comparison (the 3x3 and 6x6 inversions,
which have no bfloat16 kernel, run in float32 and round back)."""

from __future__ import annotations

import torch


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_so3(w):
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-10
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(safe)) / safe ** 2)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def log_so3(R):
    """For rotations short of pi (the problem's are a few mrad)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.linalg.norm(v, dim=-1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    th = torch.atan2(s, c)
    scale = torch.where(s > 1e-12, th / torch.clamp(s, min=1e-30),
                        torch.ones_like(s))
    return v * scale[..., None]


def inv(M):
    """Batched inverse; a singular block (bfloat16 loses the 1e-6 floor)
    gives non-finite entries, whose step the cost test then rejects."""
    return torch.linalg.inv_ex(M.float())[0].to(M.dtype)


class Problem:
    """The COO problem in one dtype: K [3, 3], cam / lm [O] indices, uv
    [O, 2], w [O], and the free masks as 0 / 1 factors."""

    def __init__(self, pr: dict, dtype, huber_delta: float = 0.0):
        self.dtype, self.delta = dtype, float(huber_delta)
        self.K = pr["K"].to(dtype)
        self.cam, self.lm = pr["cam_idx"].long(), pr["lm_idx"].long()
        self.uv, self.w = pr["uv"].to(dtype), pr["w"].to(dtype)
        self.cam_free = pr["cam_free"].to(dtype)
        self.lm_free = pr["lm_free"].to(dtype)
        self.C, self.L = len(pr["cam_free"]), len(pr["lm_free"])

    def residuals(self, rv, tv, X, jacobians=True):
        R = exp_so3(rv)[self.cam]
        RX = (R @ X[self.lm][..., None])[..., 0]
        p = RX + tv[self.cam]
        fx, fy, cx, cy = (self.K[0, 0], self.K[1, 1], self.K[0, 2],
                          self.K[1, 2])
        iz = 1.0 / p[:, 2]
        r = torch.stack([fx * p[:, 0] * iz + cx, fy * p[:, 1] * iz + cy],
                        -1) - self.uv
        if not jacobians:
            return r
        z = torch.zeros_like(iz)
        duv = torch.stack([
            torch.stack([fx * iz, z, -fx * p[:, 0] * iz * iz], -1),
            torch.stack([z, fy * iz, -fy * p[:, 1] * iz * iz], -1)], 1)
        A = torch.cat([duv @ -hat(RX), duv], -1)
        A = A * self.cam_free[self.cam][:, None, None]
        B = (duv @ R) * self.lm_free[self.lm][:, None, None]
        return r, A, B

    def rho(self, r):
        """Each residual's cost: |r|^2, or Huber's rho."""
        sq = (r * r).sum(-1)
        if self.delta <= 0:
            return sq
        n = torch.sqrt(sq)
        return torch.where(n <= self.delta, sq,
                           2 * self.delta * n - self.delta ** 2)

    def irls(self, r):
        if self.delta <= 0:
            return self.w
        n = torch.linalg.norm(r, dim=-1)
        return self.w * torch.clamp(self.delta / torch.clamp(n, min=1e-12),
                                    max=1.0)

    def cost(self, rv, tv, X):
        r = self.residuals(rv, tv, X, jacobians=False)
        return (self.w * self.rho(r)).sum()

    def linearize(self, rv, tv, X):
        """(U [C, 6, 6], V [L, 3, 3], W [O, 6, 3], g_cam, g_lm, cost) with
        g = -J^T r."""
        r, A, B = self.residuals(rv, tv, X)
        w = self.irls(r)
        At, Bt = (A * w[:, None, None]).transpose(1, 2), \
            (B * w[:, None, None]).transpose(1, 2)
        dt = self.dtype
        U = torch.zeros((self.C, 6, 6), dtype=dt, device=r.device
                        ).index_add_(0, self.cam, At @ A)
        V = torch.zeros((self.L, 3, 3), dtype=dt, device=r.device
                        ).index_add_(0, self.lm, Bt @ B)
        W = At @ B
        g_cam = torch.zeros((self.C, 6), dtype=dt, device=r.device
                            ).index_add_(0, self.cam, -(At @ r[..., None])[..., 0])
        g_lm = torch.zeros((self.L, 3), dtype=dt, device=r.device
                           ).index_add_(0, self.lm, -(Bt @ r[..., None])[..., 0])
        cost = (self.w * self.rho(r)).sum()
        return U, V, W, g_cam, g_lm, cost


def damp(M, lam):
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + lam * (M * eye) + 1e-6 * eye


def solve(pr: dict, *, iterations: int, cg_iterations: int,
          lam0: float = 1e-3, lam_up: float = 4.0, lam_down: float = 2.0,
          huber_delta: float = 0.0, dtype=torch.float64):
    """LM from the problem's start.  Returns (rv, tv, X, initial cost,
    final cost, accepted steps)."""
    P = Problem(pr, dtype, huber_delta)
    rv, tv, X = (pr["rv"].to(dtype), pr["tv"].to(dtype),
                 pr["X"].to(dtype))
    U, V, W, g_cam, g_lm, cost = P.linearize(rv, tv, X)
    cost0, lam, accepted = cost, lam0, 0
    eye6 = torch.eye(6, dtype=dtype, device=X.device)
    for _ in range(iterations):
        Ud = damp(U, lam)
        Vinv = inv(damp(V, lam))
        Minv = inv(Ud + 1e-6 * eye6)

        def couple(z_lm):
            """sum over camera c's observations of W Vinv z_lm."""
            z = (Vinv @ z_lm[..., None])[..., 0]
            return torch.zeros((P.C, 6), dtype=dtype, device=X.device
                               ).index_add_(0, P.cam,
                                            (W @ z[P.lm][..., None])[..., 0])

        def wt(x):
            """W^T x summed per landmark."""
            return torch.zeros((P.L, 3), dtype=dtype, device=X.device
                               ).index_add_(0, P.lm, (W.transpose(1, 2)
                                            @ x[P.cam][..., None])[..., 0])

        def matvec(x):
            return (Ud @ x[..., None])[..., 0] - couple(wt(x))

        rhs = g_cam - couple(g_lm)
        x = torch.zeros_like(rhs)
        r = rhs
        z = (Minv @ r[..., None])[..., 0]
        p = z
        for _ in range(cg_iterations):
            Ap = matvec(p)
            rz = (r * z).sum()
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-12)
            x = x + alpha * p
            r = r - alpha * Ap
            z_new = (Minv @ r[..., None])[..., 0]
            beta = (r * z_new).sum() / torch.clamp(rz, min=1e-12)
            p = z_new + beta * p
            z = z_new
        d_cam = x * P.cam_free[:, None]
        d_lm = (Vinv @ (g_lm - wt(d_cam))[..., None])[..., 0] \
            * P.lm_free[:, None]
        rv_new = log_so3(exp_so3(d_cam[:, :3]) @ exp_so3(rv))
        tv_new, X_new = tv + d_cam[:, 3:], X + d_lm
        blocks = P.linearize(rv_new, tv_new, X_new)
        new_cost = blocks[-1]
        if bool((new_cost < cost) & torch.isfinite(new_cost)):
            rv, tv, X, cost = rv_new, tv_new, X_new, new_cost
            U, V, W, g_cam, g_lm, _ = blocks
            lam = max(lam / lam_down, 1e-9)
            accepted += 1
        else:
            lam = min(lam * lam_up, 1e6)
    return rv, tv, X, float(cost0), float(cost), accepted
