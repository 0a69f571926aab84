"""The plain reference of a global BA call: the problem rebuilt from the
keyframe store and the landmarks it started from, and the float64 LM of
``ba_lm.py`` run on it with the program's settings.  Plain torch; nothing
of the port.

The problem is global BA's as the engine states it: every observation of
a live landmark by a live keyframe (a keypoint linked to it), at most
``kmax`` per landmark (the first in keyframe-slot order, then keypoint
order: the rest are dropped), every live landmark free, every live
keyframe free but the oldest (the gauge).  ``solve`` is ``ba_lm.solve``'s
LM with two departures, both the large solver's: the weight and the cost
of a residual past the Huber threshold (``Problem``), and the early stop:
the LM ends after the first step that is taken and lowers the cost by
less than ``tol`` times max(cost, 1)."""

from __future__ import annotations

import torch

from . import ba_lm


def problem(K, kf_valid, kf_frame_no, kf_rvec, kf_tvec, kf_landmark,
            kf_kp_valid, kf_xy, lm_xyz, lm_valid, kmax: int) -> dict:
    """The COO problem of ``ba_lm`` (with ``dropped``, the observations past
    ``kmax``) from the keyframe store [Kn, ...] and the landmarks [L, ...]
    a call started from."""
    Kn, N = kf_landmark.shape
    dev = lm_xyz.device
    lm = kf_landmark.reshape(-1).long()
    cam = torch.arange(Kn, device=dev).repeat_interleave(N)
    live = (lm >= 0) & kf_kp_valid.reshape(-1) & kf_valid[cam] \
        & lm_valid[lm.clamp(min=0)]
    rows = torch.nonzero(live)[:, 0]            # ascending: slot-major
    order = torch.argsort(lm[rows], stable=True)
    rows, by_lm = rows[order], lm[rows][order]
    rank = torch.arange(len(rows), device=dev) \
        - torch.searchsorted(by_lm, by_lm)
    keep = rows[rank < kmax]
    oldest = torch.argmin(torch.where(kf_valid, kf_frame_no.long(), 2 ** 40))
    cam_free = kf_valid.clone()
    cam_free[oldest] = False
    return dict(K=K, rv=kf_rvec, tv=kf_tvec, X=lm_xyz, cam_free=cam_free,
                lm_free=lm_valid, cam_idx=cam[keep], lm_idx=lm[keep],
                uv=kf_xy.reshape(-1, 2)[keep],
                w=torch.ones(len(keep), dtype=lm_xyz.dtype, device=dev),
                dropped=int(len(rows) - len(keep)))


class Problem(ba_lm.Problem):
    """``ba_lm.Problem`` weighted and costed as the large solver does it
    (``csrc/linearize.cu``): with h = min(1, delta / |r|), the Jacobians
    and the residual are scaled by h, so the normal equations carry h^2,
    and a residual costs h |r|^2, which is not Huber's rho past delta."""

    def _h(self, r):
        n = torch.linalg.norm(r, dim=-1)
        return torch.clamp(self.delta / torch.clamp(n, min=1e-12), max=1.0)

    def irls(self, r):
        return self.w if self.delta <= 0 else self.w * self._h(r) ** 2

    def rho(self, r):
        sq = (r * r).sum(-1)
        return sq if self.delta <= 0 else sq * self._h(r)


def solve(pr: dict, *, iterations: int, cg_iterations: int, lam0: float,
          lam_up: float, lam_down: float, huber_delta: float, tol: float,
          dtype=torch.float64):
    """``ba_lm.solve``'s LM on ``Problem``, stopped as the program stops:
    after the first step taken that lowers the cost by less than ``tol``
    times max(cost, 1).  Returns (rv, tv, X, initial cost, final cost,
    steps taken, iterations run)."""
    P = Problem(pr, dtype, huber_delta)
    rv, tv, X = (pr["rv"].to(dtype), pr["tv"].to(dtype), pr["X"].to(dtype))
    U, V, W, g_cam, g_lm, cost = P.linearize(rv, tv, X)
    cost0, lam, accepted, n = cost, lam0, 0, 0
    eye6 = torch.eye(6, dtype=dtype, device=X.device)

    def couple(Vinv, z_lm):
        z = (Vinv @ z_lm[..., None])[..., 0]
        return torch.zeros((P.C, 6), dtype=dtype, device=X.device
                           ).index_add_(0, P.cam,
                                        (W @ z[P.lm][..., None])[..., 0])

    def wt(x):
        return torch.zeros((P.L, 3), dtype=dtype, device=X.device
                           ).index_add_(0, P.lm, (W.transpose(1, 2)
                                        @ x[P.cam][..., None])[..., 0])

    for n in range(1, iterations + 1):
        Ud = ba_lm.damp(U, lam)
        Vinv = ba_lm.inv(ba_lm.damp(V, lam))
        Minv = ba_lm.inv(Ud + 1e-6 * eye6)
        rhs = g_cam - couple(Vinv, g_lm)
        x = torch.zeros_like(rhs)
        r = rhs
        z = (Minv @ r[..., None])[..., 0]
        p = z
        for _ in range(cg_iterations):
            Ap = (Ud @ p[..., None])[..., 0] - couple(Vinv, wt(p))
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
        rv_new = ba_lm.log_so3(ba_lm.exp_so3(d_cam[:, :3])
                               @ ba_lm.exp_so3(rv))
        tv_new, X_new = tv + d_cam[:, 3:], X + d_lm
        blocks = P.linearize(rv_new, tv_new, X_new)
        new_cost = blocks[-1]
        if bool((new_cost < cost) & torch.isfinite(new_cost)):
            done = bool(cost - new_cost < tol * torch.clamp(cost, min=1.0))
            rv, tv, X, cost = rv_new, tv_new, X_new, new_cost
            U, V, W, g_cam, g_lm, _ = blocks
            lam = max(lam / lam_down, 1e-9)
            accepted += 1
            if done:
                break
        else:
            lam = min(lam * lam_up, 1e6)
    return rv, tv, X, float(cost0), float(cost), accepted, n
