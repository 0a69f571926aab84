"""Levenberg-Marquardt bundle adjustment with Schur-complement
elimination of the landmarks: the dense solver (``run_ba``,
``ba_solver="dense"``) and the per-observation PCG solver (``run_ba_cg``,
``ba_solver="cg"``).

``run_ba`` assembles the normal-equation blocks U [C, 6, 6], V [L, 3, 3],
W [C, L, 6, 3], g_cam [C, 6] and g_lm [L, 3] by summing over the COO
observation list; the landmark blocks are eliminated, the reduced
[6C, 6C] camera system is solved densely, and the landmarks are
back-substituted; ``mode`` (``BAMode``) optimises the poses alone or the
landmarks alone instead.  ``run_ba_cg`` keeps the coupling per observation,
W_o [O, 6, 3], and solves the reduced system by block-Jacobi PCG (the
large solver's ``_pcg``) through gathers and the same sums.  In both, a
trial step is assembled at the proposed point, which yields its cost
(accept / reject) and, when accepted, the next linearisation.  Every sum
over observations runs in a fixed order (``utils.rowsum.RowSum``: the
target rows sorted once per problem, no atomics), so a rerun on the card
gives the same iterates bit for bit; on the CPU the sums equal
``index_add_``'s."""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import torch

from ..geometry.rotations import exp_so3
from ..utils.profiling import count, to_host
from ..utils.rowsum import RowSum
from .residuals import (Observations, apply_pose_update, huber_weights,
                        residuals_and_jacobians, robust_cost)


class BAMode(enum.IntEnum):
    """What ``run_ba`` optimises (the reference's CTracker::BA_TYPE)."""
    STRUCT_AND_POSE = 0
    POSE_ONLY = 1      # the landmarks frozen
    STRUCT_ONLY = 2    # the cameras frozen


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor
    # observations that table capacities dropped from this solve (set by
    # callers that build tables)
    dropped_obs: int = 0


class _Sums(NamedTuple):
    """The fixed-order sums of one BA problem's observations into cameras
    and landmarks (built once, used in every LM iteration)."""
    cam: RowSum
    lm: RowSum

    @classmethod
    def of(cls, obs: Observations, n_cams: int, n_lms: int) -> "_Sums":
        return cls(RowSum(obs.cam_idx, n_cams), RowSum(obs.lm_idx, n_lms))


def _linearized(K, rvec, tvec, xyz, obs: Observations, cam_free, lm_free,
                huber_delta: float, sums: _Sums):
    """The normal-equation blocks without the [C, L] coupling: U, V, the
    per-observation coupling W_o [O, 6, 3], g_cam, g_lm; with the
    residuals r [O, 2] and the IRLS weights w [O] (obs.w times the Huber
    weights) they were formed with."""
    r, A, B = residuals_and_jacobians(K, exp_so3(rvec), tvec, xyz, obs)
    w = obs.w * huber_weights(r, huber_delta)
    A = A * (w * cam_free[obs.cam_idx])[:, None, None]
    B = B * (w * lm_free[obs.lm_idx])[:, None, None]
    rw = r * w[:, None]
    At, Bt = A.transpose(1, 2), B.transpose(1, 2)
    U = sums.cam(At @ A)
    V = sums.lm(Bt @ B)
    g_cam = sums.cam(-(At @ rw[:, :, None])[..., 0])
    g_lm = sums.lm(-(Bt @ rw[:, :, None])[..., 0])
    return (U, V, At @ B, g_cam, g_lm), r, w


def _couple(blocks, pair_sum: RowSum, C: int, L: int):
    """The blocks with the coupling W_o summed into W [C, L, 6, 3]
    (``pair_sum`` over the rows cam * L + lm)."""
    U, V, W_o, g_cam, g_lm = blocks
    return U, V, pair_sum(W_o).reshape(C, L, 6, 3), g_cam, g_lm


def _assemble_cg(K, rvec, tvec, xyz, obs: Observations, cam_free, lm_free,
                 huber_delta: float, sums: _Sums):
    """``_linearized``'s blocks and the robust cost."""
    blocks, r, _ = _linearized(K, rvec, tvec, xyz, obs, cam_free, lm_free,
                               huber_delta, sums)
    return blocks, robust_cost(r, obs.w, huber_delta)


def _assemble(K, rvec, tvec, xyz, obs: Observations, cam_free, lm_free,
              huber_delta: float, sums: _Sums, pair_sum: RowSum):
    """``_assemble_cg``'s blocks with the coupling summed into
    W [C, L, 6, 3] (``_couple``), and the robust cost."""
    blocks, cost = _assemble_cg(K, rvec, tvec, xyz, obs, cam_free, lm_free,
                                huber_delta, sums)
    return _couple(blocks, pair_sum, rvec.shape[0], xyz.shape[0]), cost


def _damp(M, lam):
    """Levenberg damping: block diagonals times (1 + lam), plus an absolute
    floor so empty blocks stay invertible."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + lam * (M * eye) + 1e-6 * eye


def _inv(M):
    return torch.linalg.inv_ex(M, check_errors=False)[0]


def _solve_step(U, V, W, g_cam, g_lm, lam):
    """One damped Gauss-Newton step by Schur elimination of the
    landmarks.  Returns (d_cam [C, 6], d_lm [L, 3])."""
    C = U.shape[0]
    Vinv = _inv(_damp(V, lam))
    Y = torch.einsum("clab,lbd->clad", W, Vinv)
    S_blocks = torch.einsum("clad,mled->cmae", Y, W)
    S = (torch.block_diag(*_damp(U, lam).unbind(0))
         - S_blocks.permute(0, 2, 1, 3).reshape(6 * C, 6 * C))
    rhs = g_cam - torch.einsum("clad,ld->ca", Y, g_lm)
    d_cam = torch.linalg.solve_ex(S, rhs.reshape(-1),
                                  check_errors=False)[0].reshape(C, 6)
    Wt_dc = torch.einsum("clad,ca->ld", W, d_cam)
    d_lm = (Vinv @ (g_lm - Wt_dc)[:, :, None])[..., 0]
    return d_cam, d_lm


def _pose_step(U, V, W_o, g_cam, g_lm, lam):
    """``BAMode.POSE_ONLY``: the damped camera blocks solved alone (the
    landmarks frozen)."""
    d_cam = torch.linalg.solve_ex(_damp(U, lam), g_cam[:, :, None],
                                  check_errors=False)[0][..., 0]
    return d_cam, None


def _struct_step(U, V, W_o, g_cam, g_lm, lam):
    """``BAMode.STRUCT_ONLY``: the damped landmark blocks solved alone
    (the cameras frozen)."""
    return None, (_inv(_damp(V, lam)) @ g_lm[:, :, None])[..., 0]


def _lm_loop(assemble, step, rvec, tvec, xyz, cam_free_f, lm_free_f, *,
             iterations: int, lam0: float, lam_up: float, lam_down: float,
             tol: float):
    """The LM damping loop shared by ``run_ba`` and ``run_ba_cg``:
    ``assemble(rvec, tvec, xyz)`` -> (blocks, cost), ``step(blocks, lam)``
    -> (d_cam, d_lm), where None freezes that block bit for bit.  Stops
    early once an accepted step lowers the cost by less than ``tol``
    relative (one host read per iteration)."""
    blocks, cost = assemble(rvec, tvec, xyz)
    cost0 = cost
    count("implicit_sync")  # lam's blocking copy to the card
    lam = torch.tensor(lam0, dtype=torch.float32, device=xyz.device)
    accepted = torch.zeros((), dtype=torch.int32, device=xyz.device)
    for _ in range(iterations):
        d_cam, d_lm = step(blocks, lam)
        rv_new, tv_new, xyz_new = rvec, tvec, xyz
        if d_cam is not None:
            d_cam = d_cam * cam_free_f[:, None]
            rv_new, tv_new = apply_pose_update(rvec, tvec, d_cam[:, :3],
                                               d_cam[:, 3:])
        if d_lm is not None:
            xyz_new = xyz + d_lm * lm_free_f[:, None]
        blocks_new, new_cost = assemble(rv_new, tv_new, xyz_new)
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        done = ok & (cost - new_cost < tol * torch.clamp(cost, min=1.0))
        rvec = torch.where(ok, rv_new, rvec)
        tvec = torch.where(ok, tv_new, tvec)
        xyz = torch.where(ok, xyz_new, xyz)
        blocks = tuple(torch.where(ok, n, o)
                       for n, o in zip(blocks_new, blocks))
        lam = torch.where(ok, torch.clamp(lam / lam_down, min=1e-9),
                          torch.clamp(lam * lam_up, max=1e6))
        cost = torch.where(ok, new_cost, cost)
        accepted = accepted + ok.to(torch.int32)
        if to_host(bool, done):
            break
    return rvec, tvec, xyz, BAStats(cost0, cost, lam, accepted)


def run_ba(K, rvec, tvec, xyz, obs: Observations, *, cam_free, lm_free,
           mode: BAMode = BAMode.STRUCT_AND_POSE, iterations: int = 20,
           lam0: float = 1e-3, lam_up: float = 4.0, lam_down: float = 2.0,
           huber_delta: float = 0.0, tol: float = 1e-4
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, BAStats]:
    """Dense-Schur LM over structure and poses, or over the poses alone
    (``BAMode.POSE_ONLY``) or the landmarks alone (``STRUCT_ONLY``), whose
    frozen block is returned unchanged bit for bit.  cam_free [C] /
    lm_free [L] bool masks freeze parameters (gauge, padding).  Stops
    early once an accepted step lowers the cost by less than ``tol``
    relative (one host read per iteration)."""
    cam_free_f = cam_free.to(torch.float32)
    lm_free_f = lm_free.to(torch.float32)
    C, L = rvec.shape[0], xyz.shape[0]
    sums = _Sums.of(obs, C, L)
    if mode == BAMode.STRUCT_AND_POSE:
        pair_sum = RowSum(obs.cam_idx * L + obs.lm_idx, C * L)

        def assemble(rv, tv, X):
            return _assemble(K, rv, tv, X, obs, cam_free_f, lm_free_f,
                             huber_delta, sums, pair_sum)
        solve = _solve_step
    else:
        # one pose or one landmark at a time: no [C, L] coupling
        def assemble(rv, tv, X):
            return _assemble_cg(K, rv, tv, X, obs, cam_free_f, lm_free_f,
                                huber_delta, sums)
        solve = _pose_step if mode == BAMode.POSE_ONLY else _struct_step
    return _lm_loop(
        assemble, lambda blocks, lam: solve(*blocks, lam),
        rvec, tvec, xyz, cam_free_f, lm_free_f, iterations=iterations,
        lam0=lam0, lam_up=lam_up, lam_down=lam_down, tol=tol)


def run_ba_cg(K, rvec, tvec, xyz, obs: Observations, *, cam_free, lm_free,
              iterations: int = 20, cg_iterations: int = 15,
              lam0: float = 1e-3, lam_up: float = 4.0, lam_down: float = 2.0,
              huber_delta: float = 0.0, tol: float = 1e-4
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, BAStats]:
    """Structure-and-pose LM with the reduced camera system solved by
    block-Jacobi PCG (``cg_iterations``, the large solver's ``_pcg``)
    through the per-observation coupling W_o: no [C, L] tensor.  The same
    contract as ``run_ba``."""
    from .large import _pcg
    C, L = rvec.shape[0], xyz.shape[0]
    cam_idx, lm_idx = obs.cam_idx, obs.lm_idx
    cam_free_f = cam_free.to(torch.float32)
    lm_free_f = lm_free.to(torch.float32)
    eye6 = torch.eye(6, dtype=xyz.dtype, device=xyz.device)
    sums = _Sums.of(obs, C, L)

    def step(blocks, lam):
        U, V, W_o, g_cam, g_lm = blocks
        Ud = _damp(U, lam)
        Vinv = _inv(_damp(V, lam))

        def wt_x(x):
            # t[l] = sum over the observations of l of W_o^T x[cam_o]
            return sums.lm((x[cam_idx][:, None, :] @ W_o)[:, 0])

        def w_z(z):
            # y[c] = sum over the observations of c of W_o z[lm_o]
            return sums.cam((W_o @ z[lm_idx][:, :, None])[..., 0])

        def vinv(v):
            return (Vinv @ v[:, :, None])[..., 0]

        def matvec(x):
            return (Ud @ x[:, :, None])[..., 0] - w_z(vinv(wt_x(x)))

        rhs = g_cam - w_z(vinv(g_lm))
        d_cam = _pcg(matvec, _inv(Ud + 1e-6 * eye6), rhs, cg_iterations)
        d_cam = d_cam * cam_free_f[:, None]
        return d_cam, vinv(g_lm - wt_x(d_cam))

    return _lm_loop(
        lambda rv, tv, X: _assemble_cg(K, rv, tv, X, obs, cam_free_f,
                                       lm_free_f, huber_delta, sums),
        step, rvec, tvec, xyz, cam_free_f, lm_free_f, iterations=iterations,
        lam0=lam0, lam_up=lam_up, lam_down=lam_down, tol=tol)


def observations_from_keyframes(kfs, lm_valid) -> Observations:
    """Flatten the keyframe link matrix into the COO observation list."""
    Kn, N = kfs.frames.landmark.shape
    dev = lm_valid.device
    cam_idx = torch.arange(Kn, device=dev).repeat_interleave(N)
    lm_idx = kfs.frames.landmark.reshape(-1).to(torch.int64)
    linked = (lm_idx >= 0) & kfs.frames.kp_valid.reshape(-1)
    linked = linked & kfs.valid.repeat_interleave(N)
    linked = linked & lm_valid[torch.clamp(lm_idx, min=0)]
    return Observations(cam_idx=cam_idx,
                        lm_idx=torch.where(linked, lm_idx, 0),
                        uv=kfs.frames.xy.reshape(-1, 2),
                        w=linked.to(torch.float32))


def observations_from_keyframe_window(kfs, lm_valid, slots, slot_ok
                                      ) -> Observations:
    """The COO list of a keyframe-slot window [Wn] only.  Camera indices
    stay slot ids; rows of unusable slots (slot_ok False or an invalid
    keyframe) get zero weight."""
    fr = kfs.frames
    N = fr.landmark.shape[1]
    slots = slots.to(torch.int64)
    lm_idx = fr.landmark[slots].reshape(-1).to(torch.int64)
    ok_row = kfs.valid[slots] & slot_ok
    linked = (lm_idx >= 0) & fr.kp_valid[slots].reshape(-1)
    linked = linked & ok_row.repeat_interleave(N)
    linked = linked & lm_valid[torch.clamp(lm_idx, min=0)]
    return Observations(cam_idx=slots.repeat_interleave(N),
                        lm_idx=torch.where(linked, lm_idx, 0),
                        uv=fr.xy[slots].reshape(-1, 2),
                        w=linked.to(torch.float32))


def compact_landmarks(lm_valid, capacity: int):
    """Rank live landmark slots into a dense [capacity] range.  Returns
    ``rank`` [L] (slot -> compact id, == capacity for dead or overflow
    slots) and ``inv`` [capacity] (compact id -> slot, -1 unused).  A
    fleet's masks [B, L] give [B, L] and [B, capacity], scan by scan."""
    L = lm_valid.shape[-1]
    lead = lm_valid.shape[:-1]
    rank = torch.cumsum(lm_valid.to(torch.int64), -1) - 1
    ok = lm_valid & (rank < capacity)
    rank = torch.where(ok, rank, capacity)
    inv = torch.full((*lead, capacity + 1), -1, dtype=torch.int32,
                     device=lm_valid.device)
    slots = torch.arange(L, dtype=torch.int32, device=lm_valid.device)
    inv.scatter_(-1, rank, slots.expand(rank.shape))
    return rank, inv[..., :capacity]


def compact_ba_problem(xyz, lm_valid, obs: Observations, capacity: int):
    """Remap (xyz, lm_free, obs) onto the compacted landmark axis.
    Returns (xyz_c [capacity, 3], lm_free_c [capacity], obs_c, inv)."""
    rank, inv = compact_landmarks(lm_valid, capacity)
    lm_free_c = inv >= 0
    xyz_c = xyz[torch.clamp(inv, min=0).to(torch.int64)]
    lm_c = rank[obs.lm_idx]
    keep = lm_c < capacity
    obs_c = obs._replace(lm_idx=torch.where(keep, lm_c, 0),
                         w=obs.w * keep.to(torch.float32))
    return xyz_c, lm_free_c, obs_c, inv


def scatter_back_landmarks(xyz, xyz_c, inv):
    """Write optimised compact positions back into the full store."""
    from ..mapstore import _set_drop
    return _set_drop(xyz, torch.where(inv >= 0, inv, xyz.shape[0]), xyz_c)
