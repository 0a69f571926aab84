"""Distributed bundle adjustment, dense Schur: landmarks sharded over a
mesh axis, camera poses replicated.

Every rank of the mesh calls the solver on the same global arguments and
works on its own shard, picked by its position on the axis: it assembles
its local normal-equation blocks (``ba.core._linearized``, W [C, shard,
6, 3]), and per LM iteration one all-reduce over the axis sums its camera
terms U, g_cam, S = W V^-1 W^T and W V^-1 g_lm, packed into one flat
buffer.  Every rank then solves the small dense camera system itself and
back-substitutes its own landmarks; a second all-reduce sums the trial
cost.  ``all_reduce`` gives every rank the same sums, so the ranks' poses
stay equal bit for bit.

The observation list is split by owning shard with shard-local landmark
indices by ``partition_observations``."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ba.core import _Sums, _couple, _damp, _inv, _linearized, _lm_loop
from ..ba.residuals import Observations
from ..utils.rowsum import RowSum
from .hosts import all_sum, axis_shard

__all__ = ["build_dist_ba", "partition_observations"]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def partition_observations(obs: Observations, n_landmarks: int,
                           n_shards: int, cap_per_shard: int):
    """Host-side: bucket the live observations by owning landmark shard
    (lm_idx // shard_size), make their landmark indices shard-local, and
    pad each bucket to ``cap_per_shard`` (a bucket over its cap keeps its
    first ``cap_per_shard`` observations).  Returns (Observations with a
    leading [n_shards] axis, shard_size).  As in the JAX package, the
    observations of the last ``n_landmarks % n_shards`` landmarks fall in
    no shard, and the overflow is counted but not returned."""
    shard_size = n_landmarks // n_shards
    cam_idx, lm_idx, uv, w = map(_np, obs)
    out_cam = np.zeros((n_shards, cap_per_shard), np.int64)
    out_lm = np.zeros((n_shards, cap_per_shard), np.int64)
    out_uv = np.zeros((n_shards, cap_per_shard, 2), np.float32)
    out_w = np.zeros((n_shards, cap_per_shard), np.float32)
    dropped = 0
    for s in range(n_shards):
        mask = (w > 0) & (lm_idx // shard_size == s)
        n = int(mask.sum())
        if n > cap_per_shard:
            dropped += n - cap_per_shard
            idx = np.nonzero(mask)[0][:cap_per_shard]
            n = cap_per_shard
        else:
            idx = np.nonzero(mask)[0]
        out_cam[s, :n] = cam_idx[idx]
        out_lm[s, :n] = lm_idx[idx] - s * shard_size
        out_uv[s, :n] = uv[idx]
        out_w[s, :n] = w[idx]
    return Observations(*map(torch.from_numpy,
                             (out_cam, out_lm, out_uv, out_w))), shard_size


def _shard_rows(tensor, s: int, shard_size: int, n: int, what: str):
    """Shard ``s`` of ``n``: the rows of a global [n * shard_size, ...]
    tensor that it owns."""
    if tensor.shape[0] != n * shard_size:
        raise ValueError(f"{what} has {tensor.shape[0]} rows; {n} shards of "
                         f"{shard_size} need {n * shard_size}")
    return tensor[s * shard_size:(s + 1) * shard_size]


def build_dist_ba(mesh, axis: str, n_cams: int, shard_size: int, *,
                  iterations: int = 20, lam0: float = 1e-3,
                  lam_up: float = 4.0, lam_down: float = 2.0,
                  huber_delta: float = 0.0):
    """The landmark-sharded dense LM solve over ``axis`` of ``mesh``.

    ``fn(K, rvec, tvec, xyz, obs_sh, cam_free, lm_free) -> (rvec, tvec,
    xyz_l, stats)``, called by every rank of the axis: K [3, 3], rvec /
    tvec [C, 3] and cam_free [C] bool are replicated; xyz [L, 3] and
    lm_free [L] bool are global (L = n_shards * shard_size) and obs_sh has
    a leading [n_shards] axis (``partition_observations``); xyz_l [shard,
    3] is this rank's shard.  A fixed ``iterations`` with no early exit.
    The cost is sum w |r|^2 under the Huber IRLS weights w, as in the JAX
    package (not ``robust_cost``; the two agree at huber_delta 0)."""

    def fn(K, rvec, tvec, xyz, obs_sh, cam_free, lm_free):
        group, s, n = axis_shard(mesh, axis)
        if obs_sh.w.shape[0] != n:
            raise ValueError(f"obs_sh has {obs_sh.w.shape[0]} buckets for "
                             f"{n} shards on axis {axis!r}")
        obs_l = Observations(*(t[s] for t in obs_sh))
        xyz_l = _shard_rows(xyz, s, shard_size, n, "xyz")
        lm_free_f = _shard_rows(lm_free, s, shard_size, n, "lm_free").to(
            torch.float32)
        cam_free_f = cam_free.to(torch.float32)
        sums = _Sums.of(obs_l, n_cams, shard_size)
        pair_sum = RowSum(obs_l.cam_idx * shard_size + obs_l.lm_idx,
                          n_cams * shard_size)

        def assemble(rv, tv, X):
            blocks, r, w = _linearized(K, rv, tv, X, obs_l, cam_free_f,
                                       lm_free_f, huber_delta, sums)
            # the JAX package's cost: sum w |r|^2 under the IRLS weights
            cost = torch.sum(torch.sum(r * r, -1) * w)
            return (_couple(blocks, pair_sum, n_cams, shard_size),
                    all_sum(group, cost)[0])

        def step(blocks, lam):
            U_l, V_l, W_l, gc_l, gl_l = blocks
            Vinv = _inv(_damp(V_l, lam))
            Y = torch.einsum("clab,lbd->clad", W_l, Vinv)
            S_l = torch.einsum("clad,mled->cmae", Y, W_l)
            rhs_l = torch.einsum("clad,ld->ca", Y, gl_l)
            # the camera terms of every shard: one all-reduce
            U, g_cam, S_red, rhs_red = all_sum(group, U_l, gc_l, S_l, rhs_l)
            S = (torch.block_diag(*_damp(U, lam).unbind(0))
                 - S_red.permute(0, 2, 1, 3).reshape(6 * n_cams, 6 * n_cams))
            d_cam = torch.linalg.solve_ex(
                S, (g_cam - rhs_red).reshape(-1),
                check_errors=False)[0].reshape(n_cams, 6)
            d_cam = d_cam * cam_free_f[:, None]
            # shard-local landmark back-substitution
            Wt_dc = torch.einsum("clad,ca->ld", W_l, d_cam)
            return d_cam, (Vinv @ (gl_l - Wt_dc)[:, :, None])[..., 0]

        return _lm_loop(assemble, step, rvec, tvec, xyz_l, cam_free_f,
                        lm_free_f, iterations=iterations, lam0=lam0,
                        lam_up=lam_up, lam_down=lam_down, tol=0.0)

    return fn
