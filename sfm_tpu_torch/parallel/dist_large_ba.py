"""Distributed implicit-Schur bundle adjustment: the large solver
(``ba.large``) with the landmarks sharded over a mesh axis, for problems
of thousands of cameras and millions of landmarks.

Each shard owns a contiguous block of landmarks and the landmark-major
table of their observations; camera poses are replicated.  A rank
linearises its shard with K2 (``ba_linearize``): W, V and g_lm stay
local, and U, g_cam and the cost are the shard's partial sums, made
whole by one all-reduce of the three packed into one buffer.  Every CG
matvec applies the coupling of the shard with K3 (``SchurOperator``) and
all-reduces the [C, 6] result, as does the rhs; back-substitution is K3's
gather mode on the shard.  Every rank solves the camera system itself.
The loop is ``ba.large``'s own (``_large_lm``) with an all-reduce as its
``reduce`` hook."""

from __future__ import annotations

import torch

from ..ba.large import (ObsTables, _large_lm, build_tables,
                        build_tables_device)
from ..ba.residuals import Observations
from .dist_ba import _np, _shard_rows
from .hosts import all_sum, axis_shard

__all__ = ["build_dist_large_ba", "partition_tables"]


def partition_tables(obs: Observations, n_cams: int, n_lms: int,
                     n_shards: int, nmax: int, kmax: int, *, device=None):
    """Split the landmarks into ``n_shards`` contiguous shards and build
    each shard's dual tables (shard-local landmark indices, ``nmax`` the
    per-shard camera-major row capacity).  Returns (ObsTables with a
    leading [n_shards] axis, shard_size).

    Without ``device`` the tables come from the host ``build_tables``,
    equal to the JAX package's, overflow included.  With ``device`` each
    shard is built there by ``build_tables_device``, which equals
    ``build_tables`` when nothing overflows; an observation either table
    drops raises ``ValueError``, because the two builds part there."""
    shard_size = n_lms // n_shards
    parts = []
    if device is None:
        cam_idx, lm_idx, uv, w = map(_np, obs)
        for s in range(n_shards):
            sel = (w > 0) & (lm_idx // shard_size == s)
            sub = Observations(
                torch.from_numpy(cam_idx[sel]),
                torch.from_numpy(lm_idx[sel] - s * shard_size),
                torch.from_numpy(uv[sel]), torch.from_numpy(w[sel]))
            parts.append(build_tables(sub, n_cams, shard_size, nmax, kmax))
    else:
        cam_idx, lm_idx, uv, w = (torch.as_tensor(t, device=device)
                                  for t in obs)
        cam_idx, lm_idx = cam_idx.to(torch.int64), lm_idx.to(torch.int64)
        for s in range(n_shards):
            sel = (w > 0) & (torch.div(lm_idx, shard_size,
                                       rounding_mode="floor") == s)
            sub = Observations(cam_idx[sel], lm_idx[sel] - s * shard_size,
                               uv[sel], w[sel])
            tables, dropped = build_tables_device(sub, n_cams, shard_size,
                                                  nmax, kmax)
            dropped = int(dropped)
            if dropped:
                raise ValueError(
                    f"partition_tables: shard {s} drops {dropped} "
                    f"observations at nmax={nmax}, kmax={kmax}; the device "
                    f"build equals the host build only without overflow")
            parts.append(tables)
    return ObsTables(*(torch.stack(x) for x in zip(*parts))), shard_size


def build_dist_large_ba(mesh, axis: str, n_cams: int, shard_size: int, *,
                        iterations: int = 10, cg_iterations: int = 25,
                        lam0: float = 1e-3, lam_up: float = 4.0,
                        lam_down: float = 2.0, huber_delta: float = 0.0,
                        tol: float = 0.0):
    """The landmark-sharded implicit-Schur LM solve over ``axis`` of
    ``mesh``.

    ``fn(K, rvec, tvec, xyz, tables, cam_free, lm_free) -> (rvec, tvec,
    xyz_l, stats)``, called by every rank of the axis: K, rvec / tvec
    [C, 3] and cam_free [C] bool are replicated; xyz [L, 3] and lm_free
    [L] bool are global (L = n_shards * shard_size) and ``tables`` has a
    leading [n_shards] axis (``partition_tables``; only its landmark-major
    half is read); xyz_l [shard, 3] is this rank's shard.  Fixed trip
    counts: ``tol`` is accepted and ignored, as in the JAX package."""
    del tol

    def fn(K, rvec, tvec, xyz, tables: ObsTables, cam_free, lm_free):
        group, s, n = axis_shard(mesh, axis)
        if tables.lm_cam.shape[0] != n:
            raise ValueError(f"tables have {tables.lm_cam.shape[0]} shards "
                             f"for {n} ranks on axis {axis!r}")
        return _large_lm(
            K, rvec, tvec, _shard_rows(xyz, s, shard_size, n, "xyz"),
            tables.lm_cam[s], tables.lm_uv[s], tables.lm_w[s],
            cam_free.to(torch.float32),
            _shard_rows(lm_free, s, shard_size, n, "lm_free").to(torch.float32),
            iterations=iterations, cg_iterations=cg_iterations, lam0=lam0,
            lam_up=lam_up, lam_down=lam_down, huber_delta=huber_delta,
            tol=0.0, reduce=lambda *ts: all_sum(group, *ts))

    return fn
