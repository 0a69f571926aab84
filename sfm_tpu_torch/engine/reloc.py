"""Relocalization: a global descriptor match of every landmark against the
current frame (no motion window), PnP RANSAC without a pose prior, and a
return to tracking when enough inliers support the pose.  The JAX
package's ``lax.cond`` on the PnP result is one host branch here."""

from __future__ import annotations

import torch

from ..config import SfMConfig
from ..features.match_pallas import match_features_pallas
from ..mapstore import _set_drop
from ..ransac import ransac_pnp
from ..utils.profiling import to_host
from .state import RUNNING, CameraParams, SfMState, metrics, scalar


def reloc_step(cfg: SfMConfig, cam: CameraParams, state: SfMState, frame,
               generator=None, pnp_samples=None):
    """One LOST-state step.  Returns (state, metrics).  ``pnp_samples``
    optionally injects the PnP RANSAC sample indices."""
    lms = state.lms
    L = lms.valid.shape[0]
    dev = lms.valid.device
    # every landmark slot against the frame: no window (the radius covers
    # any image), zero source centres
    res = match_features_pallas(
        state.rep_desc, torch.zeros((L, 2), device=dev), lms.valid,
        frame.desc, frame.xy, frame.kp_valid,
        min_radius=0.0, max_radius=1e9,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    uv = frame.xy[torch.where(res.mask, res.idx, 0).to(torch.int64)]
    pnp = ransac_pnp(
        generator, cam.Kopt, lms.xyz, uv, res.mask & lms.valid,
        n_hypotheses=cfg.pnp_hypotheses, sample_size=cfg.pnp_sample_size,
        threshold=cfg.max_reproj_error, refine_iters=cfg.pnp_refine_iters,
        min_inliers=max(cfg.min_features, cfg.reloc_min_inliers),
        solver=cfg.reloc_solver, samples=pnp_samples)
    common = dict(n_matches=res.mask.sum(), n_landmarks=lms.valid.sum(),
                  n_keyframes=state.kfs.valid.sum())
    if not to_host(bool, pnp.ok):
        return state, metrics(frame, status=state.status,
                              rvec=state.prev.rvec, tvec=state.prev.tvec,
                              **common)
    # link the inliers (a source row whose index is N is dropped)
    N = frame.landmark.shape[0]
    linked = frame.replace(
        rvec=pnp.rvec, tvec=pnp.tvec,
        landmark=_set_drop(frame.landmark,
                           torch.where(pnp.inliers, res.idx, N),
                           torch.arange(L, dtype=torch.int32, device=dev)))
    st = state.replace(status=scalar(RUNNING, dev), prev=linked,
                       lost_count=scalar(0, dev))
    return st, metrics(frame, status=st.status, n_inliers=pnp.n_inliers,
                       n_tracked=pnp.n_inliers, rvec=pnp.rvec, tvec=pnp.tvec,
                       **common)
