"""Periodic global bundle adjustment over every keyframe and landmark.

The mapping pass runs a windowed local BA; this pass frees every pose but
the oldest keyframe's and every live landmark, and runs every
``global_ba_every`` keyframe insertions, driven by the host
(``SfMEngine``).  It builds the observations of all keyframes, buckets
them into landmark-major tables at ``global_ba_kmax`` (or ``ba_kmax``)
slots per landmark, and runs the large implicit-Schur solver on them: on a
CUDA device through K2, K3 and K3-gather, over as many camera slots as the
keyframe store holds (``camera_slots`` indexes any count)."""

from __future__ import annotations

import torch

from ..ba.core import observations_from_keyframes
from ..ba.large import ObsTables, build_lm_tables_device, run_large_ba
from ..config import SfMConfig
from .state import CameraParams, SfMState


def run_global_ba(cfg: SfMConfig, cam: CameraParams, state: SfMState):
    """(state, stats): global BA on the engine state.  Only the keyframe
    poses and the landmark positions change; ``stats.dropped_obs`` counts
    the observations past the table's slots."""
    kfs, lms = state.kfs, state.lms
    obs = observations_from_keyframes(kfs, lms.valid)
    lm_cam, lm_uv, lm_w, n_dropped = build_lm_tables_device(
        obs, cfg.max_landmarks, kmax=cfg.global_ba_kmax or cfg.ba_kmax)
    oldest = torch.argmin(torch.where(kfs.valid, kfs.frames.frame_no,
                                      2 ** 30))
    cam_free = kfs.valid.clone()
    cam_free[oldest] = False
    rv, tv, xyz, stats = run_large_ba(
        cam.Kopt, kfs.frames.rvec, kfs.frames.tvec, lms.xyz,
        ObsTables(lm_cam, lm_uv, lm_w), cam_free=cam_free,
        lm_free=lms.valid, iterations=cfg.global_ba_iterations,
        cg_iterations=cfg.global_ba_cg_iterations,
        lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
        lam_down=cfg.ba_lambda_down,
        huber_delta=cfg.global_ba_huber_delta or cfg.ba_huber_delta,
        tol=cfg.ba_tol)
    kfs = kfs.replace(frames=kfs.frames.replace(rvec=rv, tvec=tv))
    state = state.replace(kfs=kfs, lms=lms.replace(xyz=xyz))
    return state, stats._replace(dropped_obs=n_dropped)
