"""Two-view bootstrap.

The first frame becomes keyframe 0 at the origin; later frames are matched
against it, H (least squares over all matches) and F (RANSAC) are fit and
scored with the ORB-SLAM symmetric-transfer scores, the winning model is
decomposed (cheirality vote), matches are triangulated and
epipolar-filtered, the map is seeded with two keyframes, and a pair BA
refines it.  After ``keyframe_time_lag`` consecutive failures the reference
frame advances."""

from __future__ import annotations

import torch

from ..ba import observations_from_keyframes, run_ba
from ..ba.core import compact_ba_problem, scatter_back_landmarks
from ..config import SfMConfig
from ..features.match_pallas import match_features_pallas
from ..geometry.epipolar import (filter_matches_epipolar,
                                 fundamental_from_poses, fundamental_score,
                                 homography_score, mean_epipolar_error,
                                 mean_transfer_error)
from ..geometry.estimation import estimate_homography
from ..geometry.twoview import (recover_pose_from_essential,
                                recover_pose_from_homography)
from ..mapstore import (_set_drop, add_descriptors, add_landmarks,
                        empty_keyframes, insert_keyframe,
                        representative_descriptors)
from ..ransac import ransac_fundamental
from ..utils.profiling import count, to_host
from .state import RUNNING, CameraParams, SfMState, metrics, scalar


def bootstrap_step(cfg: SfMConfig, cam: CameraParams, state: SfMState,
                   frame, generator=None, f_samples=None):
    """One NOT_INITIALIZED-state step.  Returns (state, metrics).
    ``f_samples`` optionally injects the F-RANSAC sample indices."""
    dev = state.status.device
    if to_host(int, state.frame_count) == 0:
        kfs, _ = insert_keyframe(state.kfs, frame)
        st = state.replace(prev=frame, kfs=kfs)
        return st, metrics(frame, status=st.status,
                           n_keyframes=kfs.valid.sum())

    prev, curr = state.prev, frame
    res = match_features_pallas(
        prev.desc, prev.xy, prev.kp_valid, curr.desc, curr.xy, curr.kp_valid,
        min_radius=cfg.match_min_radius, max_radius=cfg.match_max_radius,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    n_matches = res.mask.sum()
    uv0 = prev.xy
    uv1 = curr.xy[torch.where(res.mask, res.idx, 0).to(torch.int64)]
    valid = res.mask

    H = estimate_homography(uv0, uv1, valid.to(torch.float32))
    fres = ransac_fundamental(generator, uv0, uv1, valid,
                              n_hypotheses=cfg.ransac_hypotheses,
                              threshold=cfg.f_inlier_threshold,
                              samples=f_samples)
    s_h, h_inl = homography_score(H, uv0, uv1, valid,
                                  th=cfg.h_inlier_threshold)
    s_f, f_inl = fundamental_score(fres.model, uv0, uv1, valid,
                                   th=cfg.f_inlier_threshold,
                                   th_score=cfg.h_inlier_threshold)
    use_h = to_host(bool, s_h / torch.clamp(s_h + s_f, min=1e-6)
                    > cfg.hf_model_ratio)
    Kopt = cam.Kopt
    if use_h:
        rvec, tvec, X, good, _ = recover_pose_from_homography(
            H, Kopt, Kopt, uv0, uv1, valid & h_inl,
            max_reproj_err=cfg.max_reproj_error)
        mean_err = mean_transfer_error(H, uv0, uv1, valid & h_inl)
    else:
        E = Kopt.T @ fres.model @ Kopt
        rvec, tvec, X, good, _ = recover_pose_from_essential(
            E, Kopt, Kopt, uv0, uv1, valid & f_inl,
            max_reproj_err=cfg.max_reproj_error)
        mean_err = mean_epipolar_error(fres.model, uv0, uv1, valid & f_inl)

    z3 = torch.zeros(3, device=dev)
    F_pose = fundamental_from_poses(Kopt, z3, z3, Kopt, rvec, tvec)
    keep = filter_matches_epipolar(F_pose, uv0, uv1, X, z3, z3, rvec, tvec,
                                   cfg.epipolar_max_error, valid=good)
    n_keep = keep.sum()
    enough = ((n_matches >= cfg.min_init_matches)
              & (n_keep >= cfg.min_init_matches)
              & (mean_err < cfg.max_reproj_error))
    if not to_host(bool, enough):
        fails = to_host(int, state.init_fail_count) + 1
        if fails > cfg.keyframe_time_lag:
            kfs = empty_keyframes(cfg.max_keyframes, cfg.max_keypoints,
                                  cfg.desc_words, dev)
            kfs, _ = insert_keyframe(kfs, frame)
            st = state.replace(prev=frame, kfs=kfs,
                               init_fail_count=scalar(0, dev))
        else:
            st = state.replace(init_fail_count=scalar(fails, dev))
        return st, metrics(curr, status=st.status, n_matches=n_matches,
                           n_keyframes=st.kfs.valid.sum())

    # seed the map: landmarks from the kept matches, seen by both keyframes
    tgt = torch.where(keep, res.idx, 0).to(torch.int64)
    lms, ids = add_landmarks(
        state.lms, X, curr.desc[tgt], keep,
        torch.full(keep.shape, 2, dtype=torch.int32, device=dev),
        colors=curr.color[tgt])
    ok = ids >= 0
    lms = add_descriptors(lms, torch.where(ok, ids, -1), prev.desc,
                          colors=prev.color)
    prev_linked = prev.replace(landmark=torch.where(ok, ids, -1))
    curr_posed = curr.replace(
        rvec=rvec, tvec=tvec,
        landmark=_set_drop(torch.full_like(curr.landmark, -1),
                           torch.where(ok, res.idx, cfg.max_keypoints), ids))
    kfs = empty_keyframes(cfg.max_keyframes, cfg.max_keypoints,
                          cfg.desc_words, dev)
    kfs, _ = insert_keyframe(kfs, prev_linked)
    kfs, _ = insert_keyframe(kfs, curr_posed)

    # pair BA gauge-fixed on keyframe 0, on compact axes (2 cameras, at
    # most max_keypoints landmarks)
    kfs2 = kfs.replace(frames=kfs.frames.map(lambda x: x[:2]),
                       valid=kfs.valid[:2])
    obs = observations_from_keyframes(kfs2, lms.valid)
    ba_xyz, ba_lm_free, ba_obs, inv = compact_ba_problem(
        lms.xyz, lms.valid, obs, cfg.max_keypoints)
    count("implicit_sync")  # a blocking copy to the card
    cam_free2 = torch.tensor([False, True], device=dev)
    rv2, tv2, xyz_c, _ = run_ba(
        Kopt, kfs2.frames.rvec, kfs2.frames.tvec, ba_xyz, ba_obs,
        cam_free=cam_free2, lm_free=ba_lm_free, iterations=cfg.ba_iterations,
        lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
        lam_down=cfg.ba_lambda_down, huber_delta=cfg.ba_huber_delta,
        tol=cfg.ba_tol)
    xyz = scatter_back_landmarks(lms.xyz, xyz_c, inv)
    fr = kfs.frames
    kfs = kfs.replace(frames=fr.replace(
        rvec=torch.cat([rv2, fr.rvec[2:]]), tvec=torch.cat([tv2, fr.tvec[2:]])))
    live = lms.valid.to(torch.int32)
    lms2 = lms.replace(xyz=xyz, t_alive=lms.t_alive + live,
                       kf_alive=lms.kf_alive + live)
    new_prev = curr_posed.replace(rvec=rv2[1], tvec=tv2[1])
    st = state.replace(
        status=scalar(RUNNING, dev), rep_desc=representative_descriptors(lms2),
        prev=new_prev, kfs=kfs, lms=lms2, last_kf_frame_no=curr.frame_no,
        last_kf_tracked=n_keep.to(torch.int32),
        init_fail_count=scalar(0, dev))
    return st, metrics(
        curr, status=st.status, n_matches=n_matches, n_inliers=n_keep,
        n_tracked=n_keep, n_landmarks=lms2.valid.sum(), n_keyframes=2,
        keyframe_added=True, rvec=rv2[1], tvec=tv2[1])
