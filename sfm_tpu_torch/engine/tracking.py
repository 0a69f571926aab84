"""Per-frame tracking — the latency path.

Match the previous frame's map-linked features to the current detections,
PnP-RANSAC the pose (the prior pose is an extra hypothesis), keep inliers,
widen the track set by reprojecting unseen landmarks into the frame, refine
the pose over the widened set, decide keyframe insertion, and swap frame
buffers.  Low-match frames bump ``lost_count`` and keep the old reference
frame; after ``max_lost_frames`` misses the engine goes LOST.  The JAX
package's ``lax.cond`` branches are host branches here."""

from __future__ import annotations

import torch

from ..ba.core import compact_landmarks
from ..config import SfMConfig
from ..features.flow import associate_flow_to_features, lk_flow
from ..features.match_pallas import match_features_pallas
from ..geometry.camera import depths, project
from ..geometry.pnp import refine_pose, reprojection_errors
from ..mapstore import (_set_drop, add_descriptors, add_views,
                        increment_age, insert_keyframe)
from ..ransac import ransac_pnp
from .state import LOST, RUNNING, CameraParams, SfMState, metrics, scalar


def widen_tracks(cfg: SfMConfig, cam: CameraParams, lms, curr, rep):
    """Project unseen valid landmarks into the frame and match them (window
    around the projection) against still-unmatched detections.  Returns
    the frame with the new links."""
    L = lms.valid.shape[0]
    N = curr.landmark.shape[0]
    linked = curr.landmark >= 0
    already = _set_drop(torch.zeros(L, dtype=torch.bool, device=rep.device),
                        torch.where(linked, curr.landmark, L), True)
    proj = project(cam.Kopt, curr.rvec, curr.tvec, lms.xyz)
    depth = depths(curr.rvec, curr.tvec, lms.xyz)
    H, W = cfg.image_size
    in_img = ((proj[:, 0] >= 0) & (proj[:, 0] < W) & (proj[:, 1] >= 0)
              & (proj[:, 1] < H) & (depth > 0))
    cand = lms.valid & ~already & in_img

    Lc = cfg.track_widen_capacity
    if 0 < Lc < L:
        # compact the source axis to the in-view candidates; overflow
        # candidates skip widening this frame
        _, inv = compact_landmarks(cand, Lc)
        sel = torch.clamp(inv, min=0).to(torch.int64)
        rep_m, proj_m, cand_m = rep[sel], proj[sel], inv >= 0
        lm_ids = torch.where(inv >= 0, inv, L)
    else:
        rep_m, proj_m, cand_m = rep, proj, cand
        lm_ids = torch.arange(L, dtype=torch.int32, device=rep.device)

    res = match_features_pallas(
        rep_m, proj_m, cand_m, curr.desc, curr.xy, curr.kp_valid & ~linked,
        min_radius=0.0, max_radius=cfg.max_reproj_error,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio,
        window_center0=proj_m)
    new_landmark = _set_drop(curr.landmark,
                             torch.where(res.mask, res.idx, N), lm_ids)
    return curr.replace(landmark=new_landmark)


def _kf_pose(st: SfMState, frame_no, default, which: str):
    """The (BA-optimised) pose of the keyframe with this frame_no."""
    match = st.kfs.valid & (st.kfs.frames.frame_no == frame_no)
    val = getattr(st.kfs.frames, which)[torch.argmax(match.to(torch.int32))]
    return torch.where(match.any(), val, default)


def tracking_step(cfg: SfMConfig, cam: CameraParams, state: SfMState, frame,
                  mapping_fn=None, generator=None, pnp_samples=None,
                  image=None):
    """One RUNNING-state step.  ``mapping_fn(state, slot) -> state`` runs
    when a keyframe is inserted; None defers it (the slot is recorded in
    ``pending_map_slot``).  ``pnp_samples`` optionally injects the PnP
    RANSAC sample indices.  ``image`` is the frame's grey image, used only
    with cfg.track_with_flow."""
    dev = state.status.device
    prev, curr = state.prev, frame
    N = curr.landmark.shape[0]

    src_valid = prev.kp_valid & (prev.landmark >= 0)
    res = match_features_pallas(
        prev.desc, prev.xy, src_valid, curr.desc, curr.xy, curr.kp_valid,
        min_radius=cfg.match_min_radius, max_radius=cfg.match_max_radius,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    if cfg.track_with_flow and image is not None:
        # flow-assisted recall: LK-track the map-linked features whose
        # descriptor match failed and associate the endpoints with still
        # unmatched detections, in distorted pixel space
        flow = lk_flow(state.prev_image, image, prev.xy_dist, src_valid,
                       levels=cfg.flow_levels, iters=cfg.flow_iters)
        fidx, fok = associate_flow_to_features(
            flow.xy, flow.valid, curr.xy_dist, curr.kp_valid,
            max_dist=cfg.flow_assoc_dist)
        taken = _set_drop(torch.zeros(N, dtype=torch.bool, device=dev),
                          torch.where(res.mask, res.idx, N), True)
        use_flow = fok & ~res.mask & ~taken[torch.where(fok, fidx, 0).to(
            torch.int64)]
        res = res._replace(idx=torch.where(use_flow, fidx, res.idx),
                           mask=res.mask | use_flow)
    n_matches = res.mask.sum()

    if int(n_matches) < cfg.min_features:
        lost = int(state.lost_count) + 1
        status = LOST if lost > cfg.max_lost_frames else RUNNING
        st = state.replace(lost_count=scalar(lost, dev),
                           status=scalar(status, dev))
        return st, metrics(curr, status=st.status, n_matches=n_matches,
                           n_landmarks=st.lms.valid.sum(),
                           n_keyframes=st.kfs.valid.sum(), rvec=prev.rvec,
                           tvec=prev.tvec)

    lms = state.lms
    safe_lm = torch.where(src_valid, prev.landmark, 0).to(torch.int64)
    xyz = lms.xyz[safe_lm]
    uv = curr.xy[torch.where(res.mask, res.idx, 0).to(torch.int64)]
    pnp = ransac_pnp(
        generator, cam.Kopt, xyz, uv, res.mask & lms.valid[safe_lm],
        n_hypotheses=cfg.pnp_hypotheses, sample_size=cfg.pnp_sample_size,
        threshold=cfg.max_reproj_error, refine_iters=cfg.pnp_refine_iters,
        min_inliers=cfg.min_features, prior_rvec=prev.rvec,
        prior_tvec=prev.tvec, fast_path_ratio=cfg.pnp_fast_path_ratio,
        solver=cfg.pnp_solver, samples=pnp_samples)

    # link inlier matches into the current frame
    inl = pnp.inliers
    curr_linked = curr.replace(
        rvec=pnp.rvec, tvec=pnp.tvec,
        landmark=_set_drop(curr.landmark, torch.where(inl, res.idx, N),
                           prev.landmark))
    lms = add_views(lms, torch.where(inl, prev.landmark, -1))

    curr_wide = widen_tracks(cfg, cam, lms, curr_linked, state.rep_desc)
    linked_all = curr_wide.kp_valid & (curr_wide.landmark >= 0)
    n_tracked = linked_all.sum()

    # pose-only refinement over the full widened track set
    safe_all = torch.where(linked_all, curr_wide.landmark, 0).to(torch.int64)
    w_all = (linked_all & lms.valid[safe_all]).to(torch.float32)
    rv_ref, tv_ref = pnp.rvec, pnp.tvec
    if cfg.track_refine_iters > 0:
        rv_ref, tv_ref = refine_pose(cam.Kopt, pnp.rvec, pnp.tvec,
                                     lms.xyz[safe_all], curr_wide.xy, w_all,
                                     iters=cfg.track_refine_iters)
    curr_wide = curr_wide.replace(rvec=rv_ref, tvec=tv_ref)
    err = reprojection_errors(cam.Kopt, rv_ref, tv_ref, xyz, uv)
    mean_err = torch.sum(torch.where(inl, err, 0.0)) / torch.clamp(
        inl.sum(), min=1)

    # keyframe policy
    lag_ok = (curr.frame_no - state.last_kf_frame_no) >= cfg.keyframe_time_lag
    enough = n_tracked >= cfg.keyframe_min_tracked
    losing = n_tracked < cfg.keyframe_track_ratio * state.last_kf_tracked
    want_kf = bool(lag_ok & enough & losing & pnp.ok)

    st = state.replace(lms=lms, lost_count=scalar(0, dev))
    new_prev = curr_wide
    if want_kf:
        kfs, slot = insert_keyframe(st.kfs, curr_wide)
        inserted = slot >= 0
        if mapping_fn is not None:
            st = st.replace(lms=add_descriptors(
                st.lms, torch.where(inserted & curr_wide.kp_valid,
                                    curr_wide.landmark, -1),
                curr_wide.desc, colors=curr_wide.color))
        st = st.replace(
            kfs=kfs,
            last_kf_frame_no=torch.where(inserted, curr.frame_no,
                                         st.last_kf_frame_no),
            last_kf_tracked=torch.where(inserted, n_tracked,
                                        st.last_kf_tracked).to(torch.int32))
        if mapping_fn is None:
            st = st.replace(pending_map_slot=slot)
        elif int(slot) >= 0:
            st = mapping_fn(st, slot)
            # the track-ratio policy compares against the keyframe's links
            # as the mapping pass just enriched them
            fr2 = st.kfs.frames
            st = st.replace(last_kf_tracked=(
                fr2.kp_valid[slot] & (fr2.landmark[slot] >= 0)).sum().to(
                    torch.int32))
        # the optimised keyframe pose becomes the new reference pose
        new_prev = curr_wide.replace(
            rvec=_kf_pose(st, curr.frame_no, curr_wide.rvec, "rvec"),
            tvec=_kf_pose(st, curr.frame_no, curr_wide.tvec, "tvec"))
    kf_added = torch.tensor(want_kf, device=dev) & (
        st.last_kf_frame_no == curr.frame_no)
    st = st.replace(prev=new_prev, lms=increment_age(st.lms, 1, 0))
    return st, metrics(
        curr, status=st.status, n_matches=n_matches, n_inliers=pnp.n_inliers,
        n_tracked=n_tracked, n_landmarks=st.lms.valid.sum(),
        n_keyframes=st.kfs.valid.sum(), keyframe_added=kf_added,
        mean_reproj_err=mean_err, ba_dropped_obs=st.ba_dropped_obs,
        rvec=new_prev.rvec, tvec=new_prev.tvec)
