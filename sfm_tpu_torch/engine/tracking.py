"""Per-frame tracking — the latency path.

Match the previous frame's map-linked features to the current detections,
PnP-RANSAC the pose (the prior pose is an extra hypothesis), keep inliers,
widen the track set by reprojecting unseen landmarks into the frame, refine
the pose over the widened set, decide keyframe insertion, and swap frame
buffers.  Low-match frames bump ``lost_count`` and keep the old reference
frame; after ``max_lost_frames`` misses the engine goes LOST.  The JAX
package's ``lax.cond`` branches are host branches here, where they skip
work for one scan; ``fleet_tracking_step`` runs a fleet of scans in one
batched pass with the branches as per-scan masks."""

from __future__ import annotations

import torch

from ..ba.core import compact_landmarks
from ..config import SfMConfig
from ..features.flow import associate_flow_to_features, lk_flow
from ..features.match_pallas import match_features_pallas
from ..geometry.camera import depths, project
from ..geometry.pnp import refine_pose, reprojection_errors
from ..guidance import update_guidance
from ..mapstore import (_set_drop, add_descriptors, add_views,
                        increment_age, insert_keyframe, tree_map)
from ..ransac import ransac_pnp, sample_masked_fleet
from ..utils.profiling import count, span, to_host
from .state import (LOST, RUNNING, CameraParams, SfMState, index_state, luma,
                    metrics, scalar, write_scan)


def widen_tracks(cfg: SfMConfig, cam: CameraParams, lms, curr, rep):
    """Project unseen valid landmarks into the frame and match them (window
    around the projection) against still-unmatched detections.  Returns
    the frame with the new links.  A fleet's stores and frame (leading B)
    make one K1 call for every scan."""
    L = lms.valid.shape[-1]
    N = curr.landmark.shape[-1]
    linked = curr.landmark >= 0
    already = _set_drop(torch.zeros_like(lms.valid),
                        torch.where(linked, curr.landmark, L), True)
    proj = project(cam.Kopt, curr.rvec, curr.tvec, lms.xyz)
    depth = depths(curr.rvec, curr.tvec, lms.xyz)
    H, W = cfg.image_size
    in_img = ((proj[..., 0] >= 0) & (proj[..., 0] < W) & (proj[..., 1] >= 0)
              & (proj[..., 1] < H) & (depth > 0))
    cand = lms.valid & ~already & in_img

    Lc = cfg.track_widen_capacity
    if 0 < Lc < L:
        # compact the source axis to the in-view candidates; overflow
        # candidates skip widening this frame
        _, inv = compact_landmarks(cand, Lc)
        sel = torch.clamp(inv, min=0).to(torch.int64)[..., None]
        rep_m = torch.take_along_dim(rep, sel, -2)
        proj_m = torch.take_along_dim(proj, sel, -2)
        cand_m = inv >= 0
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
    """The (BA-optimised) pose of the keyframe with this frame_no (per scan
    for a fleet)."""
    match = st.kfs.valid & (st.kfs.frames.frame_no == frame_no[..., None])
    idx = torch.argmax(match.to(torch.int32), -1)
    val = torch.take_along_dim(getattr(st.kfs.frames, which),
                               idx[..., None, None], -2)[..., 0, :]
    return torch.where(match.any(-1)[..., None], val, default)


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
    with span("track.match"):
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

    if to_host(int, n_matches) < cfg.min_features:
        lost = to_host(int, state.lost_count) + 1
        status = LOST if lost > cfg.max_lost_frames else RUNNING
        st = state.replace(lost_count=scalar(lost, dev),
                           status=scalar(status, dev))
        return st, metrics(curr, status=st.status, n_matches=n_matches,
                           n_landmarks=st.lms.valid.sum(),
                           n_keyframes=st.kfs.valid.sum(), rvec=prev.rvec,
                           tvec=prev.tvec)

    lms = state.lms
    with span("track.pnp"):
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

    with span("track.widen"):
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

    with span("track.refine"):
        # pose-only refinement over the full widened track set
        safe_all = torch.where(linked_all, curr_wide.landmark, 0).to(
            torch.int64)
        w_all = (linked_all & lms.valid[safe_all]).to(torch.float32)
        rv_ref, tv_ref = pnp.rvec, pnp.tvec
        if cfg.track_refine_iters > 0:
            rv_ref, tv_ref = refine_pose(cam.Kopt, pnp.rvec, pnp.tvec,
                                         lms.xyz[safe_all], curr_wide.xy,
                                         w_all, iters=cfg.track_refine_iters)
        curr_wide = curr_wide.replace(rvec=rv_ref, tvec=tv_ref)
        err = reprojection_errors(cam.Kopt, rv_ref, tv_ref, xyz, uv)
        mean_err = torch.sum(torch.where(inl, err, 0.0)) / torch.clamp(
            inl.sum(), min=1)

    with span("track.keyframe"):
        # keyframe policy
        lag_ok = (curr.frame_no - state.last_kf_frame_no) \
            >= cfg.keyframe_time_lag
        enough = n_tracked >= cfg.keyframe_min_tracked
        losing = n_tracked < cfg.keyframe_track_ratio * state.last_kf_tracked
        want_kf = to_host(bool, lag_ok & enough & losing & pnp.ok)

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
                                            st.last_kf_tracked).to(
                                                torch.int32))
            if mapping_fn is None:
                st = st.replace(pending_map_slot=slot)
            elif to_host(int, slot) >= 0:
                st = mapping_fn(st, slot)
                # the track-ratio policy compares against the keyframe's
                # links as the mapping pass just enriched them
                fr2 = st.kfs.frames
                count("implicit_sync", 2)  # two indexes by a tensor
                st = st.replace(last_kf_tracked=(
                    fr2.kp_valid[slot] & (fr2.landmark[slot] >= 0)).sum().to(
                        torch.int32))
            # the optimised keyframe pose becomes the new reference pose
            new_prev = curr_wide.replace(
                rvec=_kf_pose(st, curr.frame_no, curr_wide.rvec, "rvec"),
                tvec=_kf_pose(st, curr.frame_no, curr_wide.tvec, "tvec"))
        count("implicit_sync")  # want_kf's copy to the device
        kf_added = torch.tensor(want_kf, device=dev) & (
            st.last_kf_frame_no == curr.frame_no)
        st = st.replace(prev=new_prev, lms=increment_age(st.lms, 1, 0))
    return st, metrics(
        curr, status=st.status, n_matches=n_matches, n_inliers=pnp.n_inliers,
        n_tracked=n_tracked, n_landmarks=st.lms.valid.sum(),
        n_keyframes=st.kfs.valid.sum(), keyframe_added=kf_added,
        mean_reproj_err=mean_err, ba_dropped_obs=st.ba_dropped_obs,
        rvec=new_prev.rvec, tvec=new_prev.tvec)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a fleet: x [B, L, ...], idx [B, M] -> [B, M, ...]."""
    idx = idx.to(torch.int64)
    return torch.take_along_dim(
        x, idx.reshape(idx.shape + (1,) * (x.dim() - 2)), 1)


def _select(mask: torch.Tensor, new, old):
    """Per scan: ``new`` where mask [B], else ``old`` (tensors or trees)."""
    return tree_map(lambda n, o: torch.where(
        mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), new, old)


def fleet_tracking_step(cfg: SfMConfig, cam: CameraParams, states: SfMState,
                        frames, generators, mapping_fn=None,
                        pnp_samples=None, images=None):
    """The tracking step of a fleet of scans in one batched pass: states
    and frames with a leading scan axis B (``make_frames``).  Returns
    (states, metrics with [B]-leading fields).

    RUNNING scans take the tracking branch: one K1 call for every scan's
    match against its previous frame, PnP RANSAC on every scan in the same
    ops (scan b's samples from ``generators[b]``, or injected as
    ``pnp_samples`` [B, n_hyp, s]), one K1 call for every scan's widening,
    pose refinement and the keyframe policy, the host branches of
    ``tracking_step`` turned into per-scan masks.  A RUNNING scan with too
    few matches takes the lost branch.  Every other scan is left as it
    was (its frame is not consumed: ``frame_count`` does not advance) and
    its metrics are zeros but ``status`` and ``n_detected``; the caller
    steps it through ``step_frame``.

    ``mapping_fn(state, slot) -> state`` runs on each scan that inserts a
    keyframe, scan by scan on its own state; None defers it (the slot is
    recorded in ``pending_map_slot`` and the descriptor votes wait for the
    mapping pass).  ``images`` (the fleet's [B, H, W] or [B, H, W, 3]
    frames) feeds LK flow with ``track_with_flow`` and scan guidance on RGB
    frames; both run scan by scan.  The input states are not modified."""
    dev = states.status.device
    B = states.status.shape[0]
    prev, curr = states.prev, frames
    N = curr.landmark.shape[-1]
    running = states.status == RUNNING
    grey = None
    if images is not None:
        grey = luma(images) if images.dim() == 4 else images

    src_valid = prev.kp_valid & (prev.landmark >= 0)
    res = match_features_pallas(
        prev.desc, prev.xy, src_valid, curr.desc, curr.xy, curr.kp_valid,
        min_radius=cfg.match_min_radius, max_radius=cfg.match_max_radius,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    if cfg.track_with_flow and grey is not None:
        # flow-assisted recall, scan by scan on the RUNNING scans
        idx, mask = res.idx.clone(), res.mask.clone()
        for b in torch.nonzero(running).flatten().tolist():
            flow = lk_flow(states.prev_image[b], grey[b], prev.xy_dist[b],
                           src_valid[b], levels=cfg.flow_levels,
                           iters=cfg.flow_iters)
            fidx, fok = associate_flow_to_features(
                flow.xy, flow.valid, curr.xy_dist[b], curr.kp_valid[b],
                max_dist=cfg.flow_assoc_dist)
            taken = _set_drop(torch.zeros(N, dtype=torch.bool, device=dev),
                              torch.where(mask[b], idx[b], N), True)
            use_flow = fok & ~mask[b] & ~taken[torch.where(
                fok, fidx, 0).to(torch.int64)]
            idx[b] = torch.where(use_flow, fidx, idx[b])
            mask[b] = mask[b] | use_flow
        res = res._replace(idx=idx, mask=mask)
    n_matches = res.mask.sum(-1)
    enough_matches = n_matches >= cfg.min_features
    take = running & enough_matches           # the tracking branch
    lost_now = running & ~enough_matches      # the lost branch

    lms = states.lms
    safe_lm = torch.where(src_valid, prev.landmark, 0)
    xyz = _rows(lms.xyz, safe_lm)
    uv = _rows(curr.xy, torch.where(res.mask, res.idx, 0))
    pnp_valid = res.mask & _rows(lms.valid, safe_lm)
    if pnp_samples is None:
        pnp_samples = sample_masked_fleet(
            generators, pnp_valid, cfg.pnp_hypotheses,
            3 if cfg.pnp_solver == "p3p" else cfg.pnp_sample_size)
    pnp = ransac_pnp(
        None, cam.Kopt, xyz, uv, pnp_valid,
        n_hypotheses=cfg.pnp_hypotheses, sample_size=cfg.pnp_sample_size,
        threshold=cfg.max_reproj_error, refine_iters=cfg.pnp_refine_iters,
        min_inliers=cfg.min_features, prior_rvec=prev.rvec,
        prior_tvec=prev.tvec, fast_path_ratio=cfg.pnp_fast_path_ratio,
        solver=cfg.pnp_solver, samples=pnp_samples)

    # link inlier matches into the current frame; only the tracking
    # branch's scans count views
    inl = pnp.inliers
    curr_linked = curr.replace(
        rvec=pnp.rvec, tvec=pnp.tvec,
        landmark=_set_drop(curr.landmark, torch.where(inl, res.idx, N),
                           prev.landmark))
    lms = add_views(lms, torch.where(inl & take[:, None], prev.landmark, -1))

    curr_wide = widen_tracks(cfg, cam, lms, curr_linked, states.rep_desc)
    linked_all = curr_wide.kp_valid & (curr_wide.landmark >= 0)
    n_tracked = linked_all.sum(-1)

    safe_all = torch.where(linked_all, curr_wide.landmark, 0)
    w_all = (linked_all & _rows(lms.valid, safe_all)).to(torch.float32)
    rv_ref, tv_ref = pnp.rvec, pnp.tvec
    if cfg.track_refine_iters > 0:
        rv_ref, tv_ref = refine_pose(cam.Kopt, pnp.rvec, pnp.tvec,
                                     _rows(lms.xyz, safe_all), curr_wide.xy,
                                     w_all, iters=cfg.track_refine_iters)
    curr_wide = curr_wide.replace(rvec=rv_ref, tvec=tv_ref)
    err = reprojection_errors(cam.Kopt, rv_ref, tv_ref, xyz, uv)
    mean_err = torch.sum(torch.where(inl, err, 0.0), -1) / torch.clamp(
        inl.sum(-1), min=1)

    # keyframe policy
    lag_ok = (curr.frame_no - states.last_kf_frame_no) \
        >= cfg.keyframe_time_lag
    enough = n_tracked >= cfg.keyframe_min_tracked
    losing = n_tracked < cfg.keyframe_track_ratio * states.last_kf_tracked
    want_kf = take & lag_ok & enough & losing & pnp.ok
    kfs, slot = insert_keyframe(states.kfs, curr_wide, want_kf)
    inserted = slot >= 0
    if mapping_fn is not None:
        lms = add_descriptors(
            lms, torch.where(inserted[:, None] & curr_wide.kp_valid,
                             curr_wide.landmark, -1),
            curr_wide.desc, colors=curr_wide.color)
    lost = states.lost_count + 1
    st = states.replace(
        lms=lms, kfs=kfs,
        status=torch.where(lost_now & (lost > cfg.max_lost_frames),
                           LOST, states.status).to(torch.int32),
        lost_count=torch.where(take, 0, torch.where(
            lost_now, lost, states.lost_count)).to(torch.int32),
        last_kf_frame_no=torch.where(inserted, curr.frame_no,
                                     states.last_kf_frame_no),
        last_kf_tracked=torch.where(inserted, n_tracked,
                                    states.last_kf_tracked).to(torch.int32))
    if mapping_fn is None:
        st = st.replace(pending_map_slot=torch.where(
            want_kf, slot, states.pending_map_slot).to(torch.int32))
    else:
        todo = torch.nonzero(inserted).flatten().tolist()
        if todo:
            st = tree_map(torch.clone, st)
        for b in todo:
            sl = int(slot[b])
            sub = mapping_fn(index_state(st, b), sl)
            # the track-ratio policy compares against the keyframe's links
            # as the mapping pass just enriched them
            fr2 = sub.kfs.frames
            sub = sub.replace(last_kf_tracked=(
                fr2.kp_valid[sl] & (fr2.landmark[sl] >= 0)).sum().to(
                    torch.int32))
            write_scan(st, b, sub)
    # the optimised keyframe pose becomes the new reference pose
    new_prev = curr_wide.replace(
        rvec=torch.where(want_kf[:, None], _kf_pose(
            st, curr.frame_no, curr_wide.rvec, "rvec"), curr_wide.rvec),
        tvec=torch.where(want_kf[:, None], _kf_pose(
            st, curr.frame_no, curr_wide.tvec, "tvec"), curr_wide.tvec))
    kf_added = want_kf & (st.last_kf_frame_no == curr.frame_no)
    st = st.replace(prev=_select(take, new_prev, prev),
                    lms=increment_age(st.lms, take.to(torch.int32)[:, None],
                                      0),
                    frame_count=states.frame_count + running.to(torch.int32))
    if cfg.track_with_flow and grey is not None:
        # the flow reference image follows the reference frame
        took = st.prev.frame_no == curr.frame_no
        st = st.replace(prev_image=torch.where(took[:, None, None], grey,
                                               st.prev_image))
    zero = torch.zeros((), device=dev)
    m = metrics(
        curr, status=st.status,
        n_matches=torch.where(running, n_matches, 0),
        n_inliers=torch.where(take, pnp.n_inliers, 0),
        n_tracked=torch.where(take, n_tracked, 0),
        n_landmarks=torch.where(running, st.lms.valid.sum(-1), 0),
        n_keyframes=torch.where(running, st.kfs.valid.sum(-1), 0),
        keyframe_added=kf_added,
        mean_reproj_err=torch.where(take, mean_err, zero),
        ba_dropped_obs=torch.where(take, st.ba_dropped_obs, 0),
        rvec=torch.where(running[:, None], st.prev.rvec, zero),
        tvec=torch.where(running[:, None], st.prev.tvec, zero))
    if images is not None and images.dim() == 4 and cfg.guidance_enabled:
        # scan guidance on every scan that ends RUNNING, scan by scan
        guid = st.guidance.map(torch.clone)
        for b in torch.nonzero(st.status == RUNNING).flatten().tolist():
            gs, out = update_guidance(
                cfg, index_state(guid, b), images[b], st.lms.xyz[b],
                st.lms.valid[b], cam.Kopt, st.prev.rvec[b], st.prev.tvec[b])
            write_scan(guid, b, gs)
            for name, v in (("guid_centroid", out.centroid),
                            ("guid_bbox_center", out.bbox_center),
                            ("guid_bbox_axes", out.bbox_axes),
                            ("guid_bbox_extent", out.bbox_extent)):
                m[name][b] = v
        st = st.replace(guidance=guid)
    return st, m
