"""Keyframe-rate mapping, run after a keyframe insertion:
 1. triangulation: the new keyframe is matched against a window of older
    keyframes in one batched matcher launch; when several keyframes match
    the same new-keyframe keypoint the oldest wins; winners insert in one
    bulk add;
 2. re-observation: landmarks projected into every window keyframe are
    matched with a reprojection-guided window (one batched launch);
 3. landmark culling and link clearing;
 4. keyframe culling;
 5. bundle adjustment, gauge-fixed on the oldest keyframe: the dense
    solver (``ba_solver="dense"``), the per-observation PCG solver
    (``ba_solver="cg"``) or the implicit-Schur PCG solver on device-built
    landmark-major tables (``ba_solver="large"``, with the K2 / K3 kernels
    on a CUDA device);
 6. map aging."""

from __future__ import annotations

import torch

from ..ba import observations_from_keyframes, run_ba, run_ba_cg
from ..ba.core import (compact_ba_problem, compact_landmarks,
                       observations_from_keyframe_window,
                       scatter_back_landmarks)
from ..ba.large import ObsTables, build_lm_tables_device, run_large_ba
from ..config import SfMConfig
from ..features.match_pallas import match_features_pallas
from ..geometry.camera import depths, project
from ..geometry.epipolar import filter_matches_epipolar, fundamental_from_poses
from ..geometry.triangulate import projection_matrix, triangulate_pair
from ..mapstore import (_set_drop, add_descriptors, add_landmarks,
                        clear_links, cull_keyframes, cull_landmarks,
                        increment_age, kf_view_counts,
                        representative_descriptors)
from .state import CameraParams, SfMState


def _top(score: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest entries, equal scores in index order (the
    order of the reference's top_k)."""
    return torch.sort(score, descending=True, stable=True).indices[:m]


def _recent_valid_slots(kfs, m: int):
    score = torch.where(kfs.valid, kfs.frames.frame_no, -1)
    slots = _top(score, m)
    return slots, score[slots] >= 0


def _covisible_slots(kfs, new_slot, m: int, n_landmarks: int):
    """The m keyframes sharing the most landmark links with ``new_slot``
    (frame number breaks ties)."""
    fr = kfs.frames
    L = n_landmarks
    new_links = fr.landmark[new_slot]
    seen = _set_drop(torch.zeros(L, dtype=torch.bool, device=new_links.device),
                     torch.where(new_links >= 0, new_links, L), True)
    linked = fr.landmark >= 0
    overlap = (linked & seen[torch.clamp(fr.landmark, 0, L - 1).to(
        torch.int64)]).sum(1)
    score = torch.where(kfs.valid,
                        overlap * (1 << 20) + fr.frame_no.to(torch.int64), -1)
    slots = _top(score, m)
    return slots, score[slots] >= 0


def _window_slots(cfg: SfMConfig, kfs, new_slot, m: int, n_landmarks: int):
    if cfg.mapping_use_covisibility:
        return _covisible_slots(kfs, new_slot, m, n_landmarks)
    return _recent_valid_slots(kfs, m)


def _hybrid_slots(cfg: SfMConfig, kfs, new_slot, m: int, n_landmarks: int):
    """Triangulation window: the floor(m/2) most recent keyframes, then the
    most covisible ones not already taken."""
    if not cfg.mapping_use_covisibility:
        return _recent_valid_slots(kfs, m)
    half = m // 2
    r_slots, r_ok = _recent_valid_slots(kfs, m)
    c_slots, c_ok = _covisible_slots(kfs, new_slot, m, n_landmarks)
    r_head, rok_head = r_slots[:half], r_ok[:half]
    dup = torch.any((c_slots[:, None] == r_head[None, :])
                    & rok_head[None, :], dim=1)
    cand = torch.cat([r_head, c_slots])
    ok = torch.cat([rok_head, c_ok & ~dup])
    order = torch.where(ok, torch.arange(cand.shape[0], device=ok.device),
                        cand.shape[0])
    pick = torch.sort(order, stable=True).indices[:m]
    return cand[pick], ok[pick]


def _triangulate_all_pairs(cfg: SfMConfig, cam: CameraParams,
                           state: SfMState, new_slot) -> SfMState:
    kfs, lms = state.kfs, state.lms
    fr = kfs.frames
    Kn, N = fr.landmark.shape
    Wd = fr.desc.shape[-1]
    M = min(cfg.mapping_tri_keyframes + 1, Kn)
    slots, slot_ok = _hybrid_slots(cfg, kfs, new_slot, M, lms.valid.shape[0])
    new_f = kfs.frame(new_slot)
    old = fr.map(lambda x: x[slots])                      # [M, ...]
    usable = (slots != new_slot) & slot_ok
    src_valid = old.kp_valid & (old.landmark < 0) & usable[:, None]
    tgt_valid = new_f.kp_valid & (new_f.landmark < 0)
    res = match_features_pallas(
        old.desc, old.xy, src_valid, new_f.desc.expand(M, N, Wd),
        new_f.xy.expand(M, N, 2), tgt_valid.expand(M, N),
        min_radius=cfg.match_min_radius, max_radius=cfg.mapping_max_radius,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    uv0 = old.xy
    uv1 = new_f.xy[torch.where(res.mask, res.idx, 0).to(torch.int64)]
    P_new = cam.Kopt @ projection_matrix(new_f.rvec, new_f.tvec)
    P0 = cam.Kopt @ projection_matrix(old.rvec, old.tvec)
    X = triangulate_pair(P0, P_new, uv0, uv1)              # [M, N, 3]
    F = fundamental_from_poses(cam.Kopt, old.rvec, old.tvec,
                               cam.Kopt, new_f.rvec, new_f.tvec)
    keeps = filter_matches_epipolar(F, uv0, uv1, X, old.rvec, old.tvec,
                                    new_f.rvec, new_f.tvec,
                                    cfg.epipolar_max_error, valid=res.mask)

    # per new-keyframe keypoint, the oldest keyframe's match wins
    prio = torch.where(slot_ok, fr.frame_no[slots].to(torch.int64), 2 ** 30)
    tgt = torch.where(keeps, res.idx, N).to(torch.int64)   # [M, N]
    cand_prio = prio[:, None].expand(M, N)
    best_prio = torch.full((N + 1,), 2 ** 30, dtype=torch.int64,
                           device=prio.device).scatter_reduce(
        0, tgt.reshape(-1), cand_prio.reshape(-1), reduce="amin")
    winner = keeps & (cand_prio == best_prio[tgt])

    flat_keep = winner.reshape(-1)
    flat_tgt = torch.where(flat_keep, tgt.reshape(-1), 0)
    lms, ids = add_landmarks(
        lms, X.reshape(-1, 3), new_f.desc[flat_tgt], flat_keep,
        torch.full_like(flat_tgt, 2), colors=new_f.color[flat_tgt])
    # stack the old keyframe's observation descriptor too
    lms = add_descriptors(lms, torch.where(ids >= 0, ids, -1),
                          fr.desc[slots].reshape(-1, Wd),
                          colors=fr.color[slots].reshape(-1, 3))
    ok = ids >= 0
    glob = (slots[:, None] * N + torch.arange(N, device=ok.device)).reshape(-1)
    landmark = _set_drop(fr.landmark.reshape(-1),
                         torch.where(ok, glob, Kn * N), ids).reshape(Kn, N)
    landmark[new_slot] = _set_drop(landmark[new_slot],
                                   torch.where(ok, tgt.reshape(-1), N), ids)
    return state.replace(kfs=kfs.replace(frames=fr.replace(landmark=landmark)),
                         lms=lms)


def _in_image(cfg: SfMConfig, proj, depth):
    H, W = cfg.image_size
    return ((proj[..., 0] >= 0) & (proj[..., 0] < W) & (proj[..., 1] >= 0)
            & (proj[..., 1] < H) & (depth > 0))


def _reobserve_all(cfg: SfMConfig, cam: CameraParams, state: SfMState,
                   new_slot) -> SfMState:
    """Re-observation over the covisible (or recent) window anchored on the
    new keyframe.  With ``mapping_reobs_capacity`` > 0 the landmark axis is
    first compacted to the landmarks visible in >= 1 window keyframe;
    overflow candidates retry on the next keyframe."""
    kfs, lms = state.kfs, state.lms
    fr = kfs.frames
    Kn, N = fr.landmark.shape
    L = lms.valid.shape[0]
    Wd = fr.desc.shape[-1]
    rep = state.rep_desc
    R = min(cfg.mapping_reobs_keyframes, Kn)
    slots, slot_ok = _window_slots(cfg, kfs, new_slot, R, L)
    f = fr.map(lambda x: x[slots])                         # [R, ...]

    Lc = cfg.mapping_reobs_capacity
    if 0 < Lc < L:
        vis = _in_image(cfg, project(cam.Kopt, f.rvec, f.tvec, lms.xyz),
                        depths(f.rvec, f.tvec, lms.xyz)) & slot_ok[:, None]
        _, inv = compact_landmarks(lms.valid & vis.any(0), Lc)
        sel = torch.clamp(inv, min=0).to(torch.int64)
        lm_ids = torch.where(inv >= 0, inv, L)
        xyz_m, rep_m, valid_m = lms.xyz[sel], rep[sel], inv >= 0
    else:
        lm_ids = torch.arange(L, dtype=torch.int32, device=rep.device)
        xyz_m, rep_m, valid_m = lms.xyz, rep, lms.valid
    Lm = xyz_m.shape[0]

    linked = f.landmark >= 0                               # [R, N]
    already = torch.zeros((R, L + 1), dtype=torch.bool, device=rep.device)
    already.scatter_(1, torch.where(linked, f.landmark, L).to(torch.int64),
                     True)
    already = already[:, torch.clamp(lm_ids, max=L).to(torch.int64)]
    proj = project(cam.Kopt, f.rvec, f.tvec, xyz_m)        # [R, Lm, 2]
    in_img = _in_image(cfg, proj, depths(f.rvec, f.tvec, xyz_m))
    cand = valid_m[None] & ~already & in_img & slot_ok[:, None]
    res = match_features_pallas(
        rep_m.expand(R, Lm, Wd), proj, cand, f.desc, f.xy,
        f.kp_valid & ~linked, min_radius=0.0,
        max_radius=cfg.max_reproj_error,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio,
        window_center0=proj)
    tgt = torch.where(res.mask, res.idx, N).to(torch.int64)
    links_w = torch.cat([f.landmark, f.landmark.new_zeros((R, 1))], 1)
    links_w = links_w.scatter(1, tgt, lm_ids.expand(R, Lm))[:, :N]

    # newly created links get their observing frame's descriptor + colour
    newly = (links_w >= 0) & (f.landmark < 0)
    lms = add_descriptors(lms, torch.where(newly, links_w, -1).reshape(-1),
                          f.desc.reshape(-1, Wd),
                          colors=f.color.reshape(-1, 3))
    landmark = _set_drop(fr.landmark, torch.where(slot_ok, slots, Kn),
                         links_w)
    return state.replace(kfs=kfs.replace(frames=fr.replace(landmark=landmark)),
                         lms=lms)


def mapping_pass(cfg: SfMConfig, cam: CameraParams, state: SfMState,
                 new_slot) -> SfMState:
    L = cfg.max_landmarks
    state = _triangulate_all_pairs(cfg, cam, state, new_slot)
    state = _reobserve_all(cfg, cam, state, new_slot)

    views = kf_view_counts(state.kfs, L)
    lms, tomb = cull_landmarks(
        state.lms, views, min_views=cfg.cull_min_views,
        young_age=cfg.cull_young_kf_age, view_ratio=cfg.cull_view_ratio)
    fr = state.kfs.frames
    kfs = state.kfs.replace(frames=fr.replace(
        landmark=clear_links(fr.landmark, tomb)))
    prev = state.prev.replace(landmark=clear_links(state.prev.landmark, tomb))
    kfs, _ = cull_keyframes(kfs, L, redundancy=cfg.kf_cull_redundancy,
                            min_others=cfg.kf_cull_min_others)

    # BA gauge-fixed on the oldest keyframe; with ba_local_window > 0 only
    # the most recent poses are free, and the large solver also restricts
    # its observations to the 2x window of recent keyframes (the free ones
    # plus an anchor band of fixed older ones)
    oldest = torch.argmin(torch.where(kfs.valid, kfs.frames.frame_no,
                                      2 ** 30))
    cam_free = kfs.valid.clone()
    cam_free[oldest] = False
    large = cfg.ba_solver == "large"
    local_obs_window = large and cfg.ba_local_window > 0
    if local_obs_window:
        w_slots, w_ok = _recent_valid_slots(
            kfs, min(2 * cfg.ba_local_window, cfg.max_keyframes))
        obs = observations_from_keyframe_window(kfs, lms.valid, w_slots, w_ok)
    else:
        obs = observations_from_keyframes(kfs, lms.valid)
    if cfg.ba_local_window > 0:
        recent, recent_ok = _recent_valid_slots(
            kfs, min(cfg.ba_local_window, cfg.max_keyframes))
        in_window = _set_drop(torch.zeros_like(kfs.valid),
                              torch.where(recent_ok, recent,
                                          cfg.max_keyframes), True)
        cam_free = cam_free & in_window
    # with the local observation window only the landmarks it observes
    # enter the problem (and its compaction)
    ba_valid = lms.valid
    if local_obs_window:
        ba_valid = lms.valid & _set_drop(
            torch.zeros_like(lms.valid),
            torch.where(obs.w > 0, obs.lm_idx, lms.valid.shape[0]), True)
    ba_xyz, ba_lm_free, ba_obs, inv = lms.xyz, ba_valid, obs, None
    if 0 < cfg.ba_landmark_capacity < cfg.max_landmarks:
        ba_xyz, ba_lm_free, ba_obs, inv = compact_ba_problem(
            lms.xyz, ba_valid, obs, cfg.ba_landmark_capacity)
    kw = dict(cam_free=cam_free, lm_free=ba_lm_free,
              iterations=cfg.ba_iterations, lam0=cfg.ba_lambda_init,
              lam_up=cfg.ba_lambda_up, lam_down=cfg.ba_lambda_down,
              huber_delta=cfg.ba_huber_delta, tol=cfg.ba_tol)
    if large:
        lm_cam, lm_uv, lm_w, n_dropped = build_lm_tables_device(
            ba_obs, ba_xyz.shape[0], kmax=cfg.ba_kmax)
        state = state.replace(ba_dropped_obs=n_dropped)
        rv, tv, xyz, _ = run_large_ba(
            cam.Kopt, kfs.frames.rvec, kfs.frames.tvec, ba_xyz,
            ObsTables(lm_cam, lm_uv, lm_w),
            cg_iterations=cfg.ba_cg_iterations, **kw)
    elif cfg.ba_solver == "cg":
        rv, tv, xyz, _ = run_ba_cg(cam.Kopt, kfs.frames.rvec,
                                   kfs.frames.tvec, ba_xyz, ba_obs,
                                   cg_iterations=cfg.ba_cg_iterations, **kw)
    else:
        rv, tv, xyz, _ = run_ba(cam.Kopt, kfs.frames.rvec, kfs.frames.tvec,
                                ba_xyz, ba_obs, **kw)
    if inv is not None:
        xyz = scatter_back_landmarks(lms.xyz, xyz, inv)
    kfs = kfs.replace(frames=kfs.frames.replace(rvec=rv, tvec=tv))
    lms = increment_age(lms.replace(xyz=xyz), 0, 1)
    return state.replace(kfs=kfs, lms=lms, prev=prev,
                         rep_desc=representative_descriptors(lms))
