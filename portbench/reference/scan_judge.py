"""The plain reference of the scan cells: the ground truth the benchmark
rendered (the scene and every frame's true pose), and the numbers that
hold a scan's answers to it.  Numpy in float64; nothing of the port.

A scan's answers are judged by what a user of them relies on:

- tracking: every frame's pose as the entry returned it.  A frame is
  tracked against the map as it stood, and each mapping pass may move the
  map's gauge (monocular scale is free), so the frames are judged in
  segments, each ending where a mapping pass ran: the poses of a
  segment's frames that ended RUNNING, carried into the scene by the
  similarity fitted to them (``pose_similarity``).  Compared: the median
  camera-centre error in scene units (``track_p50_m``), and the frames
  answered with the frame before's pose bit for bit, which no camera in
  motion gives (``repeat_pct``).  Printed, for the look at the tracker's
  precision: the RMS centre error (``track_err_m``), its part along the
  optical axis (``track_depth_m``), the RMS rotation error
  (``track_rot_mrad``), each frame's motion error over the mean true
  motion (``track_rpe_pct``), and the frames after the first RUNNING one
  that did not end RUNNING (``lost_pct``);
- mapping: the live landmarks, carried into the scene by the similarity
  of the keyframes' whole poses to the true ones, by their median
  distance to the nearest sprite square (``map_off_m``, compared), and
  the keyframe poses' error after a fit to their centres (``kf_ate_pct``,
  printed);
- the mapping BA: the map's robust cost per observation, the median
  squared reprojection error in px^2 of its observations (each keyframe
  keypoint linked to a live landmark) under its own keyframe poses and
  landmark positions (``map_cost_px2``, compared; its square root
  ``reproj_px`` printed).

Each is None where a scan gives no number (fewer than three poses to
align): a missing number fails the comparison."""

from __future__ import annotations

import numpy as np

from .synthetic import log_rotation, rodrigues_np, umeyama


def centres(rv, tv):
    """Camera centres [n, 3] of world-to-camera poses."""
    return np.stack([-rodrigues_np(np.asarray(r, np.float64)).T
                     @ np.asarray(t, np.float64) for r, t in zip(rv, tv)])


def aligned_error(est, gt):
    """(RMS error after the similarity fit, the fit (s, R, t))."""
    s, R, t = umeyama(est, gt)
    res = gt - (s * est @ R.T + t)
    return float(np.sqrt((res ** 2).sum(1).mean())), (s, R, t)


def extent(gt_c):
    """The largest distance of a true camera centre from the first."""
    return float(np.linalg.norm(gt_c - gt_c[0], axis=1).max())


def pose_similarity(est_rv, est_tv, gt_rv, gt_tv):
    """The similarity (s, Q, t) taking the map's world into the scene's,
    fitted to whole keyframe poses: Q from the camera orientations (a
    strafe's centres lie near a line, which leaves a fit to centres
    alone free to turn about it), then s and t from the centres."""
    M = sum(rodrigues_np(np.asarray(g, np.float64)).T
            @ rodrigues_np(np.asarray(e, np.float64))
            for e, g in zip(est_rv, gt_rv))
    U, _, Vt = np.linalg.svd(M)
    Q = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    e, g = centres(est_rv, est_tv), centres(gt_rv, gt_tv)
    de, dg = e - e.mean(0), g - g.mean(0)
    # a similarity scales by s > 0: a negative fit (answers mirrored
    # through a point, as poses inverted give) carries nothing
    s = max(float((dg * (de @ Q.T)).sum() / max((de ** 2).sum(), 1e-12)),
            0.0)
    return s, Q, g.mean(0) - s * Q @ e.mean(0)


def sprite_distance(X, centers, size):
    """Distance of each point X [n, 3] to the nearest sprite: a square of
    side ``size`` parallel to the image plane (z = const) at each centre."""
    d = X[:, None, :] - centers[None, :, :]
    dx = np.maximum(np.abs(d[..., 0]) - size / 2, 0.0)
    dy = np.maximum(np.abs(d[..., 1]) - size / 2, 0.0)
    return np.sqrt(dx ** 2 + dy ** 2 + d[..., 2] ** 2).min(1)


def reprojection_px(K, snap):
    """The reprojection error of each of the map's observations, in
    pixels, float64."""
    errs = []
    K = np.asarray(K, np.float64)
    for k in np.nonzero(snap["kf_valid"])[0]:
        ids = snap["kf_landmark"][k]
        ok = snap["kf_kp_valid"][k] & (ids >= 0)
        ok[ok] = snap["lm_valid"][ids[ok]]
        if not ok.any():
            continue
        R = rodrigues_np(snap["kf_rvec"][k].astype(np.float64))
        p = snap["lm_xyz"][ids[ok]].astype(np.float64) @ R.T \
            + snap["kf_tvec"][k].astype(np.float64)
        uv = p[:, :2] / p[:, 2:] @ K[:2, :2].T + K[:2, 2]
        errs.append(np.linalg.norm(uv - snap["kf_xy"][k][ok], axis=1))
    return np.concatenate(errs) if errs else None


def judge_scan(frames, gt_rv, gt_tv, snap, scene, K):
    """The numbers of one scan.  ``frames``: the entry's per-frame answers
    in order, each with ``frame_no``, ``status``, ``rvec``, ``tvec`` and
    ``segment`` (the mapping passes run before it);
    ``gt_rv`` / ``gt_tv``: the true pose of each frame number; ``snap``:
    the final map (``kf_*`` and ``lm_*`` arrays); ``scene``: the rendered
    scene (``centers``, ``size``)."""
    out = dict.fromkeys(NUMBERS)
    if len(frames) >= 2:
        same = [np.array_equal(a["rvec"], b["rvec"])
                and np.array_equal(a["tvec"], b["tvec"])
                for a, b in zip(frames[:-1], frames[1:])]
        out["repeat_pct"] = 100.0 * float(np.mean(same))
    status = np.array([f["status"] for f in frames])
    running = np.nonzero(status == 1)[0]
    if len(running) == 0:
        return out
    after = status[running[0]:]
    out["lost_pct"] = 100.0 * float((after != 1).mean())
    fno = np.array([frames[i]["frame_no"] for i in running])
    gt_c = centres(gt_rv[fno], gt_tv[fno])
    ext = extent(gt_c)
    err, step_err, step, rot, depth = [], [], [], [], []
    for seg in sorted({frames[i]["segment"] for i in running}):
        idx = [i for i in running if frames[i]["segment"] == seg]
        if len(idx) < 3:
            continue
        f = np.array([frames[i]["frame_no"] for i in idx])
        rv = [frames[i]["rvec"] for i in idx]
        tv = [frames[i]["tvec"] for i in idx]
        s, Q, t = pose_similarity(rv, tv, gt_rv[f], gt_tv[f])
        g = centres(gt_rv[f], gt_tv[f])
        e = s * centres(rv, tv) @ Q.T + t
        err.append(np.linalg.norm(g - e, axis=1))
        # the error along each true camera's optical axis
        depth.append(np.abs(np.einsum(
            "ni,ni->n", g - e,
            np.stack([rodrigues_np(np.asarray(r, np.float64))[2]
                      for r in gt_rv[f]]))))
        rot.append([np.linalg.norm(log_rotation(
            rodrigues_np(np.asarray(gr, np.float64)) @ Q
            @ rodrigues_np(np.asarray(r, np.float64)).T))
            for r, gr in zip(rv, gt_rv[f])])
        nxt = np.nonzero(np.diff(f) == 1)[0]
        step_err.append(np.linalg.norm((e[nxt + 1] - e[nxt])
                                       - (g[nxt + 1] - g[nxt]), axis=1))
        step.append(np.linalg.norm(g[nxt + 1] - g[nxt], axis=1))
    if err:
        e2 = np.concatenate(err) ** 2
        out["track_err_m"] = float(np.sqrt(e2.mean()))
        out["track_p50_m"] = float(np.sqrt(np.median(e2)))
        out["track_depth_m"] = float(np.sqrt(
            (np.concatenate(depth) ** 2).mean()))
        out["track_rot_mrad"] = 1e3 * float(np.sqrt(
            (np.concatenate(rot) ** 2).mean()))
    if step and np.concatenate(step).size:
        se, mot = np.concatenate(step_err), np.concatenate(step)
        out["track_rpe_pct"] = 100.0 * float(np.sqrt((se ** 2).mean())
                                             / mot.mean())
    kv = np.nonzero(snap["kf_valid"])[0]
    if len(kv) >= 3 and ext > 0:
        kfn = snap["kf_frame_no"][kv]
        est = centres(snap["kf_rvec"][kv], snap["kf_tvec"][kv])
        kerr, _ = aligned_error(est, centres(gt_rv[kfn], gt_tv[kfn]))
        out["kf_ate_pct"] = 100.0 * kerr / ext
        X = snap["lm_xyz"][snap["lm_valid"]].astype(np.float64)
        if len(X):
            s, R, t = pose_similarity(snap["kf_rvec"][kv], snap["kf_tvec"][kv],
                                      gt_rv[kfn], gt_tv[kfn])
            Xw = s * X @ R.T + t
            out["map_off_m"] = float(np.median(
                sprite_distance(Xw, scene.centers, scene.size)))
    rp = reprojection_px(K, snap)
    if rp is not None:
        out["reproj_px"] = float(np.median(rp))
        out["map_cost_px2"] = float(np.median(rp ** 2))
    return out


NUMBERS = ("track_p50_m", "track_err_m", "track_depth_m", "track_rot_mrad",
           "track_rpe_pct", "repeat_pct", "lost_pct", "kf_ate_pct",
           "map_off_m", "reproj_px", "map_cost_px2")


def widest(per_scan: list, partial: list = ()) -> dict:
    """Each number's widest reading over the judged scans; None where any
    whole scan gave none.  ``partial``: scans the window cut short, whose
    missing numbers (too few poses yet) are left out, not failed."""
    out = {}
    for k in NUMBERS:
        vals = [s[k] for s in per_scan]
        vals += [s[k] for s in partial if s[k] is not None]
        out[k] = None if not vals or any(v is None for v in vals) \
            else max(vals)
    return out
