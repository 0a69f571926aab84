"""The plain reference of the long-session cell: the numbers that hold one
continuing session's answers, its final map and its global BA calls to
the ground truth and to the float64 reference.  Numpy in float64 for the
session, plain torch for the BA; nothing of the port.

A session is judged whole, by one fit over all of it: its map's gauge is
held by the oldest keyframe and by global BA from the first frame on.

- tracking: the poses the entry answered at the frames where it inserted a
  keyframe, carried into the scene by one similarity fitted to them
  (``pose_similarity``: the rotation from their orientations, then scale
  and shift from their centres), their RMS centre error in % of the
  path's extent as ``keyframe_ate`` takes it (``kf_ate_pct``, compared);
  the frames answered with the frame before's pose bit for bit
  (``repeat_pct``, compared), and those after the first RUNNING one that
  did not end RUNNING (``lost_pct``, printed);
- mapping: as ``scan_judge`` reads a scan's map, the live landmarks'
  median distance to the nearest sprite after the similarity of the map's
  keyframe poses to the true ones (``map_off_m``, compared), the median
  squared reprojection error of the map's observations (``map_cost_px2``,
  compared), and the map's own keyframe ATE by ``keyframe_ate``
  (``map_kf_ate_pct``, printed);
- global BA: for each call, the program's output costed by the float64
  reference on the problem rebuilt from the call's input, against the
  reference's own final cost from the same start and settings, over the
  reference's initial cost (``gba_cost_gap``, compared: the widest over
  the calls).

Each is None where the session gives no number: a missing number fails the
comparison."""

from __future__ import annotations

import numpy as np
import torch

from . import global_ba, scan_judge
from .longscan import keyframe_ate

RUNNING = 1
# landmarks a block in the sprite distance (its [block, sprites, 3] terms)
BLOCK = 2048


def _map_off(snap, kv, gt_rv, gt_tv, scene):
    kfn = snap["kf_frame_no"][kv]
    X = snap["lm_xyz"][snap["lm_valid"]].astype(np.float64)
    if not len(X):
        return None
    s, R, t = scan_judge.pose_similarity(snap["kf_rvec"][kv],
                                         snap["kf_tvec"][kv],
                                         gt_rv[kfn], gt_tv[kfn])
    Xw = s * X @ R.T + t
    d = np.concatenate([scan_judge.sprite_distance(
        Xw[i:i + BLOCK], scene.centers, scene.size)
        for i in range(0, len(Xw), BLOCK)])
    return float(np.median(d))


def _ate_pct(rv, tv, fno, gt_rv, gt_tv):
    """The keyframe ATE of ``keyframe_ate`` (a fit to the centres alone),
    in % of the path's extent."""
    order = np.argsort(fno)
    traj = np.concatenate([np.asarray(rv, np.float64)[order],
                           np.asarray(tv, np.float64)[order]], axis=1)
    ate, ext = keyframe_ate(traj, np.asarray(fno)[order], gt_rv, gt_tv)
    return 100.0 * ate / ext if ext > 0 else None


def _pose_ate_pct(rv, tv, fno, gt_rv, gt_tv):
    """The RMS centre error after the similarity fitted to whole poses
    (``pose_similarity``), in % of ``keyframe_ate``'s extent.  A fit to
    the centres alone cannot tell a near-planar path's poses answered
    inverted (centre t = -R c, about -c) from the truth: half a turn about
    the optical axis carries one onto the other."""
    fno = np.asarray(fno)
    g = scan_judge.centres(gt_rv[fno], gt_tv[fno])
    ext = float(np.linalg.norm(g[np.argmax(fno)] - g[np.argmin(fno)]))
    s, Q, t = scan_judge.pose_similarity(rv, tv, gt_rv[fno], gt_tv[fno])
    e = s * scan_judge.centres(rv, tv) @ Q.T + t
    rms = float(np.sqrt(((g - e) ** 2).sum(1).mean()))
    return 100.0 * rms / ext if ext > 0 else None


def judge_session(frames, gt_rv, gt_tv, snap, scene, K) -> dict:
    """``frames``: the entry's answers over the whole session in order, each
    with ``frame_no``, ``status``, ``rvec``, ``tvec`` and
    ``keyframe_added``; ``gt_rv`` / ``gt_tv``: the true pose of each frame
    number; ``snap``: the final map (``kf_*`` and ``lm_*`` arrays);
    ``scene``: the rendered scene (``centers``, ``size``)."""
    out = dict.fromkeys(("repeat_pct", "lost_pct", "kf_ate_pct",
                         "map_kf_ate_pct", "map_off_m", "reproj_px",
                         "map_cost_px2"))
    if len(frames) >= 2:
        same = [np.array_equal(a["rvec"], b["rvec"])
                and np.array_equal(a["tvec"], b["tvec"])
                for a, b in zip(frames[:-1], frames[1:])]
        out["repeat_pct"] = 100.0 * float(np.mean(same))
    status = np.array([f["status"] for f in frames])
    running = np.nonzero(status == RUNNING)[0]
    if len(running):
        out["lost_pct"] = 100.0 * float(
            (status[running[0]:] != RUNNING).mean())
    kf = [f for f in frames if f["keyframe_added"] and f["status"] == RUNNING]
    if len(kf) >= 3:
        out["kf_ate_pct"] = _pose_ate_pct([f["rvec"] for f in kf],
                                          [f["tvec"] for f in kf],
                                          [f["frame_no"] for f in kf],
                                          gt_rv, gt_tv)
    kv = np.nonzero(snap["kf_valid"])[0]
    if len(kv) >= 3:
        out["map_kf_ate_pct"] = _ate_pct(
            snap["kf_rvec"][kv], snap["kf_tvec"][kv],
            snap["kf_frame_no"][kv], gt_rv, gt_tv)
        out["map_off_m"] = _map_off(snap, kv, gt_rv, gt_tv, scene)
    rp = scan_judge.reprojection_px(K, snap)
    if rp is not None:
        out["reproj_px"] = float(np.median(rp))
        out["map_cost_px2"] = float(np.median(rp ** 2))
    return out


def gba_gap(K, before: dict, after: dict, settings: dict) -> dict:
    """One global BA call: ``before`` the keyframe store and landmarks it
    started from (``problem``'s arguments but ``K`` and ``kmax``), ``after``
    the poses and positions it returned (``rv``, ``tv``, ``X``),
    ``settings`` ``kmax`` and ``solve``'s keywords.  Returns ``gap`` with
    the reference's costs, steps and dropped observations."""
    kw = dict(settings)
    pr = global_ba.problem(K, **before, kmax=kw.pop("kmax"))
    _, _, _, c0, c_ref, taken, n = global_ba.solve(pr, **kw)
    P = global_ba.Problem(pr, torch.float64, kw["huber_delta"])
    c_prog = float(P.cost(*(after[k].double() for k in ("rv", "tv", "X"))))
    return dict(gap=abs(c_prog - c_ref) / c0 if c0 > 0 else None,
                initial=c0, reference=c_ref, program=c_prog, taken=taken,
                iterations=n, dropped=pr["dropped"],
                observations=len(pr["w"]))
