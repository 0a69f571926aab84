"""Loop-closure detection and correction (the JAX package's
``engine/loop.py``, same names):

 1. detect (``build_loop_probe``): the newest keyframe's unlinked
    keypoints are matched against the representative descriptors of old
    landmarks (``kf_alive >= loop_min_age``) through K1's windowless match,
    and PnP RANSAC fits a pose against the old map.  A confident pose that
    disagrees with the keyframe's odometry pose by more than
    ``loop_min_drift`` is a loop.  A second K1 call against the linked
    keypoints pairs old landmarks with their current-era twins, whose
    pairwise-distance ratios give the monocular scale drift;
 2. correct (``close_loop``, host numpy on copies of the keyframe poses):
    the sim(3) correction at the loop keyframe is interpolated
    log-linearly along the keyframe chain from the era of the oldest
    matched landmark;
 3. restructure: the probe's links go into the loop keyframe, every
    landmark seen twice or more is re-triangulated from its corrected
    keyframes (a batched DLT), and the engine runs global BA twice.

The probe draws its RANSAC samples from a ``torch.Generator`` (the JAX
package folds its state key); ``pnp_samples`` injects them."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ba.core import observations_from_keyframes
from ..ba.large import build_lm_tables_device
from ..config import SfMConfig
from ..features.match_pallas import match_features_pallas
from ..geometry.camera import depths, project
from ..geometry.triangulate import projection_matrix
from ..mapstore import _set_drop
from ..ransac import ransac_pnp
from ..utils.profiling import to_host
from .state import CameraParams, SfMState


class LoopProbe(NamedTuple):
    ok: torch.Tensor            # confident old-map pose found
    rvec: torch.Tensor          # [3] PnP pose in the old-map frame
    tvec: torch.Tensor          # [3]
    n_inliers: torch.Tensor
    drift: torch.Tensor         # camera-centre disagreement odo vs PnP (m)
    links: torch.Tensor         # [N] landmark id per keyframe keypoint (-1)
    min_lm_birth: torch.Tensor  # oldest matched landmark's birth keyframe
    scale: torch.Tensor         # scale-drift estimate s (x_old ~ s x_drift),
                                # 1.0 when unreliable
    scale_ok: torch.Tensor      # the pair estimate passed count + dispersion
    n_pairs: torch.Tensor       # old <-> current landmark pairs behind it


def _centre(rvec, tvec):
    return -(projection_matrix(rvec, tvec)[:, :3].T @ tvec)


def build_loop_probe(cfg: SfMConfig, cam: CameraParams, generator=None):
    """(state, kf_slot, pnp_samples=None) -> LoopProbe, tensors on the
    state's device."""

    def probe(state: SfMState, slot, pnp_samples=None) -> LoopProbe:
        lms, fr = state.lms, state.kfs.frames
        dev = lms.valid.device
        desc, xy, kf_links = fr.desc[slot], fr.xy[slot], fr.landmark[slot]
        L, N = lms.valid.shape[0], xy.shape[0]
        lm_ids = torch.arange(L, dtype=torch.int32, device=dev)
        # landmarks this keyframe already links stay among the sources (they
        # anchor the PnP against texture aliasing) but get no second link
        already = _set_drop(torch.zeros(L, dtype=torch.bool, device=dev),
                            torch.where(kf_links >= 0, kf_links, L), True)
        old = lms.valid & (lms.kf_alive >= cfg.loop_min_age)
        zeros = torch.zeros((L, 2), device=dev)

        def match(targets):
            # every landmark slot against the keyframe, no window
            return match_features_pallas(
                state.rep_desc, zeros, old, desc, xy, targets,
                min_radius=0.0, max_radius=1e9,
                max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)

        res = match(fr.kp_valid[slot] & (kf_links < 0))
        uv = xy[torch.where(res.mask, res.idx, 0).to(torch.int64)]
        pnp = ransac_pnp(
            generator, cam.Kopt, lms.xyz, uv, res.mask & old,
            n_hypotheses=cfg.pnp_hypotheses, sample_size=cfg.pnp_sample_size,
            threshold=cfg.max_reproj_error, refine_iters=cfg.pnp_refine_iters,
            min_inliers=cfg.loop_min_inliers, solver=cfg.reloc_solver,
            samples=pnp_samples)
        links = _set_drop(torch.full((N,), -1, dtype=torch.int32, device=dev),
                          torch.where(pnp.inliers & ~already, res.idx, N),
                          lm_ids)
        # the drift gate: the PnP pose must disagree with the odometry pose
        moved = torch.linalg.norm(_centre(pnp.rvec, pnp.tvec)
                                  - _centre(fr.rvec[slot], fr.tvec[slot]))
        # birth keyframe rank of the oldest inlier landmark: the loop era
        n_kf_now = state.kfs.valid.sum().to(torch.int32)
        birth_min = torch.where(res.mask & old & pnp.inliers,
                                n_kf_now - lms.kf_alive, 2 ** 30).min()

        # scale drift: old landmarks matched to LINKED keypoints pin the
        # same physical point in both eras (X_old, and X_cur through the
        # keypoint's link); geometric gate under the PnP pose
        res2 = match(fr.kp_valid[slot] & (kf_links >= 0))
        kp2 = torch.where(res2.mask, res2.idx, 0).to(torch.int64)
        cur_ids = kf_links[kp2]
        gerr = torch.linalg.norm(
            project(cam.Kopt, pnp.rvec, pnp.tvec, lms.xyz) - xy[kp2], dim=-1)
        z_old = depths(pnp.rvec, pnp.tvec, lms.xyz)
        safe_cur = torch.where(cur_ids >= 0, cur_ids, 0).to(torch.int64)
        pair_ok = (res2.mask & old & pnp.ok & (z_old > 0)
                   & (gerr < 2.0 * cfg.max_reproj_error)
                   & (cur_ids >= 0) & lms.valid[safe_cur]
                   & (lms.kf_alive[safe_cur] < cfg.loop_min_age)
                   & (safe_cur != lm_ids))
        s, s_ok, n_pairs = _scale_from_pairs(
            lms.xyz, lms.xyz[safe_cur], pair_ok,
            min_pairs=cfg.loop_scale_min_pairs,
            max_dispersion=cfg.loop_scale_max_dispersion)
        return LoopProbe(
            ok=pnp.ok & (moved > cfg.loop_min_drift), rvec=pnp.rvec,
            tvec=pnp.tvec, n_inliers=pnp.n_inliers, drift=moved, links=links,
            min_lm_birth=birth_min, scale=s, scale_ok=s_ok, n_pairs=n_pairs)

    return probe


def _scale_from_pairs(Xo, Xc, mask, *, min_pairs: int = 8,
                      max_dispersion: float = 0.15, n_keep: int = 64):
    """Robust monocular scale from old <-> current positions of the same
    points: the median over pairs (i, j) among the first ``n_keep``
    matched rows of |Xo_i - Xo_j| / |Xc_i - Xc_j|.  Returns (s, ok,
    n_points); s is 1.0 when the count or dispersion gate fails."""
    # matched rows first, in index order
    idx = torch.argsort((~mask).to(torch.int32), stable=True)[:n_keep]
    m, xo, xc = mask[idx], Xo[idx], Xc[idx]
    ratios, valid = [], []
    for shift in (1, 2, 3, 5, 8, 13, 21):
        do = torch.linalg.norm(xo - torch.roll(xo, shift, 0), dim=-1)
        dc = torch.linalg.norm(xc - torch.roll(xc, shift, 0), dim=-1)
        ratios.append(do / torch.clamp(dc, min=1e-9))
        valid.append(m & torch.roll(m, shift, 0) & (do > 1e-6) & (dc > 1e-6))
    r, v = torch.cat(ratios), torch.cat(valid)
    med = _masked_median(r, v)
    mad = _masked_median(torch.abs(r - med), v)
    n_points = mask.sum()
    ok = ((n_points >= min_pairs) & torch.isfinite(med)
          & (mad <= max_dispersion * med) & (med > 0.4) & (med < 2.5))
    s = torch.where(ok, torch.clamp(med, 0.4, 2.5), torch.ones_like(med))
    return s, ok, n_points


def _masked_median(vals, mask):
    """NaN-free masked lower median: masked-out lanes sort last as +inf
    and the element at (count - 1) // 2 is taken; +inf when none."""
    srt = torch.sort(torch.where(mask, vals, torch.inf)).values
    cnt = mask.sum()
    idx = torch.clamp((cnt - 1) // 2, 0, vals.shape[0] - 1)
    return torch.where(cnt > 0, srt[idx], torch.inf)


# ------------------------------------------------- SE(3) helpers (numpy)

def _rodr(r):
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _log_so3(R):
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    if th < 1e-9:
        return np.zeros(3)
    if th > np.pi - 1e-4:
        # near pi the sin(th) denominator vanishes: the axis from the
        # diagonal ((R + I) / 2 == k k^T at pi), the minor components from
        # the off-diagonals, the overall sign from the skew part
        A = (R + np.eye(3)) / 2
        k = np.sqrt(np.maximum(np.diag(A), 0.0))
        i = int(np.argmax(k))
        j, l = (i + 1) % 3, (i + 2) % 3
        k[j] = A[i, j] / max(k[i], 1e-12)
        k[l] = A[i, l] / max(k[i], 1e-12)
        n = np.linalg.norm(k)
        k = k / max(n, 1e-12)
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        if np.dot(w, k) < 0:
            k = -k
        return th * k
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def interpolate_corrections(rv, tv, fracs, d_rvec, d_tvec, scale=1.0):
    """Apply the fraction-scaled world-frame sim(3) correction
    x_old = s dR x_drift + dt to each pose.  At fraction a the correction
    is (s^a, exp(a log dR), a dt): pose i keeps R_i dRa^T and moves its
    camera centre to s_a dRa c_i + a dt.  A fraction of 0 leaves the pose
    bit-exact."""
    dR = _rodr(d_rvec)
    w = _log_so3(dR)
    out_r = np.empty_like(rv)
    out_t = np.empty_like(tv)
    for i in range(len(rv)):
        a = float(fracs[i])
        if a == 0.0:
            out_r[i] = rv[i]
            out_t[i] = tv[i]
            continue
        dRi = _rodr(w * a)
        si = float(scale) ** a
        Ri = _rodr(rv[i])
        ci = -Ri.T @ tv[i]
        Rn = Ri @ dRi.T
        cn = si * (dRi @ ci) + a * d_tvec
        out_r[i] = _log_so3(Rn)
        out_t[i] = -Rn @ cn
    return out_r, out_t


def retriangulate_landmarks(cfg: SfMConfig, cam: CameraParams,
                            state: SfMState) -> SfMState:
    """Re-triangulate every landmark with two or more observations from
    its observing keyframes' poses: a weighted homogeneous DLT per
    landmark over the landmark-major tables at ``ba_kmax`` slots, batched
    over every landmark slot.  The others keep their positions, as do
    landmarks whose solve is not finite."""
    lms, kfs = state.lms, state.kfs
    L = lms.valid.shape[0]
    obs = observations_from_keyframes(kfs, lms.valid)
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(obs, L, kmax=cfg.ba_kmax)
    P = (cam.Kopt @ projection_matrix(kfs.frames.rvec, kfs.frames.tvec))[
        lm_cam.to(torch.int64)]                              # [L, k, 3, 4]
    # DLT rows u P3 - P1 and v P3 - P2 per observation, weighted
    rows = torch.stack([lm_uv[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                        lm_uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]], -2)
    A = (rows * lm_w[..., None, None]).reshape(L, -1, 4)
    AtA = A.transpose(1, 2) @ A
    # the inhomogeneous solve with a Tikhonov guard
    M = AtA[:, :3, :3] + 1e-6 * torch.eye(3, device=AtA.device)
    X = -torch.linalg.solve_ex(M, AtA[:, :3, 3])[0]
    ok = lms.valid & ((lm_w > 0).sum(1) >= 2) & torch.isfinite(X).all(1)
    return state.replace(lms=lms.replace(
        xyz=torch.where(ok[:, None], X, lms.xyz)))


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return to_host(lambda t: t.detach().cpu().numpy(), x)
    return np.asarray(x)


def _start_frame(fns, valid, probe) -> int:
    """Frame number where a closure's interpolation starts: the birth-era
    keyframe of the oldest matched landmark."""
    order = np.argsort(np.where(valid, fns, 2**30))
    n_valid = int(valid.sum())
    birth_rank = max(0, min(int(_host(probe.min_lm_birth)), n_valid - 1))
    return int(fns[order[birth_rank]])


def close_loop(cfg: SfMConfig, cam: CameraParams, state: SfMState,
               slot: int, probe: LoopProbe,
               corrected_spans=None) -> SfMState:
    """The loop correction on the host: the sim(3) correction at the loop
    keyframe, interpolated along the keyframe chain from the era of the
    oldest matched landmark; the probe's links written into the loop
    keyframe; the landmarks re-triangulated; the full correction applied
    to the reference frame.  Callers run global BA afterwards.

    Each closure's span starts at its own matched-landmark era, never
    clamped by earlier closures.  Its scale is first-contact only: a span
    that overlaps one of ``corrected_spans`` ((start_fn, loop_fn) pairs
    already closed) takes s = 1.  ``probe`` holds tensors or numpy
    values."""
    kfs = state.kfs
    dev = kfs.valid.device
    valid = _host(kfs.valid)
    fns = _host(kfs.frames.frame_no)
    # the algebra in float64: _rodr of a float32 rvec is orthonormal only
    # to ~1e-7, which moves the angle _log_so3 reads from the trace by up
    # to 1e-7 / sin(theta); a keyframe near half a turn (the ring orbit)
    # then comes back turned by tens of degrees (the JAX package reads
    # float32 copies here)
    rv = _host(kfs.frames.rvec).astype(np.float64)
    tv = _host(kfs.frames.tvec).astype(np.float64)

    # one camera in two world frames: x_cam = R_o x_drift + t_o (odometry)
    # and x_cam = R_p x_old + t_p (PnP against the old map); dR = R_p^T R_o
    # and dt from the camera centres, c_pnp = s dR c_odo + dt
    R_o, t_o = _rodr(rv[slot]), tv[slot]
    R_p = _rodr(_host(probe.rvec).astype(np.float64))
    t_p = _host(probe.tvec).astype(np.float64)
    dR = R_p.T @ R_o
    s = float(_host(probe.scale)) if cfg.loop_use_scale else 1.0
    start_fn = _start_frame(fns, valid, probe)
    loop_fn = int(fns[slot])
    if any(start_fn <= b and loop_fn >= a for a, b in corrected_spans or ()):
        s = 1.0
    dt = -R_p.T @ t_p - s * (dR @ (-R_o.T @ t_o))
    d_rvec = _log_so3(dR)

    # chain fractions: 0 at the loop-start era, 1 at the loop keyframe
    span = max(float(loop_fn - start_fn), 1.0)
    fracs = np.clip((fns - start_fn) / span, 0.0, 1.0) * valid
    rv2, tv2 = interpolate_corrections(rv, tv, fracs, d_rvec, dt, scale=s)
    links = _host(kfs.frames.landmark).copy()
    new_links = _host(probe.links)
    take = new_links >= 0
    links[slot][take] = new_links[take]
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    frames = kfs.frames.replace(rvec=as_t(rv2.astype(np.float32)),
                                tvec=as_t(tv2.astype(np.float32)),
                                landmark=as_t(links))
    state = retriangulate_landmarks(cfg, cam, state.replace(
        kfs=kfs.replace(frames=frames)))
    # the reference frame is at or after the loop keyframe: the full
    # correction puts the next tracking step's pose prior in the corrected
    # frame
    prev = state.prev
    pr, pt = interpolate_corrections(
        _host(prev.rvec).astype(np.float64)[None],
        _host(prev.tvec).astype(np.float64)[None], np.ones(1), d_rvec, dt,
        scale=s)
    return state.replace(prev=prev.replace(
        rvec=as_t(pr[0].astype(np.float32)),
        tvec=as_t(pt[0].astype(np.float32))))
