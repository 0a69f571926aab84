"""Synthetic textured-sprite scan generator (numpy only).

A copy of ``sfm_tpu.synthetic``'s ``SpriteScene``, ``degrade``,
``strafe_trajectory`` and ``umeyama_ate``, of ``benchmarks/bench_longscan.py``'s
``serpentine_trajectory`` and scene (``longscan_scene``), and of
``benchmarks/bench_loop_closure.py``'s outward-looking ring orbit
(``ring_loop_trajectory``, ``ring_scene``, ``centres_of`` and its
end-of-loop drift measure, ``loop_drift``): the same seed renders the same
frames in both packages, and this copy runs where JAX is not installed."""

from __future__ import annotations

import numpy as np

from .np_geometry import rodrigues_np, log_rotation


class SpriteScene:
    def __init__(self, rng, n_sprites=140, spread=2.0, depth=(4.0, 7.0),
                 tex_res=6, sprite_size=0.4):
        self.centers = np.stack([
            rng.uniform(-spread, spread, n_sprites),
            rng.uniform(-spread * 0.75, spread * 0.75, n_sprites),
            rng.uniform(depth[0], depth[1], n_sprites)], axis=1)
        self.textures = rng.uniform(40, 250, (n_sprites, tex_res, tex_res))
        self.tints = rng.uniform(0.35, 1.0, (n_sprites, 3))
        self.size = sprite_size
        self.tex_res = tex_res

    def render(self, K, rvec, tvec, h, w, dist=None, rgb=False):
        """Render one frame: world-frontoparallel textured squares painted
        far-to-near.  ``dist`` applies the radial-tangential model
        (k1,k2,p1,p2,k3) to sprite centers; ``rgb=True`` returns
        [h, w, 3] with per-sprite tints."""
        R = rodrigues_np(np.asarray(rvec, np.float64))
        t = np.asarray(tvec, np.float64)
        cam = self.centers @ R.T + t
        img = np.full((h, w, 3) if rgb else (h, w), 25.0, np.float32)
        order = np.argsort(-cam[:, 2])  # far first
        fx, fy = K[0, 0], K[1, 1]
        for i in order:
            z = cam[i, 2]
            if z < 0.5:
                continue
            xn, yn = cam[i, 0] / z, cam[i, 1] / z
            if dist is not None:
                k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
                r2 = xn * xn + yn * yn
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
                yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
                xn, yn = xd, yd
            u = fx * xn + K[0, 2]
            v = fy * yn + K[1, 2]
            half_u = fx * self.size / z / 2
            half_v = fy * self.size / z / 2
            u0, u1 = int(u - half_u), int(u + half_u)
            v0, v1 = int(v - half_v), int(v + half_v)
            if u1 <= 0 or v1 <= 0 or u0 >= w or v0 >= h or u1 <= u0 or v1 <= v0:
                continue
            cu0, cv0 = max(u0, 0), max(v0, 0)
            cu1, cv1 = min(u1, w), min(v1, h)
            tex = self.textures[i]
            ty = ((np.arange(cv0, cv1) - v0) * self.tex_res // max(v1 - v0, 1))
            tx = ((np.arange(cu0, cu1) - u0) * self.tex_res // max(u1 - u0, 1))
            ty = np.clip(ty, 0, self.tex_res - 1)
            tx = np.clip(tx, 0, self.tex_res - 1)
            patch = tex[np.ix_(ty, tx)]
            if rgb:
                img[cv0:cv1, cu0:cu1] = patch[:, :, None] * self.tints[i]
            else:
                img[cv0:cv1, cu0:cu1] = patch
        return img


def degrade(img, rng, noise_std=0.0, blur_len=0, occlusion=0.0):
    """Degradation model for robustness tests: horizontal motion blur (a
    box kernel of ``blur_len`` px), additive Gaussian photometric noise,
    and one random dark rectangle covering ``occlusion`` of the image
    area.  Draws from ``rng`` exactly as the JAX package's copy does."""
    out = np.asarray(img, np.float32).copy()
    if blur_len > 1:
        k = np.ones(blur_len, np.float32) / blur_len
        if out.ndim == 2:
            out = np.stack([np.convolve(row, k, mode="same") for row in out])
        else:
            for c in range(out.shape[2]):
                out[:, :, c] = np.stack(
                    [np.convolve(row, k, mode="same")
                     for row in out[:, :, c]])
    if noise_std > 0:
        out = out + rng.normal(0.0, noise_std, out.shape)
    if occlusion > 0:
        h, w = out.shape[:2]
        area = occlusion * h * w
        rh = int(np.sqrt(area * rng.uniform(0.5, 2.0)))
        rh = min(max(rh, 1), h)
        rw = min(int(area / rh), w)
        y0 = int(rng.integers(0, max(h - rh, 1)))
        x0 = int(rng.integers(0, max(w - rw, 1)))
        out[y0:y0 + rh, x0:x0 + rw] = 20.0
    return np.clip(out, 0.0, 255.0)


def strafe_trajectory(n_frames, step=0.05, yaw_rate=0.004):
    """Mostly-lateral camera motion with mild yaw.  Returns (rvecs, tvecs)
    world-to-camera."""
    rvecs, tvecs = [], []
    for k in range(n_frames):
        c = np.array([step * k, 0.25 * step * np.sin(0.3 * k), 0.0])
        yaw = -yaw_rate * k
        R = np.array([[np.cos(yaw), 0, -np.sin(yaw)],
                      [0, 1, 0],
                      [np.sin(yaw), 0, np.cos(yaw)]])
        tvec = -R @ c
        rvecs.append(log_rotation(R))
        tvecs.append(tvec.astype(np.float32))
    return np.asarray(rvecs, np.float32), np.asarray(tvecs, np.float32)


def serpentine_trajectory(n_frames, amp=5.0, period=256, drift=0.012,
                          yaw_amp=0.10):
    """A loopy lateral sweep: x oscillates (amplitude ``amp``) while y
    drifts slowly, so the camera revisits each x-column every ``period``
    frames, with a deterministic handheld shake on top (without it the
    camera stands still at the sweep's apexes for longer than the lost
    tolerance).  Returns (rvecs, tvecs) world-to-camera."""
    rvecs, tvecs = [], []
    for k in range(n_frames):
        ph = 2 * np.pi * k / period
        shake = np.array([0.028 * np.sin(2 * np.pi * k / 5.0),
                          0.022 * np.sin(2 * np.pi * k / 7.0),
                          0.012 * np.sin(2 * np.pi * k / 11.0)])
        c = np.array([amp * np.sin(ph), drift * k, 0.0]) + shake
        yaw = -yaw_amp * np.cos(ph)
        R = np.array([[np.cos(yaw), 0, -np.sin(yaw)],
                      [0, 1, 0],
                      [np.sin(yaw), 0, np.cos(yaw)]])
        rvecs.append(log_rotation(R))
        tvecs.append((-R @ c).astype(np.float32))
    return np.asarray(rvecs, np.float32), np.asarray(tvecs, np.float32)


def longscan_scene(n_frames):
    """The long-scan scene and trajectory: 2600 sprites of size 0.85 at
    depths 6-11 (40-75 px at f = 525), spread along the serpentine's
    drift.  Returns (scene, rvecs, tvecs)."""
    rng = np.random.default_rng(3)
    scene = SpriteScene(rng, n_sprites=2600, spread=7.0, depth=(6.0, 11.0),
                        sprite_size=0.85)
    scene.centers[:, 1] = rng.uniform(-2.0, 2.0 + 0.012 * n_frames, 2600)
    rvecs, tvecs = serpentine_trajectory(n_frames)
    return scene, rvecs, tvecs


def ring_loop_trajectory(n_frames, radius=6.0, turns=1.12):
    """Outward-looking orbit: the camera on a circle of ``radius`` in the
    x-z plane, looking radially out, ``turns`` > 1 revisiting the start
    region, with a handheld shake.  Returns (rvecs, tvecs)
    world-to-camera."""
    rvecs, tvecs = [], []
    for k in range(n_frames):
        ph = 2 * np.pi * turns * k / n_frames
        shake = np.array([0.028 * np.sin(2 * np.pi * k / 5.0),
                          0.022 * np.sin(2 * np.pi * k / 7.0),
                          0.012 * np.sin(2 * np.pi * k / 11.0)])
        u = np.array([np.sin(ph), 0.0, np.cos(ph)])
        c = radius * u + shake
        # camera z-axis = outward radial: R_wc = Ry(ph)
        R_wc = np.array([[np.cos(ph), 0, np.sin(ph)],
                         [0, 1, 0],
                         [-np.sin(ph), 0, np.cos(ph)]])
        R = R_wc.T
        rvecs.append(log_rotation(R))
        tvecs.append((-R @ c).astype(np.float32))
    return np.asarray(rvecs, np.float32), np.asarray(tvecs, np.float32)


def ring_scene(radius=6.0, r_in=10.0, r_out=13.0, n_sprites=2600):
    """The ring's scene: 2600 sprites of size 0.85 on an annulus of radii
    10-13 around the orbit, heights -2.5 to 2.5."""
    rng = np.random.default_rng(7)
    scene = SpriteScene(rng, n_sprites=n_sprites, sprite_size=0.85)
    psi = rng.uniform(0, 2 * np.pi, n_sprites)
    r = rng.uniform(r_in, r_out, n_sprites)
    scene.centers = np.stack([
        r * np.sin(psi), rng.uniform(-2.5, 2.5, n_sprites),
        r * np.cos(psi)], axis=1)
    return scene


def centres_of(rv, tv):
    """Camera centres [n, 3] of world-to-camera poses."""
    return np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in range(len(rv))])


def loop_drift(traj, frame_nos, rvecs, tvecs):
    """End-of-loop drift: the keyframe centres aligned to the ground truth
    by a similarity fitted on the first quarter of the keyframes only (the
    drift is not smeared over the loop), then the position error of the
    last keyframe.  ``traj`` is [n, 6] (rvec, tvec) sorted by
    ``frame_nos``.  Returns (error at the last keyframe, largest error,
    keyframes)."""
    est = centres_of(traj[:, :3], traj[:, 3:])
    gt = centres_of(rvecs[frame_nos], tvecs[frame_nos])
    q = max(len(est) // 4, 3)
    mu_e, mu_g = est[:q].mean(0), gt[:q].mean(0)
    E, G = est[:q] - mu_e, gt[:q] - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / q)
    sgn = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        sgn[2, 2] = -1
    R = U @ sgn @ Vt
    s = np.trace(np.diag(D) @ sgn) / max((E ** 2).sum() / q, 1e-12)
    err = np.linalg.norm((s * (R @ (est - mu_e).T)).T + mu_g - gt, axis=1)
    return float(err[-1]), float(err.max()), len(est)


def umeyama_ate(est_t, gt_t):
    """Similarity-aligned (Umeyama) absolute trajectory error."""
    mu_e = est_t.mean(0); mu_g = gt_t.mean(0)
    e = est_t - mu_e; g = gt_t - mu_g
    cov = g.T @ e / len(e)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    Rot = U @ S @ Vt
    var_e = (e ** 2).sum() / len(e)
    scale = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    resid = g - scale * e @ Rot.T
    return float(np.sqrt((resid ** 2).sum(1).mean()))


def keyframe_ate(traj, frame_nos, rvecs, tvecs):
    """Sim(3)-aligned keyframe ATE and trajectory extent.  ``traj`` is
    [n, 6] (rvec, tvec) sorted by ``frame_nos``; ground truth is indexed by
    frame number.  Returns (ate, extent) in world units."""
    est_c = np.stack([-rodrigues_np(p[:3]).T @ p[3:] for p in traj])
    gt_c = np.stack([-rodrigues_np(rvecs[f]).T @ tvecs[f]
                     for f in frame_nos])
    extent = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    return umeyama_ate(est_c, gt_c), extent
