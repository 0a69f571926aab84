"""Frozen copy of the scan generator: ``SpriteScene``, ``strafe_trajectory``
and ``umeyama_ate`` from ``sfm_tpu_torch/synthetic.py``, with the two numpy
rotation helpers they use from ``sfm_tpu_torch/np_geometry.py``, as of
commit a3f7eac09f6ff61dad4da7d0b34d6b34dca73db2.  Numpy only: the
benchmark's traffic and its ground truth do not move when the port's copy
does.  ``umeyama`` (the fit itself, returned) is added beside
``umeyama_ate``."""

from __future__ import annotations

import numpy as np


def rodrigues_np(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def log_rotation(R):
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-8:
        return np.zeros(3, np.float32)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (w * theta / (2.0 * np.sin(theta))).astype(np.float32)


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

    def render(self, K, rvec, tvec, h, w, rgb=False):
        """Render one frame: world-frontoparallel textured squares painted
        far-to-near; ``rgb=True`` returns [h, w, 3] with per-sprite
        tints.  (The port's copy also takes a lens; no cell uses one.)"""
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


def umeyama(est, gt):
    """The similarity (s, R, t) that takes ``est`` [n, 3] closest to
    ``gt`` [n, 3] in the least-squares sense (Umeyama 1991)."""
    mu_e = est.mean(0); mu_g = gt.mean(0)
    e = est - mu_e; g = gt - mu_g
    cov = g.T @ e / len(e)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    Rot = U @ S @ Vt
    var_e = (e ** 2).sum() / len(e)
    scale = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    return scale, Rot, mu_g - scale * Rot @ mu_e


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
