"""Frozen copy of the long-scan generator: ``serpentine_trajectory``,
``longscan_scene`` and ``keyframe_ate`` from ``sfm_tpu_torch/synthetic.py``
as of commit bb01f0b4b39ca8b2d28331951cfe256e6d14de2a (itself
``benchmarks/bench_longscan.py``'s scene and path), on the frozen
``SpriteScene`` of ``synthetic.py`` beside it.  Numpy only: the session's
frames and its ground truth do not move when the port's copy does."""

from __future__ import annotations

import functools

import numpy as np

from .synthetic import SpriteScene, log_rotation, rodrigues_np, umeyama_ate


def serpentine_trajectory(n_frames, amp=5.0, period=256, drift=0.012,
                          yaw_amp=0.10):
    """A loopy lateral sweep: x oscillates (amplitude ``amp``) while y
    drifts slowly, so the camera revisits each x-column every ``period``
    frames, with a deterministic handheld shake on top.  Returns (rvecs,
    tvecs) world-to-camera."""
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


def keyframe_ate(traj, frame_nos, rvecs, tvecs):
    """Sim(3)-aligned keyframe ATE and trajectory extent.  ``traj`` is
    [n, 6] (rvec, tvec) sorted by ``frame_nos``; ground truth is indexed by
    frame number.  Returns (ate, extent) in world units."""
    est_c = np.stack([-rodrigues_np(p[:3]).T @ p[3:] for p in traj])
    gt_c = np.stack([-rodrigues_np(rvecs[f]).T @ tvecs[f]
                     for f in frame_nos])
    extent = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    return umeyama_ate(est_c, gt_c), extent


@functools.lru_cache(maxsize=1)
def _session(n_frames):
    return longscan_scene(n_frames)


def render(n_frames, lo, hi, K, size):
    """Frames ``lo`` to ``hi`` of the ``n_frames``-frame session, grey
    uint8 [hi - lo, H, W] as a camera gives them (the scene is built once a
    process)."""
    scene, rv, tv = _session(n_frames)
    H, W = size
    return np.stack([np.clip(scene.render(K, rv[i], tv[i], H, W), 0, 255)
                     for i in range(lo, hi)]).astype(np.uint8)
