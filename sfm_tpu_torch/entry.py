"""Entry points beside the JAX package's ``__graft_entry__.py``.

``entry()`` returns the FLAGSHIP per-frame step and example arguments.
``dryrun_multichip(n)``, called on every rank of a world of ``n``, builds
the scan x map mesh, steps a tiny fleet split over "scan" through
``build_sharded_step``, runs both distributed BA solvers on a tiny
problem over "map", and one frame of a tiny large-solver engine."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .config import FLAGSHIP, SfMConfig
from .engine.state import CameraParams, init_state, resolve_device
from .engine.step import step_frame

__all__ = ["FLAGSHIP_K", "dryrun_multichip", "entry"]

FLAGSHIP_K = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0],
                       [0.0, 0.0, 1.0]], np.float32)


def _camera(K, device) -> CameraParams:
    Kt = torch.as_tensor(K, device=device)
    return CameraParams(K=Kt, d=torch.zeros(5, device=device), Kopt=Kt)


def entry(device="cuda"):
    """``(fn, (state, image))``: ``fn(state, image) -> (state, metrics)``
    is ``step_frame`` bound to FLAGSHIP and its camera (RANSAC drawing
    from one seeded generator), with a fresh state and a blank frame on
    ``device`` (the card by default; without one it raises)."""
    from .parallel.multiscan import scan_generator
    dev = resolve_device(device)
    cfg = SfMConfig(**FLAGSHIP)
    cam = _camera(FLAGSHIP_K, dev)
    gen = scan_generator(7, 0, dev)

    def fn(state, image):
        return step_frame(cfg, cam, state, image, gen)

    image = torch.zeros((cfg.image_height, cfg.image_width),
                        dtype=torch.float32, device=dev)
    return fn, (init_state(cfg, dev), image)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The JAX package's ``dryrun_multichip`` on ``n_devices`` ranks: every
    rank of an initialised world of that size calls it (``hosts``).  A
    (2, n / 2) scan x map mesh (1 x n for an odd n); the sharded batched
    step of 2 x n_scan tiny scans; the dense and the implicit-Schur
    distributed solvers on a tiny problem over "map"; one step of a tiny
    large-solver engine.  Returns this rank's outputs (metrics and
    solver stats) for a check."""
    from .ba.residuals import Observations
    from .parallel import (build_dist_ba, build_dist_large_ba,
                           build_sharded_step, init_batched_state,
                           make_scan_map_mesh, partition_observations,
                           partition_tables, rank_device,
                           shard_batched_state)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs an "
                           f"initialised world of {n_devices} ranks")
    dev = rank_device(device)
    n_scan = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_scan_map_mesh(n_scan, device=dev)
    n_map = n_devices // n_scan

    cfg = SfMConfig(max_keypoints=64, max_keyframes=4, max_landmarks=128,
                    image_height=96, image_width=128, pyramid_levels=2,
                    ransac_hypotheses=16, pnp_hypotheses=8, ba_iterations=2)
    K = np.array([[100.0, 0, 64.0], [0, 100.0, 48.0], [0, 0, 1]], np.float32)
    cam = _camera(K, dev)

    # data parallelism over scans on "scan"
    B = 2 * n_scan
    states = shard_batched_state(init_batched_state(cfg, B, dev), mesh,
                                 "scan", device=dev)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.uniform(0, 255, (B, 96, 128)).astype(
        np.float32))
    images = shard_batched_state(images, mesh, "scan", device=dev)
    step = build_sharded_step(cfg, cam, mesh)
    states, metrics = step(states, images)

    # landmark sharding for distributed BA on "map"
    n_cams, n_pts = 3, 4 * n_map
    X = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                  rng.uniform(3, 5, n_pts)], 1).astype(np.float32)
    rvecs = np.zeros((n_cams, 3), np.float32)
    tvecs = np.stack([np.array([0.2 * c, 0, 0], np.float32)
                      for c in range(n_cams)])
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    lm_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    proj = X[lm_idx] + tvecs[cam_idx]
    uv = (proj[:, :2] / proj[:, 2:3]) * 100.0 + np.array([64.0, 48.0])
    obs = Observations(torch.from_numpy(cam_idx).long(),
                       torch.from_numpy(lm_idx).long(),
                       torch.from_numpy(uv.astype(np.float32)),
                       torch.ones(len(cam_idx)))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    cam_free = torch.ones(n_cams, dtype=torch.bool, device=dev)
    cam_free[0] = False
    lm_free = torch.ones(n_pts, dtype=torch.bool, device=dev)
    obs_sh, shard_size = partition_observations(obs, n_pts, n_map,
                                                cap_per_shard=4 * n_cams)
    dense = build_dist_ba(mesh, "map", n_cams=n_cams, shard_size=shard_size,
                          iterations=2)
    out = dense(t(K), t(rvecs), t(tvecs), t(X) + 0.01,
                Observations(*map(t, obs_sh)), cam_free, lm_free)

    # the implicit-Schur solver (K2, K3 and K3-gather on the card) on "map"
    tabs, shard_size2 = partition_tables(obs, n_cams, n_pts, n_map,
                                         nmax=n_pts, kmax=n_cams)
    large = build_dist_large_ba(mesh, "map", n_cams=n_cams,
                                shard_size=shard_size2, iterations=2,
                                cg_iterations=4)
    out2 = large(t(K), t(rvecs), t(tvecs), t(X) + 0.01,
                 type(tabs)(*map(t, tabs)), cam_free, lm_free)

    # one frame of the large-solver engine configuration at a tiny size
    cfg_l = SfMConfig(max_keypoints=64, max_keyframes=8, max_landmarks=256,
                      image_height=96, image_width=128, pyramid_levels=2,
                      ransac_hypotheses=16, pnp_hypotheses=8,
                      ba_solver="large", ba_kmax=4, ba_iterations=2,
                      ba_cg_iterations=4, ba_local_window=4,
                      ba_landmark_capacity=128, mapping_reobs_capacity=128)
    from .parallel.multiscan import scan_generator
    img = t(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    _, m_l = step_frame(cfg_l, cam, init_state(cfg_l, dev), img,
                        scan_generator(7, 0, dev))
    return dict(metrics=metrics, dist_ba=out, dist_large_ba=out2,
                large_engine=m_l)
