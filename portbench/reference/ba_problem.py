"""bench_ba's synthetic bundle-adjustment problem, made on the device from a
seed: a frozen copy of ``chip_smoke.py::ba_problem`` (commit
a3f7eac09f6ff61dad4da7d0b34d6b34dca73db2) without its options, drawing
from a ``torch.Generator`` on the problem's device in a few large calls
where the original drew from numpy on the host.  The shapes and the
distributions are the original's: cameras along x (true rotations zero),
each landmark seen by ``obs_per_lm`` consecutive cameras, exact pixels
(f = 525, principal point 320, 240); the start perturbs every rotation but
camera 0's by 0.002 rad per axis and every landmark by 0.05 (normal), and
camera 0 is held fixed.

The result is the raw problem, a COO observation list: what the program
derives from it (its tables, its camera index) is the program's, and the
reference derives its own."""

from __future__ import annotations

import numpy as np
import torch

K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def ba_problem(device, n_cams: int, n_lms: int, obs_per_lm: int,
               seed: int) -> dict:
    g = seed_generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((n_lms, 3), generator=g, **f32)
    X = torch.stack([u[:, 0] * 100 - 50, u[:, 1] * 20 - 10,
                     u[:, 2] * 40 + 20], 1)
    cam_t = torch.zeros((n_cams, 3), **f32)
    cam_t[:, 0] = torch.linspace(-40, 40, n_cams, **f32)
    base = torch.randint(0, n_cams - obs_per_lm, (n_lms,), generator=g,
                         device=device)
    lm_idx = torch.arange(n_lms, device=device).repeat_interleave(obs_per_lm)
    cam_idx = (base[:, None] + torch.arange(obs_per_lm, device=device)
               ).reshape(-1)
    p = X[lm_idx] + cam_t[cam_idx]
    uv = p[:, :2] / p[:, 2:] * 525.0 + torch.tensor([320.0, 240.0], **f32)
    rv0 = torch.zeros((n_cams, 3), **f32)
    rv0[1:] += 0.002
    X0 = X + 0.05 * torch.randn(X.shape, generator=g, **f32)
    cam_free = torch.ones(n_cams, dtype=torch.bool, device=device)
    cam_free[0] = False
    return dict(K=torch.as_tensor(K, device=device), rv=rv0, tv=cam_t,
                X=X0, cam_idx=cam_idx, lm_idx=lm_idx, uv=uv,
                w=torch.ones(len(cam_idx), **f32), cam_free=cam_free,
                lm_free=torch.ones(n_lms, dtype=torch.bool, device=device),
                kmax=obs_per_lm)
