"""TUM RGB-D dataset format support + trajectory evaluation (a numpy copy
of ``sfm_tpu.io.tum``).

BASELINE.json's accuracy configs are TUM monocular sequences (fr3/teddy,
fr2/desk).  This module loads the TUM layout (rgb.txt index +
groundtruth.txt trajectory), associates timestamps, and computes the
standard sim(3)-aligned ATE metric — so the accuracy benchmarks run
directly once a sequence directory is present (no network access is
assumed anywhere)."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def _read_index(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rest = line.split(None, 1)
            out.append((float(ts), rest.split()[0]))
    return out


def read_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt -> (timestamps [N], poses [N, 7] tx ty tz qx qy qz qw)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            ts.append(vals[0])
            poses.append(vals[1:8])
    return np.asarray(ts), np.asarray(poses, np.float64)


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (the standard TUM tool logic)."""
    pairs = []
    used_b = set()
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt and j not in used_b:
            pairs.append((i, j))
            used_b.add(j)
    return pairs


class TUMSequence:
    """Iterates a TUM sequence's RGB frames with ground-truth poses."""

    def __init__(self, root: str):
        self.root = root
        self.rgb = _read_index(os.path.join(root, "rgb.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt_ts, self.gt_poses = (read_groundtruth(gt_path)
                                     if os.path.exists(gt_path)
                                     else (None, None))

    def __len__(self):
        return len(self.rgb)

    def frames(self):
        from PIL import Image
        from .video import to_gray
        for ts, rel in self.rgb:
            img = np.asarray(Image.open(os.path.join(self.root, rel)))
            rgb = img[..., :3].astype(np.uint8) if img.ndim == 3 else None
            yield ts, to_gray(img), rgb

    def gt_positions_at(self, timestamps: np.ndarray) -> np.ndarray:
        """Interpolated ground-truth camera centers for given timestamps."""
        out = np.zeros((len(timestamps), 3))
        for k, t in enumerate(timestamps):
            i = np.searchsorted(self.gt_ts, t)
            i = np.clip(i, 1, len(self.gt_ts) - 1)
            t0, t1 = self.gt_ts[i - 1], self.gt_ts[i]
            a = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
            out[k] = ((1 - a) * self.gt_poses[i - 1, :3]
                      + a * self.gt_poses[i, :3])
        return out


# TUM freiburg camera intrinsics (public calibration constants)
TUM_INTRINSICS = {
    "fr1": dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                dist=[0.2624, -0.9531, -0.0054, 0.0026, 1.1633]),
    "fr2": dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7,
                dist=[0.2312, -0.7849, -0.0033, -0.0001, 0.9172]),
    "fr3": dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, dist=None),
}


def ate_sim3(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """Similarity-aligned (Umeyama) RMS absolute trajectory error — the
    standard monocular SLAM accuracy metric (scale is unobservable)."""
    mu_e = est_centers.mean(0)
    mu_g = gt_centers.mean(0)
    e = est_centers - mu_e
    g = gt_centers - mu_g
    cov = g.T @ e / len(e)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (e ** 2).sum() / len(e)
    scale = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    resid = g - scale * e @ R.T
    return float(np.sqrt((resid ** 2).sum(1).mean()))
