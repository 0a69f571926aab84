"""Host-side numpy geometry helpers for synthetic data and evaluation
(a numpy-only copy of ``sfm_tpu.np_geometry``)."""

import numpy as np

DEFAULT_K = np.array([[500.0, 0.0, 320.0],
                      [0.0, 500.0, 240.0],
                      [0.0, 0.0, 1.0]], dtype=np.float32)


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


def project_np(K, R, t, X):
    cam = X @ R.T + t
    uv = cam[:, :2] / cam[:, 2:3]
    return uv @ K[:2, :2].T + K[:2, 2]
