"""Frame and map query helpers (the JAX package's ``frame_queries.py``):
matched / unmatched keypoints, gathers at indices, the nearest keypoint to
a position, and the landmarks seen by one keyframe or by any.

With fixed shapes these are masks and gathers rather than variable-length
lists: every "extraction" returns the full-capacity array with its
selection mask, and unions are masked reductions over the keyframe link
matrix.  A scatter that the JAX package writes with ``mode="drop"`` writes
here into ``n_landmarks + 1`` rows whose last row takes the dropped
entries and is sliced off."""

from __future__ import annotations

from typing import Tuple

import torch

from .mapstore import Frame, KeyframeStore, LandmarkStore


# ---- frame queries ----

def matched_mask(frame: Frame) -> torch.Tensor:
    """Keypoints linked to a landmark."""
    return frame.kp_valid & (frame.landmark >= 0)


def unmatched_mask(frame: Frame) -> torch.Tensor:
    """Detected but unlinked keypoints."""
    return frame.kp_valid & (frame.landmark < 0)


def matched_points(frame: Frame) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(xy, landmark_ids, mask) of matched keypoints."""
    m = matched_mask(frame)
    return frame.xy, torch.where(m, frame.landmark, -1), m


def unmatched_points(frame: Frame) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xy, mask) of unmatched keypoints."""
    return frame.xy, unmatched_mask(frame)


def _clip(idx, n: int) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(idx), 0, n - 1).to(torch.int64)


def points_at(frame: Frame, idx) -> torch.Tensor:
    """Undistorted points at indices (clipped into range)."""
    return frame.xy[_clip(idx, frame.xy.shape[0]).to(frame.xy.device)]


def descriptors_at(frame: Frame, idx) -> torch.Tensor:
    """Descriptors at indices (clipped into range)."""
    return frame.desc[_clip(idx, frame.desc.shape[0]).to(frame.desc.device)]


def nearest_point_index(frame: Frame, xy: torch.Tensor,
                        max_dist: float = 1.0,
                        distorted: bool = True) -> torch.Tensor:
    """[] int32: the detected keypoint nearest to ``xy`` within
    ``max_dist`` px, or -1 (raw detector positions when ``distorted``)."""
    pts = frame.xy_dist if distorted else frame.xy
    d2 = torch.sum((pts - xy[None, :]) ** 2, dim=-1)
    d2 = torch.where(frame.kp_valid, d2, torch.inf)
    i = torch.argmin(d2)
    return torch.where(d2[i] <= max_dist * max_dist, i, -1).to(torch.int32)


# ---- map queries ----

def _linked(links, ok, n_landmarks: int) -> torch.Tensor:
    out = torch.zeros(n_landmarks + 1, dtype=torch.bool, device=links.device)
    out[torch.where(ok, links, n_landmarks).reshape(-1).to(torch.int64)] = \
        True
    return out[:n_landmarks]


def landmarks_in_keyframe(kfs: KeyframeStore, slot,
                          n_landmarks: int) -> torch.Tensor:
    """[L] bool: the landmarks this keyframe observes."""
    links = kfs.frames.landmark[slot]
    ok = (links >= 0) & kfs.frames.kp_valid[slot] & kfs.valid[slot]
    return _linked(links, ok, n_landmarks)


def landmarks_in_keyframes(kfs: KeyframeStore,
                           n_landmarks: int) -> torch.Tensor:
    """[L] bool: the landmarks observed by any valid keyframe."""
    links = kfs.frames.landmark
    ok = (links >= 0) & kfs.frames.kp_valid & kfs.valid[:, None]
    return _linked(links, ok, n_landmarks)


def live_landmarks(lms: LandmarkStore) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xyz, valid) of every landmark slot."""
    return lms.xyz, lms.valid
