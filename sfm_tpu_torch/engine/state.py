"""Engine state and frame construction.

``SfMState`` holds the whole engine state as fixed-capacity tensors (the
counterpart of the JAX package's state pytree; there are no weights).  The
scalars are 0-dim tensors on the engine's device.  Randomness is not part
of the state: the engine owns a ``torch.Generator``.

``state_from_numpy`` / ``state_to_numpy`` carry a state across from the
JAX package (after ``jax.device_get``) and back."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import SfMConfig
from ..features.descriptor import describe_canvas
from ..features.detect import detect
from ..geometry.camera import undistort_pixels
from ..mapstore import (Frame, KeyframeStore, LandmarkStore, _Tree,
                        empty_frame, empty_keyframes, empty_landmarks)

NOT_INITIALIZED = 0
RUNNING = 1
LOST = 2


class CameraParams(NamedTuple):
    K: torch.Tensor      # [3, 3] raw intrinsics
    d: torch.Tensor      # [5] distortion (k1, k2, p1, p2, k3)
    Kopt: torch.Tensor   # [3, 3] rectified pinhole model


@dataclasses.dataclass
class SfMState(_Tree):
    status: torch.Tensor            # [] int32
    prev: Frame                     # reference frame
    kfs: KeyframeStore
    lms: LandmarkStore
    frame_count: torch.Tensor       # [] int32 frames seen
    last_kf_frame_no: torch.Tensor  # [] int32 keyframe policy lag
    last_kf_tracked: torch.Tensor   # [] int32 tracked count at last KF
    lost_count: torch.Tensor        # [] int32 consecutive low-match frames
    init_fail_count: torch.Tensor   # [] int32 bootstrap anti-stall
    rep_desc: torch.Tensor          # [L, W] int32 landmark majority
                                    # descriptors (refreshed per mapping pass)
    pending_map_slot: torch.Tensor  # [] int32 deferred mapping slot (-1 none)
    ba_dropped_obs: torch.Tensor    # [] int32 (the large solver's counter;
                                    # always 0 with the dense solver)


def scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_state(cfg: SfMConfig, device) -> SfMState:
    return SfMState(
        status=scalar(NOT_INITIALIZED, device),
        prev=empty_frame(cfg.max_keypoints, cfg.desc_words, device),
        kfs=empty_keyframes(cfg.max_keyframes, cfg.max_keypoints,
                            cfg.desc_words, device),
        lms=empty_landmarks(cfg.max_landmarks, cfg.desc_bits, device),
        frame_count=scalar(0, device),
        last_kf_frame_no=scalar(-10 ** 6, device),
        last_kf_tracked=scalar(0, device),
        lost_count=scalar(0, device),
        init_fail_count=scalar(0, device),
        rep_desc=torch.zeros((cfg.max_landmarks, cfg.desc_words),
                             dtype=torch.int32, device=device),
        pending_map_slot=scalar(-1, device),
        ba_dropped_obs=scalar(0, device),
    )


def metrics(state: SfMState, frame: Frame, **kw) -> dict:
    """Per-frame metrics (tensors on the device; the host fetches a chunk's
    worth at once).  Unset counters are 0."""
    dev = state.status.device
    z = scalar(0, dev)
    m = dict(status=state.status, n_detected=frame.kp_valid.sum(),
             n_matches=z, n_inliers=z, n_tracked=z,
             n_landmarks=state.lms.valid.sum(),
             n_keyframes=state.kfs.valid.sum(),
             keyframe_added=torch.tensor(False, device=dev),
             mean_reproj_err=torch.tensor(0.0, device=dev),
             ba_dropped_obs=state.ba_dropped_obs,
             rvec=torch.zeros(3, device=dev), tvec=torch.zeros(3, device=dev))
    m.update(kw)
    return m


def make_frame(cfg: SfMConfig, cam: CameraParams, image: torch.Tensor,
               frame_no: torch.Tensor) -> Frame:
    """Detect, describe, and undistort every keypoint into the Kopt model.
    ``image`` is [H, W] grey, float32 on the engine's device."""
    kps, canvas = detect(image, max_keypoints=cfg.max_keypoints,
                         levels=cfg.pyramid_levels,
                         threshold=cfg.fast_threshold,
                         nms_radius=cfg.nms_radius, return_canvas=True)
    desc = describe_canvas(canvas, kps, cfg.pyramid_levels, cfg.image_width,
                           cfg.desc_bits)
    xy_und = undistort_pixels(cam.K, cam.d, cam.Kopt, kps.xy)
    xi = torch.clamp(kps.xy[:, 0].to(torch.int64), 0, cfg.image_width - 1)
    yi = torch.clamp(kps.xy[:, 1].to(torch.int64), 0, cfg.image_height - 1)
    grey = image[yi, xi]
    return Frame(
        xy=xy_und, xy_dist=kps.xy, desc=desc,
        color=torch.stack([grey] * 3, dim=-1),
        level=kps.level, score=kps.score, kp_valid=kps.valid,
        landmark=torch.full((cfg.max_keypoints,), -1, dtype=torch.int32,
                            device=image.device),
        rvec=torch.zeros(3, device=image.device),
        tvec=torch.zeros(3, device=image.device),
        frame_no=frame_no.clone())


# ---------------------------------------------------------------------------
# carrying state across from the JAX package
# ---------------------------------------------------------------------------

def _to_torch(x, device) -> torch.Tensor:
    a = np.array(x)                # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _from_tree(cls, tree, device):
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(tree, f.name)
        sub = {"prev": Frame, "frames": Frame, "kfs": KeyframeStore,
               "lms": LandmarkStore}.get(f.name)
        out[f.name] = (_from_tree(sub, v, device) if sub is not None
                       else _to_torch(v, device))
    return cls(**out)


def frame_from_numpy(tree, device) -> Frame:
    """The JAX package's ``Frame`` (numpy leaves) -> this package's."""
    return _from_tree(Frame, tree, device)


def state_from_numpy(tree, device) -> SfMState:
    """The JAX package's ``SfMState`` after ``jax.device_get`` (numpy
    leaves; uint32 descriptors are reinterpreted as int32) -> this
    package's state on ``device``.  The JAX-only fields (PRNG key, flow
    image, guidance state) are dropped."""
    return _from_tree(SfMState, tree, device)


def _to_numpy(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj.detach().cpu().numpy()


def state_to_numpy(state: SfMState) -> dict:
    """Nested dict of numpy arrays with the JAX package's field names and
    dtypes (descriptors as uint32)."""
    out = _to_numpy(state)
    out["prev"]["desc"] = out["prev"]["desc"].view(np.uint32)
    out["kfs"]["frames"]["desc"] = out["kfs"]["frames"]["desc"].view(np.uint32)
    out["rep_desc"] = out["rep_desc"].view(np.uint32)
    return out
