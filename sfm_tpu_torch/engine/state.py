"""Engine state and frame construction.

``SfMState`` holds the whole engine state as fixed-capacity tensors (the
counterpart of the JAX package's state pytree; there are no weights).  The
scalars are 0-dim tensors on the engine's device.  Randomness is not part
of the state: the engine owns a ``torch.Generator``.

``metrics`` builds the per-frame metrics with exactly the fields of the JAX
package's ``StepMetrics``, in its order, dtypes and shapes.

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
from ..guidance import GuidanceState, init_guidance
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
    prev_image: torch.Tensor        # [H, W] grey image of ``prev`` with
                                    # track_with_flow, else [1, 1]
    guidance: GuidanceState         # scan-guidance EMA state
    ba_dropped_obs: torch.Tensor    # [] int32 (the large solver's counter;
                                    # always 0 with the dense solver)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  A CUDA device without a card raises:
    nothing moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev


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
        prev_image=torch.zeros(cfg.image_size if cfg.track_with_flow
                               else (1, 1), device=device),
        guidance=init_guidance(cfg, device),
        ba_dropped_obs=scalar(0, device),
    )


# the JAX package's StepMetrics: field, dtype and shape, in its order
METRIC_FIELDS = (
    ("status", torch.int32, ()), ("n_detected", torch.int32, ()),
    ("n_matches", torch.int32, ()), ("n_inliers", torch.int32, ()),
    ("n_tracked", torch.int32, ()), ("n_landmarks", torch.int32, ()),
    ("n_keyframes", torch.int32, ()), ("keyframe_added", torch.bool, ()),
    ("mean_reproj_err", torch.float32, ()),
    ("ba_dropped_obs", torch.int32, ()),
    ("rvec", torch.float32, (3,)), ("tvec", torch.float32, (3,)),
    ("guid_centroid", torch.float32, (3,)),
    ("guid_bbox_center", torch.float32, (2,)),
    ("guid_bbox_axes", torch.float32, (2, 2)),
    ("guid_bbox_extent", torch.float32, (2,)),
)


def metrics(frame: Frame, **kw) -> dict:
    """Per-frame metrics (tensors on the device; the host fetches a chunk's
    worth at once): ``n_detected`` from the frame, the fields in ``kw``
    cast to their dtypes, zeros elsewhere (as ``zero_metrics()._replace``
    in the JAX package)."""
    dev = frame.kp_valid.device
    kw.setdefault("n_detected", frame.kp_valid.sum())
    m = {}
    for name, dtype, shape in METRIC_FIELDS:
        v = kw.pop(name, None)
        m[name] = (torch.zeros(shape, dtype=dtype, device=dev) if v is None
                   else torch.as_tensor(v, device=dev).to(dtype)
                   .reshape(shape))
    if kw:
        raise KeyError(f"not a metric: {sorted(kw)}")
    return m


def to_gray(image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] RGB -> [H, W] luma; [H, W] grey passes through."""
    if image.dim() == 3:
        return (0.299 * image[..., 0] + 0.587 * image[..., 1]
                + 0.114 * image[..., 2])
    return image


def make_frame(cfg: SfMConfig, cam: CameraParams, image: torch.Tensor,
               frame_no: torch.Tensor) -> Frame:
    """Detect, describe, and undistort every keypoint into the Kopt model.
    ``image`` is [H, W] grey or [H, W, 3] RGB, float32 on the engine's
    device: detection runs on its luma, and the keypoint colours are sampled
    from the RGB image (grey replicated otherwise)."""
    grey = to_gray(image)
    kps, canvas = detect(grey, max_keypoints=cfg.max_keypoints,
                         levels=cfg.pyramid_levels,
                         threshold=cfg.fast_threshold,
                         nms_radius=cfg.nms_radius, return_canvas=True)
    desc = describe_canvas(canvas, kps, cfg.pyramid_levels, cfg.image_width,
                           cfg.desc_bits)
    xy_und = undistort_pixels(cam.K, cam.d, cam.Kopt, kps.xy)
    xi = torch.clamp(kps.xy[:, 0].to(torch.int64), 0, cfg.image_width - 1)
    yi = torch.clamp(kps.xy[:, 1].to(torch.int64), 0, cfg.image_height - 1)
    color = (image[yi, xi] if image.dim() == 3
             else torch.stack([image[yi, xi]] * 3, dim=-1))
    return Frame(
        xy=xy_und, xy_dist=kps.xy, desc=desc, color=color,
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
               "lms": LandmarkStore, "guidance": GuidanceState}.get(f.name)
        out[f.name] = (_from_tree(sub, v, device) if sub is not None
                       else _to_torch(v, device))
    return cls(**out)


def frame_from_numpy(tree, device) -> Frame:
    """The JAX package's ``Frame`` (numpy leaves) -> this package's."""
    return _from_tree(Frame, tree, device)


def state_from_numpy(tree, device) -> SfMState:
    """The JAX package's ``SfMState`` after ``jax.device_get`` (numpy
    leaves; uint32 descriptors are reinterpreted as int32) -> this
    package's state on ``device``.  The JAX-only PRNG key is dropped."""
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
