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
                        empty_frame, empty_keyframes, empty_landmarks,
                        tree_map)
from ..utils.profiling import count

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
    count("implicit_sync")  # a blocking copy to the card
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


def init_batched_state(cfg: SfMConfig, batch: int, device) -> SfMState:
    """A fleet of ``batch`` fresh states: every leaf with a leading scan
    axis."""
    return tree_map(lambda x: x.expand((batch,) + x.shape).clone(),
                    init_state(cfg, device))


def stack_states(states) -> SfMState:
    """Single-scan states -> one state with a leading scan axis."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def index_state(states: SfMState, b: int) -> SfMState:
    """Scan ``b`` of a fleet state (views of its leaves)."""
    return tree_map(lambda x: x[b], states)


def write_scan(states: SfMState, b: int, sub: SfMState) -> SfMState:
    """Write a single-scan state into row ``b`` of a fleet state, in place
    (the fleet's state is large; its other rows are not touched).  Returns
    ``states``."""
    def put(full, new):
        full[b] = new
        return full
    return tree_map(put, states, sub)


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
    in the JAX package).  A fleet's frame (leaves [B, N, ...]) gives every
    field a leading B."""
    dev = frame.kp_valid.device
    lead = tuple(frame.kp_valid.shape[:-1])
    kw.setdefault("n_detected", frame.kp_valid.sum(-1))
    m = {}
    for name, dtype, shape in METRIC_FIELDS:
        v = kw.pop(name, None)
        full = lead + shape
        if v is not None and not torch.is_tensor(v):
            count("implicit_sync")  # a blocking copy to the card
        m[name] = (torch.zeros(full, dtype=dtype, device=dev) if v is None
                   else torch.as_tensor(v, device=dev).to(dtype)
                   .expand(full).clone())
    if kw:
        raise KeyError(f"not a metric: {sorted(kw)}")
    return m


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [...] luma."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def to_gray(image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] RGB -> [H, W] luma; [H, W] grey passes through."""
    return luma(image) if image.dim() == 3 else image


def make_frames(cfg: SfMConfig, cam: CameraParams, images: torch.Tensor,
                frame_no: torch.Tensor) -> Frame:
    """``make_frame`` for a fleet: images [B, H, W] grey or [B, H, W, 3]
    RGB, frame_no [B]; one detection pass and one K5 call for the batch.
    Every leaf of the Frame has a leading B, and scan b's equals
    ``make_frame`` of its image alone."""
    rgb = images.dim() == 4
    grey = luma(images) if rgb else images
    kps, canvas = detect(grey, max_keypoints=cfg.max_keypoints,
                         levels=cfg.pyramid_levels,
                         threshold=cfg.fast_threshold,
                         nms_radius=cfg.nms_radius, return_canvas=True)
    desc = describe_canvas(canvas, kps, cfg.pyramid_levels, cfg.image_width,
                           cfg.desc_bits)
    xy_und = undistort_pixels(cam.K, cam.d, cam.Kopt, kps.xy)
    xi = torch.clamp(kps.xy[..., 0].to(torch.int64), 0, cfg.image_width - 1)
    yi = torch.clamp(kps.xy[..., 1].to(torch.int64), 0, cfg.image_height - 1)
    B, W = images.shape[0], cfg.image_width
    flat = (yi * W + xi).reshape(B, -1)
    if rgb:
        color = torch.gather(images.reshape(B, -1, 3), 1,
                             flat[..., None].expand(-1, -1, 3))
    else:
        color = torch.gather(images.reshape(B, -1), 1, flat)[..., None] \
            .expand(-1, -1, 3).clone()
    dev = images.device
    return Frame(
        xy=xy_und, xy_dist=kps.xy, desc=desc, color=color,
        level=kps.level, score=kps.score, kp_valid=kps.valid,
        landmark=torch.full((B, cfg.max_keypoints), -1, dtype=torch.int32,
                            device=dev),
        rvec=torch.zeros((B, 3), device=dev),
        tvec=torch.zeros((B, 3), device=dev),
        frame_no=frame_no.to(torch.int32).clone())


def make_frame(cfg: SfMConfig, cam: CameraParams, image: torch.Tensor,
               frame_no: torch.Tensor) -> Frame:
    """Detect, describe, and undistort every keypoint into the Kopt model.
    ``image`` is [H, W] grey or [H, W, 3] RGB, float32 on the engine's
    device: detection runs on its luma, and the keypoint colours are sampled
    from the RGB image (grey replicated otherwise).  The fleet's
    ``make_frames`` for a batch of one."""
    return make_frames(cfg, cam, image[None], frame_no[None]).map(
        lambda x: x[0])


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


def nonfinite_fields(tree, prefix: str = "") -> dict:
    """{path: (NaN, +inf, -inf counts)} of every floating leaf of ``tree``
    that holds a non-finite entry, every entry counted (invalid slots and
    padding too).  ``tree``: nested state dataclasses, dicts, lists or
    tuples of tensors, numpy arrays or numbers (a state, a metrics dict).
    One host read per device."""
    leaves = []
    _floating_leaves(tree, prefix, leaves)
    by_dev = {}
    for path, t in leaves:
        by_dev.setdefault(t.device, []).append((path, t))
    out = {}
    for items in by_dev.values():
        counts = torch.stack([torch.stack([
            torch.isnan(t).sum(), torch.isposinf(t).sum(),
            torch.isneginf(t).sum()]) for _, t in items]).tolist()
        out.update((path, tuple(c)) for (path, _), c in zip(items, counts)
                   if any(c))
    return out


def _floating_leaves(obj, path, out):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _floating_leaves(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _floating_leaves(v, f"{path}.{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _floating_leaves(v, f"{path}[{i}]", out)
    elif isinstance(obj, (torch.Tensor, np.ndarray, float, np.floating)):
        t = torch.as_tensor(obj)
        if t.is_floating_point():
            out.append((path.lstrip("."), t))


def state_to_numpy(state: SfMState) -> dict:
    """Nested dict of numpy arrays with the JAX package's field names and
    dtypes (descriptors as uint32)."""
    out = _to_numpy(state)
    out["prev"]["desc"] = out["prev"]["desc"].view(np.uint32)
    out["kfs"]["frames"]["desc"] = out["kfs"]["frames"]["desc"].view(np.uint32)
    out["rep_desc"] = out["rep_desc"].view(np.uint32)
    return out
