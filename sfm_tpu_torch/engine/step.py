"""The per-frame step and the host-facing ``SfMEngine``.

``step_frame`` dispatches on the 3-state machine NOT_INITIALIZED / RUNNING /
LOST with a host branch on ``status`` (one small device-to-host read per
frame), keeps the flow reference image in lockstep with the reference
frame, and runs scan guidance on RGB frames that end RUNNING.
``SfMEngine`` mirrors the JAX package's driver: ``add_frame`` (inline
mapping), ``add_frames`` (a chunk of frames with deferred mapping: the
mapping pass runs once after the chunk), a loop-closure probe every
``loop_detect_every`` keyframe insertions (and ``probe_loop_closure`` on
demand), periodic global BA every ``global_ba_every`` keyframe
insertions (and ``global_ba`` on demand), ``get_reconstruction``,
``get_trajectory``, and ``save`` / ``load`` (checkpoints in the JAX
package's layout)."""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SfMConfig
from ..geometry.camera import optimal_new_camera_matrix
from ..guidance import update_guidance
from ..mapstore import add_descriptors, landmark_colors
from .bootstrap import bootstrap_step
from .global_ba import run_global_ba
from .loop import LoopProbe, _host, _start_frame, build_loop_probe, close_loop
from .mapping import mapping_pass
from .reloc import reloc_step
from .state import (NOT_INITIALIZED, RUNNING, CameraParams, SfMState,
                    init_state, make_frame, resolve_device, scalar,
                    to_gray)
from .tracking import tracking_step

def step_frame(cfg: SfMConfig, cam: CameraParams, state: SfMState,
               image: torch.Tensor, generator: Optional[torch.Generator],
               defer_mapping: bool = False) -> Tuple[SfMState, dict]:
    """One frame: (state, image [H, W] grey or [H, W, 3] RGB) -> (state,
    metrics)."""
    frame = make_frame(cfg, cam, image, state.frame_count)
    grey = to_gray(image)
    status = int(state.status)
    if status == NOT_INITIALIZED:
        state, m = bootstrap_step(cfg, cam, state, frame, generator)
    elif status == RUNNING:
        mapping_fn = None if defer_mapping else (
            lambda st, slot: mapping_pass(cfg, cam, st, slot))
        state, m = tracking_step(cfg, cam, state, frame, mapping_fn,
                                 generator, image=grey)
    else:
        state, m = reloc_step(cfg, cam, state, frame, generator)
    if cfg.track_with_flow:
        # the branch adopted this frame as ``prev`` iff the frame numbers
        # match (bootstrap reference advance, tracking swap, recovery)
        took = state.prev.frame_no == frame.frame_no
        state = state.replace(
            prev_image=torch.where(took, grey, state.prev_image))
    if image.dim() == 3 and cfg.guidance_enabled and \
            int(state.status) == RUNNING:
        gs, out = update_guidance(cfg, state.guidance, image,
                                  state.lms.xyz, state.lms.valid, cam.Kopt,
                                  state.prev.rvec, state.prev.tvec)
        state = state.replace(guidance=gs)
        m.update(guid_centroid=out.centroid, guid_bbox_center=out.bbox_center,
                 guid_bbox_axes=out.bbox_axes,
                 guid_bbox_extent=out.bbox_extent)
    return state.replace(frame_count=state.frame_count + 1), m


def run_pending_mapping(cfg: SfMConfig, cam: CameraParams,
                        state: SfMState) -> SfMState:
    """The deferred mapping pass: runs on ``pending_map_slot`` (a no-op
    when none is pending) and clears it."""
    slot = int(state.pending_map_slot)
    state = state.replace(pending_map_slot=scalar(-1, state.status.device))
    if slot < 0:
        return state
    # the descriptor votes and colours of the new keyframe's links (the
    # inline path stacks them at insertion)
    fr = state.kfs.frames
    ids = torch.where(fr.kp_valid[slot], fr.landmark[slot], -1)
    state = state.replace(lms=add_descriptors(
        state.lms, ids, fr.desc[slot], colors=fr.color[slot]))
    st = mapping_pass(cfg, cam, state, slot)
    # the BA-optimised keyframe pose goes back into the reference frame
    # when it is that keyframe
    fr = st.kfs.frames
    match = st.kfs.valid[slot] & (fr.frame_no[slot] == st.prev.frame_no)
    prev = st.prev.replace(
        rvec=torch.where(match, fr.rvec[slot], st.prev.rvec),
        tvec=torch.where(match, fr.tvec[slot], st.prev.tvec))
    kf_links = (fr.kp_valid[slot] & (fr.landmark[slot] >= 0)).sum()
    return st.replace(prev=prev, last_kf_tracked=kf_links.to(torch.int32))


def _fetch(ms: list) -> list:
    """Per-frame metric dicts of tensors -> dicts of numpy values, one
    device-to-host copy per field for the whole list."""
    if not ms:
        return []
    stacked = {k: torch.stack([m[k] for m in ms]).cpu().numpy()
               for k in ms[0]}
    return [{k: v[i] for k, v in stacked.items()} for i in range(len(ms))]


class SfMEngine:
    """Host-side engine.  ``device`` picks where every tensor lives: the
    card by default, where the matcher, the patch sampler and the large
    solver's BA kernels run as CUDA kernels; without a card the default
    raises, and ``device="cpu"`` runs the plain versions."""

    def __init__(self, K, image_size, dist=None,
                 config: Optional[SfMConfig] = None, device="cuda",
                 seed: int = 0):
        # full float32 matmuls and convolutions (TF32 keeps ~3 digits and
        # stalls bootstrap the way bf16 rounding did on the TPU)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = config or SfMConfig()
        if tuple(image_size) != cfg.image_size:
            cfg = SfMConfig(**{**cfg.__dict__, "image_height": image_size[0],
                               "image_width": image_size[1]})
        self.config = cfg
        self.device = resolve_device(device)
        K = np.asarray(K, np.float32)
        d = np.zeros(5, np.float32)
        if dist is not None:
            d[:len(dist)] = np.asarray(dist, np.float32)
        Kopt = optimal_new_camera_matrix(K, d, cfg.image_size) \
            if np.any(d != 0) else K
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.cam = CameraParams(K=as_t(K), d=as_t(d), Kopt=as_t(Kopt))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = init_state(cfg, self.device)
        self.metrics_log = []
        self._kfs_since_global_ba = 0
        self._loop_probe = None     # built on the first probe
        self._kfs_since_loop_probe = 0
        self.loop_closures = []     # (frame_no, drift_m, n_inliers)
        self._corrected_spans = []  # closed (start_fn, loop_fn) spans

    def _maybe_global_ba(self, n_new_keyframes: int) -> None:
        """After a frame or chunk: the loop probe's schedule first, then
        periodic global BA once ``global_ba_every`` keyframes were inserted
        since the last call."""
        self._maybe_loop_probe(n_new_keyframes)
        if self.config.global_ba_every <= 0:
            return
        self._kfs_since_global_ba += n_new_keyframes
        if self._kfs_since_global_ba >= self.config.global_ba_every:
            self.global_ba()

    def _maybe_loop_probe(self, n_new_keyframes: int) -> None:
        if self.config.loop_detect_every <= 0:
            return
        self._kfs_since_loop_probe += n_new_keyframes
        if self._kfs_since_loop_probe >= self.config.loop_detect_every:
            self._kfs_since_loop_probe = 0
            self.probe_loop_closure()

    def probe_loop_closure(self) -> bool:
        """Probe the newest keyframe for a loop against old landmarks; on
        a detection, close the loop (engine/loop.py) and run global BA
        twice.  Returns True when a loop was closed."""
        if self._loop_probe is None:
            self._loop_probe = build_loop_probe(self.config, self.cam,
                                                self.generator)
        kfs = self.state.kfs
        valid = kfs.valid.cpu().numpy()
        if valid.sum() < 2:
            return False
        fns = kfs.frames.frame_no.cpu().numpy()
        slot = int(np.argmax(np.where(valid, fns, -1)))
        probe = LoopProbe(*map(_host, self._loop_probe(self.state, slot)))
        if not bool(probe.ok):
            return False
        # each closure's span starts at its matched-landmark era; the
        # scale is first-contact only (close_loop)
        span = (_start_frame(fns, valid, probe), int(fns[slot]))
        self.state = close_loop(self.config, self.cam, self.state, slot,
                                probe, corrected_spans=self._corrected_spans)
        self._corrected_spans.append(span)
        for _ in range(2):
            self.global_ba()
        self.loop_closures.append((int(fns[slot]), float(probe.drift),
                                   int(probe.n_inliers)))
        print(f"loop closure @ frame {int(fns[slot])}: drift "
              f"{float(probe.drift):.2f} m, {int(probe.n_inliers)} inliers, "
              f"scale {float(probe.scale):.3f} (ok={bool(probe.scale_ok)}, "
              f"{int(probe.n_pairs)} pairs)", file=sys.stderr)
        return True

    def global_ba(self) -> dict:
        """Run global BA on the current map now; returns its stats
        (initial_cost, final_cost, lam, accepted, dropped_obs) as numpy
        values."""
        self.state, stats = run_global_ba(self.config, self.cam, self.state)
        self._kfs_since_global_ba = 0
        return {k: v.cpu().numpy() for k, v in stats._asdict().items()}

    def _images(self, images, batched: bool) -> torch.Tensor:
        """Frames as float32 on the device: RGB stays RGB when guidance is
        on (real landmark colours, guidance in the step) and becomes luma
        otherwise."""
        if not torch.is_tensor(images):
            images = np.asarray(images, np.float32)
        imgs = torch.as_tensor(images, dtype=torch.float32,
                               device=self.device)
        if imgs.dim() == (4 if batched else 3) and \
                not self.config.guidance_enabled:
            imgs = (0.299 * imgs[..., 0] + 0.587 * imgs[..., 1]
                    + 0.114 * imgs[..., 2])
        return imgs

    def add_frame(self, image) -> dict:
        """Process one frame (mapping runs inline on a keyframe).  image:
        [H, W] grey or [H, W, 3] RGB, uint8 or float."""
        self.state, m = step_frame(self.config, self.cam, self.state,
                                   self._images(image, False), self.generator)
        out = _fetch([m])[0]
        self.metrics_log.append(out)
        self._maybe_global_ba(int(out["keyframe_added"]))
        return out

    def add_frames(self, images) -> list:
        """Process a chunk of frames [T, H, W] or [T, H, W, 3].  Chunks no
        longer than ``keyframe_time_lag`` defer mapping to one pass after
        the chunk (at most one keyframe can be pending); longer chunks map
        inline."""
        imgs = self._images(images, True)
        deferred = imgs.shape[0] <= self.config.keyframe_time_lag
        ms = []
        for img in imgs:
            self.state, m = step_frame(self.config, self.cam, self.state, img,
                                       self.generator, defer_mapping=deferred)
            ms.append(m)
        if deferred:
            self.state = run_pending_mapping(self.config, self.cam,
                                             self.state)
        out = _fetch(ms)
        self.metrics_log.extend(out)
        self._maybe_global_ba(sum(int(m["keyframe_added"]) for m in out))
        return out

    def get_reconstruction(self) -> Tuple[np.ndarray, np.ndarray]:
        """Live landmark positions [M, 3] and mean observed colours
        [M, 3] uint8."""
        lms = self.state.lms
        valid = lms.valid.cpu().numpy()
        pts = lms.xyz.cpu().numpy()[valid]
        cols = np.clip(landmark_colors(lms).cpu().numpy()[valid], 0, 255)
        return pts, cols.astype(np.uint8)

    def get_trajectory(self) -> np.ndarray:
        """Keyframe poses [n, 6] (rvec, tvec) sorted by frame number."""
        kfs = self.state.kfs
        valid = kfs.valid.cpu().numpy()
        fn = kfs.frames.frame_no.cpu().numpy()[valid]
        rv = kfs.frames.rvec.cpu().numpy()[valid]
        tv = kfs.frames.tvec.cpu().numpy()[valid]
        order = np.argsort(fn)
        return np.concatenate([rv[order], tv[order]], axis=1)

    def save(self, path: str) -> None:
        """Checkpoint the whole engine state (the JAX package's npz
        layout: either package resumes from it)."""
        from ..io.checkpoint import save_state
        save_state(path, self.state)

    def load(self, path: str) -> None:
        """Resume from a checkpoint written with the same SfMConfig."""
        from ..io.checkpoint import load_state
        self.state = load_state(path, self.config, self.device)

    def keyframe_numbers(self) -> np.ndarray:
        """Frame numbers of the valid keyframes, sorted."""
        kfs = self.state.kfs
        return np.sort(kfs.frames.frame_no.cpu().numpy()[
            kfs.valid.cpu().numpy()])

    @property
    def status(self) -> int:
        return int(self.state.status)
