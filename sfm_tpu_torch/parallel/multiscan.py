"""The multi-scan fleet: many independent scans tracked in one batched
step.

Every leaf of the fleet's ``SfMState`` has a leading scan axis B.  The
tracking step of all RUNNING scans is one batched pass
(``engine.tracking.fleet_tracking_step``): one detection pass and one K5
call for the fleet's frames, and one K1 call each for the match against
the previous frames and for the widening, whatever B is.  Bootstrap,
relocalization and the mapping pass run scan by scan on the scans that
need them.

``MultiScanDriver`` follows the JAX package's bucketed driver
(``sfm_tpu/parallel/multiscan.py``) without its TPU workarounds: scans that
need a full step or a mapping pass run one by one, with no padded
buckets (``bucket`` is accepted and changes nothing), and there is no
map-all latch.  Each scan draws its RANSAC samples from its own
``torch.Generator``, seeded from (seed, scan), so a scan's results depend
only on its seed and its own frames."""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..config import SfMConfig
from ..engine.global_ba import run_global_ba
from ..engine.loop import LoopProbe, _host, _start_frame, build_loop_probe, \
    close_loop
from ..engine.mapping import mapping_pass
from ..engine.state import (RUNNING, CameraParams, SfMState, index_state,
                            init_batched_state, make_frames, resolve_device,
                            write_scan)
from ..engine.step import map_pending, step_frame
from ..engine.tracking import fleet_tracking_step
from ..mapstore import tree_map
from ..utils import PhaseTimer
from .hosts import axis_shard, rank_device

__all__ = ["MultiScanDriver", "build_batched_step", "build_sharded_step",
           "init_batched_state", "map_one", "scan_generator",
           "shard_batched_state"]


def scan_generator(seed: int, scan: int, device) -> torch.Generator:
    """Scan ``scan``'s generator of a fleet seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, scan]).generate_state(
        1)[0]))
    return g


def _on(cam: CameraParams, device) -> CameraParams:
    return CameraParams(*(torch.as_tensor(t, dtype=torch.float32,
                                          device=device) for t in cam))


def map_one(cfg: SfMConfig, cam: CameraParams, state: SfMState) -> SfMState:
    """The fleet's deferred mapping of one scan: the descriptor votes and
    colours of the pending keyframe's links, then the mapping pass; the
    slot is cleared.  Unlike the single-scan ``run_pending_mapping``, the
    optimised keyframe pose is not written back into ``prev`` and
    ``last_kf_tracked`` keeps its insertion-time count (as the JAX
    package's fleet does)."""
    return map_pending(cfg, cam, state)[0]


def build_batched_step(cfg: SfMConfig, cam: CameraParams, seed: int = 7,
                       first_scan: int = 0):
    """``(states [B, ...], images [B, H, W(, 3)]) -> (states, metrics)``:
    every scan takes its full step with inline mapping (the JAX package's
    ``vmap(build_step(cfg, cam))``).  RUNNING scans go through one batched
    ``fleet_tracking_step``, which maps each inserting scan on its own;
    the others through ``step_frame`` on their own slice.  The scans'
    generators are made on the first call, seeded from (seed, scan) with
    the fleet's scan index ``first_scan + b``: a block of a larger fleet
    draws what those scans draw in the whole fleet."""
    gens = []

    def step(states: SfMState, images: torch.Tensor):
        dev = states.status.device
        if not gens:
            gens.extend(scan_generator(seed, first_scan + b, dev)
                        for b in range(states.status.shape[0]))
        c = _on(cam, dev)
        imgs = images.to(device=dev, dtype=torch.float32)
        status = states.status.cpu()
        frames = make_frames(cfg, c, imgs, states.frame_count)
        states, m = fleet_tracking_step(
            cfg, c, states, frames, gens, images=imgs,
            mapping_fn=lambda st, slot: mapping_pass(cfg, c, st, slot))
        todo = torch.nonzero(status != RUNNING).flatten().tolist()
        if todo:
            states = tree_map(torch.clone, states)
        for b in todo:
            sub, mb = step_frame(cfg, c, index_state(states, b), imgs[b],
                                 gens[b])
            write_scan(states, b, sub)
            for k, v in mb.items():
                m[k][b] = v
        return states, m

    return step


def shard_batched_state(state, mesh, axis: str = "scan", device=None):
    """This rank's contiguous block of a batched state (or of any tree of
    tensors with the batch on the leading axis, such as the fleet's
    images) split over ``axis`` of ``mesh``, on this rank's device of the
    type of ``device`` or, by default, of each tensor's own device
    (``hosts.rank_device``): a block of a fleet on the card stays on the
    card, whatever backend the mesh's collectives use.  Raises when the
    batch does not divide by the axis size."""
    batch = (state.status if isinstance(state, SfMState) else state).shape[0]
    _, pos, n = axis_shard(mesh, axis)
    if batch % n:
        raise ValueError(f"a batch of {batch} scans does not split over the "
                         f"{n} ranks of axis {axis!r}")
    lo, size = pos * (batch // n), batch // n
    return tree_map(lambda x: x[lo:lo + size].to(
        rank_device(device or x.device.type)).clone(), state)


def build_sharded_step(cfg: SfMConfig, cam: CameraParams, mesh,
                       axis: str = "scan", seed: int = 7):
    """The batched step of this rank's block of a fleet split over
    ``axis``: ``(states [b, ...], images [b, ...]) -> (states, metrics)``
    on the blocks that ``shard_batched_state`` gives.  The scans are
    independent, so there is no collective; each scan's generator is
    seeded from its index in the whole fleet, so its stream does not
    depend on how the fleet is split."""
    inner = []

    def step(states: SfMState, images: torch.Tensor):
        if not inner:
            b = states.status.shape[0]
            pos = mesh.get_local_rank(axis)
            inner.append(build_batched_step(cfg, cam, seed,
                                            first_scan=pos * b))
        return inner[0](states, images)

    return step


class MultiScanDriver:
    """A fleet of ``batch`` scans on one device (the card by default;
    without one the default raises, and ``device="cpu"`` runs the plain
    versions).

    ``step(images [B, H, W(, 3)])`` and ``step_chunk(images [T, B, ...])``
    run the batched tracking step, then every scan that was not RUNNING
    before it through the full step (``step_frame``, deferred mapping) on
    the same frames, then the mapping pass of each scan with a pending
    keyframe (``map_one``).  The metrics returned are the batched tracking
    step's.  Frames may be staged as uint8: they are cast to float32 on
    the device at use.  ``probe_loops`` probes each scan's newest keyframe
    for a loop closure and closes the loops it finds.  ``timer`` (a
    ``PhaseTimer``) splits the host time into the tracking steps, the full
    steps, the mapping passes and the loop probes, each ended by a device
    synchronisation."""

    def __init__(self, cfg: SfMConfig, cam: CameraParams, batch: int,
                 bucket: int = 8, device="cuda", seed: int = 7):
        # full float32 matmuls, as SfMEngine sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.batch = batch
        self.bucket = bucket
        self.device = resolve_device(device)
        self.cam = _on(cam, self.device)
        self.generators = [scan_generator(seed, b, self.device)
                           for b in range(batch)]
        self.states = init_batched_state(cfg, batch, self.device)
        self.loop_closures = []     # (scan, frame_no, drift_m, n_inliers)
        self._corrected_spans = [[] for _ in range(batch)]
        self._probes = None         # one loop probe per scan, built lazily
        self.timer = PhaseTimer()

    @contextlib.contextmanager
    def _phase(self, name: str):
        with self.timer.phase(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def warmup(self, chunk_images) -> None:
        """Build the CUDA kernels, so that no timed chunk includes ``nvcc``
        (there is nothing to compile ahead otherwise).  ``chunk_images``,
        a representative chunk, is not stepped."""
        if self.device.type == "cuda":
            from .. import native
            native.library()

    def _frames(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(device=self.device,
                                          dtype=torch.float32)

    def _track(self, images: torch.Tensor):
        """The batched tracking step of the fleet on images [B, ...]."""
        frames = make_frames(self.cfg, self.cam, images,
                             self.states.frame_count)
        return fleet_tracking_step(self.cfg, self.cam, self.states, frames,
                                   self.generators, images=images)

    def _full_steps(self, status_before, images) -> None:
        """Every scan not RUNNING before the tracking steps, through the
        full step on each of the frames images [T, B, ...]."""
        todo = torch.nonzero(status_before != RUNNING).flatten().tolist()
        with self._phase("full steps"):
            for b in todo:
                sub = index_state(self.states, b)
                for img in images[:, b]:
                    sub, _ = step_frame(self.cfg, self.cam, sub,
                                        self._frames(img),
                                        self.generators[b],
                                        defer_mapping=True)
                write_scan(self.states, b, sub)

    def _dispatch_mapping(self) -> None:
        pending = self.states.pending_map_slot.cpu()
        with self._phase("mapping"):
            for b in torch.nonzero(pending >= 0).flatten().tolist():
                write_scan(self.states, b, map_one(
                    self.cfg, self.cam, index_state(self.states, b)))
            self.states.pending_map_slot.fill_(-1)

    def step(self, images) -> dict:
        """One frame of every scan: images [B, H, W] or [B, H, W, 3].
        Returns the batched tracking step's metrics ([B]-leading)."""
        return {k: v[0] for k, v in self.step_chunk(
            torch.as_tensor(images)[None]).items()}

    def step_chunk(self, images) -> dict:
        """T frames of every scan: images [T, B, H, W(, 3)], T at most
        ``keyframe_time_lag`` (a scan inserts at most one keyframe per
        chunk, and its pending slot holds one).  The status is read once,
        at the start; a scan that was not RUNNING then takes the full step
        on all T frames afterwards.  A scan that goes LOST within the chunk
        skips the rest of it (its frames are dropped and its frame count
        does not advance) and relocalizes from the next chunk on.  Returns
        the tracking steps' metrics with [T, B]-leading fields."""
        images = torch.as_tensor(images)
        T = images.shape[0]
        if T > self.cfg.keyframe_time_lag:
            raise ValueError(f"a chunk of {T} frames is longer than "
                             f"keyframe_time_lag={self.cfg.keyframe_time_lag}"
                             ": a scan could insert two keyframes")
        status_before = self.states.status.cpu()
        ms = []
        with self._phase("tracking"):
            for t in range(T):
                self.states, m = self._track(self._frames(images[t]))
                ms.append(m)
        self._full_steps(status_before, images)
        self._dispatch_mapping()
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def probe_loops(self, probes: Optional[LoopProbe] = None,
                    slots=None) -> list:
        """Probe each RUNNING scan's newest keyframe (with at least two
        keyframes) for a loop closure, scan by scan; close each loop found
        (``close_loop`` with the scan's own closed spans, then global BA
        twice) and write the scan back.  ``probes`` (a LoopProbe with
        [B]-leading fields) and ``slots`` [B] may be injected.  Returns the
        (scan, frame_no, drift_m, n_inliers) closed by this call (also
        appended to ``loop_closures``)."""
        cfg, cam = self.cfg, self.cam
        with self._phase("loop probes"):
            if probes is None:
                probes, slots = self._probe_all()
            else:
                probes = LoopProbe(*map(_host, probes))
                slots = _host(slots)
        closed = []
        for i in np.nonzero(probes.ok)[0].tolist():
            with self._phase("loop closures"):
                sub = index_state(self.states, i)
                probe_i = LoopProbe(*(x[i] for x in probes))
                slot_i = int(slots[i])
                fns_i = sub.kfs.frames.frame_no.cpu().numpy()
                valid_i = sub.kfs.valid.cpu().numpy()
                span = (_start_frame(fns_i, valid_i, probe_i),
                        int(fns_i[slot_i]))
                sub = close_loop(cfg, cam, sub, slot_i, probe_i,
                                 corrected_spans=self._corrected_spans[i])
                self._corrected_spans[i].append(span)
                for _ in range(2):
                    sub, _stats = run_global_ba(cfg, cam, sub)
                write_scan(self.states, i, sub)
                entry = (i, int(sub.kfs.frames.frame_no[slot_i]),
                         float(probe_i.drift), int(probe_i.n_inliers))
            closed.append(entry)
            self.loop_closures.append(entry)
        return closed

    def _probe_all(self):
        """(LoopProbe of numpy [B]-leading fields, slots [B]): the newest
        keyframe of each RUNNING scan with >= 2 keyframes probed; ``ok`` is
        False for the other scans, which are not probed."""
        if self._probes is None:
            self._probes = [build_loop_probe(self.cfg, self.cam, g)
                            for g in self.generators]
        status = self.states.status.cpu().numpy()
        valid = self.states.kfs.valid.cpu().numpy()
        fns = self.states.kfs.frames.frame_no.cpu().numpy()
        slots = np.argmax(np.where(valid, fns, -1), axis=1)
        none = LoopProbe(
            ok=np.asarray(False), rvec=np.zeros(3, np.float32),
            tvec=np.zeros(3, np.float32), n_inliers=np.asarray(0, np.int32),
            drift=np.asarray(0.0, np.float32),
            links=np.full(self.cfg.max_keypoints, -1, np.int32),
            min_lm_birth=np.asarray(0, np.int32),
            scale=np.asarray(1.0, np.float32), scale_ok=np.asarray(False),
            n_pairs=np.asarray(0, np.int32))
        out = []
        for b in range(self.batch):
            if status[b] != RUNNING or valid[b].sum() < 2:
                out.append(none)
                continue
            out.append(LoopProbe(*map(_host, self._probes[b](
                index_state(self.states, b), int(slots[b])))))
        return LoopProbe(*(np.stack(f) for f in zip(*out))), slots
