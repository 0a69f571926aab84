"""Pipelined mapping: tracking goes on while the mapping pass for the latest
keyframe runs, and the two state timelines are reconciled by a pure merge
(the JAX package's ``parallel/pipeline.py``).

Why the merge is exact: between the snapshot S0 (the mapping input) and the
current tracked state Sk, tracking allocates and frees no store slot.  It
only (a) advances the reference frame, (b) adds links, view counts and
descriptor votes for existing landmarks, and (c) inserts whole keyframes.
The mapping output M reorganises the stores (new landmarks, culls, BA).
Within one pass, triangulation inserts slots before culling removes any,
so a slot valid in both S0 and M is the same landmark, and tracking's
per-landmark updates, all additive counters, replay onto M as deltas.
Keyframes inserted during the flight are copied into M's store (mapping
only culls keyframes, so their slots are still free there), with links to
landmarks that are no longer the same cleared.  The tracked pose needs no
correction: PnP refits it against the merged map on the next frame.

The mapping pass here is ``mapping_pass`` itself, as in the JAX package's
pipeline: unlike ``engine.step.run_pending_mapping`` it does not add the
new keyframe's descriptor votes and colours (the deferred tracking step
skips them), write the BA'd keyframe pose into ``prev`` or refresh
``last_kf_tracked``.

On the card the overlap comes from one worker thread that runs the mapping
pass on a CUDA stream of its own (PyTorch's current stream is per thread).
A dispatch records an event on the tracking stream, which the mapping
stream waits on before it reads S0; a join waits for the worker, makes the
tracking stream wait on the mapping stream, and merges on the tracking
stream.  The tensors that cross streams are marked with ``record_stream``,
so the caching allocator does not hand their memory out while the other
stream may still use it.  The join points depend only on frame counts, so
the result does not depend on the threads' timing.  With the mapping pass
on another device, S0 is copied there at the dispatch and M back at the
join.  On the CPU the same thread logic runs without streams."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import SfMConfig
from ..engine.mapping import mapping_pass
from ..engine.state import (CameraParams, SfMState, init_state,
                            resolve_device, scalar)
from ..engine.step import _fetch, step_frame
from ..mapstore import representative_descriptors, tree_map
from ..utils import PhaseTimer


def _delta(m, sk, s0, same):
    """Replay tracking's additive update (sk - s0) on top of M, on slots
    that stayed the same landmark."""
    mask = same.reshape(same.shape + (1,) * (m.dim() - 1))
    if m.dtype == torch.int8:  # saturating descriptor votes
        d = sk.to(torch.int16) - s0.to(torch.int16)
        wide = m.to(torch.int16) + torch.where(mask, d, torch.zeros_like(d))
        return torch.clamp(wide, -127, 127).to(torch.int8)
    return m + torch.where(mask, sk - s0, torch.zeros_like(m))


def merge_mapping_result(sk: SfMState, s0: SfMState, m: SfMState
                         ) -> SfMState:
    """Reconcile the tracked timeline Sk with the mapping output M
    (computed from the snapshot S0).  Pure."""
    same = s0.lms.valid & m.lms.valid          # stable landmark slots
    lms = m.lms.replace(**{
        name: _delta(getattr(m.lms, name), getattr(sk.lms, name),
                     getattr(s0.lms, name), same)
        for name in ("desc_votes", "color_sum", "n_desc", "n_views",
                     "kf_alive", "t_alive")})

    def keep_link(landmark):
        safe = torch.where(landmark >= 0, landmark, 0).to(torch.int64)
        return torch.where((landmark >= 0) & same[safe], landmark, -1)

    # keyframes inserted during the flight: Sk's rows copied into M's store
    # (mapping only culls, so those slots are free in M), stale links
    # cleared against M's culls
    new_kf = sk.kfs.valid & ~s0.kfs.valid
    frames = m.kfs.frames.map(
        lambda mf, sf: torch.where(
            new_kf.reshape((-1,) + (1,) * (mf.dim() - 1)), sf, mf),
        sk.kfs.frames)
    frames = frames.replace(landmark=torch.where(
        new_kf[:, None], keep_link(frames.landmark), frames.landmark))
    kfs = m.kfs.replace(frames=frames, valid=m.kfs.valid | new_kf)
    prev = sk.prev.replace(landmark=keep_link(sk.prev.landmark))
    return sk.replace(lms=lms, kfs=kfs, prev=prev,
                      rep_desc=representative_descriptors(lms))


def _record(tree, stream) -> None:
    """Mark every tensor of ``tree`` as in use on ``stream``."""
    tree_map(lambda t: t.record_stream(stream), tree)


class AsyncMappingEngine:
    """The pipelined engine on the host: tracking on ``track_device``,
    the mapping pass on ``map_device`` (both ``device`` by default; on one
    card, a second CUDA stream), merged after ``merge_lag`` tracked frames
    or at once when another keyframe is pending.

    ``step(image)`` tracks one frame ([H, W] grey or [H, W, 3] RGB) and
    returns its metrics as numpy values; ``flush()`` joins the pass in
    flight and maps what is still queued.  An exception raised by a
    mapping pass is raised again by the join that collects it.  ``timer``
    holds the host wall time of the phases: "tracking", "join_wait" and
    "merge" on the caller's thread, "mapping" (a whole pass, its device
    work included) on the worker's."""

    def __init__(self, cfg: SfMConfig, cam: CameraParams, track_device=None,
                 map_device=None, merge_lag: int = 2, device="cuda",
                 seed: int = 0):
        # full float32 matmuls, as in SfMEngine
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.d_track = resolve_device(
            device if track_device is None else track_device)
        self.d_map = resolve_device(
            self.d_track if map_device is None else map_device)
        self.cfg = cfg
        self.merge_lag = merge_lag

        def on(dev):
            return CameraParams(*(torch.as_tensor(t, dtype=torch.float32,
                                                  device=dev) for t in cam))
        self.cam, self._cam_map = on(self.d_track), on(self.d_map)
        self.generator = torch.Generator(device=self.d_track)
        self.generator.manual_seed(seed)
        self.state = init_state(cfg, self.d_track)
        self.timer = PhaseTimer()
        self._stream = (torch.cuda.Stream(self.d_map)
                        if self.d_map.type == "cuda" else None)
        self._worker = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sfm-mapping")
        self._inflight = None      # (future of M, S0 on the tracking device)
        self._since_dispatch = 0
        self._queue: list = []

    def step(self, image) -> dict:
        img = torch.as_tensor(image, dtype=torch.float32,
                              device=self.d_track)
        with self.timer.phase("tracking"):
            self.state, metrics = step_frame(
                self.cfg, self.cam, self.state, img, self.generator,
                defer_mapping=True)
            slot = int(self.state.pending_map_slot)   # host sync point
        if slot >= 0:
            self._queue.append(slot)
            self.state = self.state.replace(
                pending_map_slot=scalar(-1, self.d_track))

        if self._inflight is not None:
            self._since_dispatch += 1
            if self._since_dispatch >= self.merge_lag or self._queue:
                self._join()
        if self._inflight is None and self._queue:
            self._dispatch(self._queue.pop(0))
        return _fetch([metrics])[0]

    def _dispatch(self, slot: int) -> None:
        s0 = self.state
        s0_map = s0 if self.d_map == self.d_track else tree_map(
            lambda t: t.to(self.d_map), s0)
        ready = None
        if self._stream is not None:
            # S0 (after its copy, where there is one) is complete when the
            # mapping device's current stream reaches this event
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.d_map))
            _record(s0_map, self._stream)
        self._inflight = (self._worker.submit(self._map, s0_map, slot, ready),
                          s0)
        self._since_dispatch = 0

    def _map(self, s0: SfMState, slot: int, ready) -> SfMState:
        """The mapping pass, on the worker thread."""
        with self.timer.phase("mapping"):
            if self._stream is None:
                return mapping_pass(self.cfg, self._cam_map, s0, slot)
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(ready)
                m = mapping_pass(self.cfg, self._cam_map, s0, slot)
            self._stream.synchronize()
            return m

    def _join(self) -> None:
        future, s0 = self._inflight
        self._inflight = None
        with self.timer.phase("join_wait"):
            m = future.result()
        with self.timer.phase("merge"):
            if self.d_map != self.d_track:
                m = tree_map(lambda t: t.to(self.d_track), m)
                # the copies have read M before its memory can go back to
                # the mapping stream's pool
                for d in (self.d_map, self.d_track):
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
            elif self._stream is not None:
                track = torch.cuda.current_stream(self.d_track)
                track.wait_stream(self._stream)
                _record(m, track)
            self.state = merge_mapping_result(self.state, s0, m)

    def flush(self) -> None:
        """Join any mapping pass in flight, then map what is queued (call at
        the end of a scan)."""
        if self._inflight is not None:
            self._join()
        while self._queue:
            self._dispatch(self._queue.pop(0))
            self._join()

    @property
    def status(self) -> int:
        return int(self.state.status)
