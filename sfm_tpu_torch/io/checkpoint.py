"""Checkpoint / resume in the JAX package's npz layout.

A checkpoint is ``n`` (the leaf count) plus ``leaf_i`` for every leaf of
the JAX package's ``SfMState`` in ``jax.tree.flatten`` order: the state's
fields in order, depth first through ``Frame``, ``KeyframeStore``,
``LandmarkStore`` and ``GuidanceState``, with descriptors as uint32.  The
port's dataclasses list their fields in the JAX order; ``JAX_STATE_FIELDS``
spells out the top level, where the JAX-only PRNG key sits.  The port
writes the key as ``jax.random.PRNGKey(0)`` holds it and ignores it on
load, so a checkpoint resumes in either package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SfMConfig
from ..engine.state import SfMState, init_state, resolve_device

JAX_STATE_FIELDS = (
    "status", "prev", "kfs", "lms", "frame_count", "last_kf_frame_no",
    "last_kf_tracked", "lost_count", "init_fail_count", "key", "rep_desc",
    "pending_map_slot", "prev_image", "guidance", "ba_dropped_obs")
# jax.random.PRNGKey(0) (threefry): two zero words
_KEY = np.zeros(2, np.uint32)
# int32 leaves that the JAX package stores as uint32 descriptor words
_UINT32 = {("prev", "desc"), ("kfs", "frames", "desc"), ("rep_desc",)}


def _leaves(obj, path=()):
    """(path, tensor) pairs of a dataclass tree, fields in order, depth
    first."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), path + (f.name,))
    else:
        yield path, obj


def _state_leaves(state: SfMState):
    for name in JAX_STATE_FIELDS:
        if name == "key":
            yield (name,), None
        else:
            yield from _leaves(getattr(state, name), (name,))


def save_state(path: str, state: SfMState) -> None:
    arrays = []
    for p, t in _state_leaves(state):
        if t is None:
            arrays.append(_KEY)
            continue
        a = t.detach().cpu().numpy()
        arrays.append(a.view(np.uint32) if p in _UINT32 else a)
    np.savez_compressed(path, n=len(arrays),
                        **{f"leaf_{i}": a for i, a in enumerate(arrays)})


def _rebuild(proto, loaded, path=()):
    if dataclasses.is_dataclass(proto):
        return type(proto)(**{
            f.name: _rebuild(getattr(proto, f.name), loaded, path + (f.name,))
            for f in dataclasses.fields(proto)})
    return loaded[path]


def load_state(path: str, cfg: SfMConfig, device="cuda") -> SfMState:
    """The state a checkpoint holds, on ``device`` (the card by default;
    raises without one).  Raises ValueError when its leaf count or a
    leaf's shape differs from what ``cfg`` gives."""
    device = resolve_device(device)
    proto = init_state(cfg, device)
    leaves = list(_state_leaves(proto))
    z = np.load(path)
    n = int(z["n"])
    if n != len(leaves):
        raise ValueError(
            f"checkpoint has {n} leaves, config expects {len(leaves)} — "
            "was it saved with a different SfMConfig?")
    loaded = {}
    for i, (p, ref) in enumerate(leaves):
        arr = z[f"leaf_{i}"]
        ref_shape = _KEY.shape if ref is None else tuple(ref.shape)
        if arr.shape != ref_shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != config shape "
                f"{ref_shape} — static capacities must match")
        if ref is not None:
            a = arr.view(np.int32) if arr.dtype == np.uint32 else arr
            loaded[p] = torch.from_numpy(np.array(a)).to(device, ref.dtype)
    return _rebuild(proto, loaded)
