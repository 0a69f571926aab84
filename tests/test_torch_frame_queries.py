"""The port's frame and map queries (frame_queries.py) against the JAX
package's, on frames and stores carried across with numpy (the cases of
tests/test_frame_queries.py, and random ones)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rand_desc, to_np, to_t

from sfm_tpu import frame_queries as jq
from sfm_tpu.mapstore import (empty_frame, empty_keyframes, empty_landmarks,
                              insert_keyframe)
from sfm_tpu_torch import frame_queries as tq
from sfm_tpu_torch.engine.state import _from_tree, frame_from_numpy
from sfm_tpu_torch.mapstore import KeyframeStore, LandmarkStore

N, W, L = 16, 16, 24


def mk_frame(rng, links=((2, 5), (4, 7))):
    """tests/test_frame_queries.py's frame, with random descriptors."""
    f = empty_frame(N, W)
    landmark = np.full((N,), -1, np.int32)
    for k, lm in links:
        landmark[k] = lm
    return f._replace(
        xy=jnp.asarray(rng.uniform(0, 100, (N, 2)).astype(np.float32)),
        xy_dist=jnp.asarray(rng.uniform(0, 100, (N, 2)).astype(np.float32)),
        desc=jnp.asarray(rand_desc(rng, N, W)),
        kp_valid=jnp.asarray(np.arange(N) < 10),
        landmark=jnp.asarray(landmark),
        frame_no=jnp.asarray(0, jnp.int32))


def _same(ours, ref):
    if isinstance(ours, tuple):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _same(a, b)
        return
    a, b = to_np(ours), np.asarray(ref)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_queries_equal_jax(seed):
    rng = np.random.default_rng(seed)
    links = [(int(k), int(rng.integers(0, L)))
             for k in rng.choice(N, 6, replace=False)]
    fj = mk_frame(rng, links)
    ft = frame_from_numpy(jax.device_get(fj), "cpu")
    for name in ("matched_mask", "unmatched_mask", "matched_points",
                 "unmatched_points"):
        _same(getattr(tq, name)(ft), getattr(jq, name)(fj))
    idx = np.array([3, 1, 2, -4, N + 5, N - 1], np.int32)
    for name in ("points_at", "descriptors_at"):
        _same(getattr(tq, name)(ft, to_t(idx)),
              getattr(jq, name)(fj, jnp.asarray(idx)))
    for k in range(N):
        for distorted in (True, False):
            pts = np.asarray(fj.xy_dist if distorted else fj.xy)
            for off, md in ((0.3, 1.0), (0.8, 1.0), (2.0, 3.0), (5.0, 1.0)):
                q = (pts[k] + off).astype(np.float32)
                _same(tq.nearest_point_index(ft, to_t(q), max_dist=md,
                                             distorted=distorted),
                      jq.nearest_point_index(fj, jnp.asarray(q),
                                             max_dist=md,
                                             distorted=distorted))
    far = np.array([1e5, 1e5], np.float32)
    assert int(tq.nearest_point_index(ft, to_t(far))) == -1
    assert int(tq.nearest_point_index(ft, ft.xy_dist[3] + 0.3)) == 3


def test_map_queries_equal_jax():
    rng = np.random.default_rng(5)
    kfs = empty_keyframes(4, N, W)
    kfs, s0 = insert_keyframe(kfs, mk_frame(rng))
    kfs, s1 = insert_keyframe(kfs, mk_frame(rng, [(1, 9), (5, L - 1)]))
    kfs, s2 = insert_keyframe(kfs, mk_frame(rng, [(3, 11), (12, 13)]))
    # a culled keyframe's links count for nothing
    kfs = kfs._replace(valid=kfs.valid.at[s2].set(False))
    kt = _from_tree(KeyframeStore, jax.device_get(kfs), "cpu")
    s0, s1, s2 = int(s0), int(s1), int(s2)
    for slot in (s0, s1, s2, 3):
        a = tq.landmarks_in_keyframe(kt, slot, L)
        _same(a, jq.landmarks_in_keyframe(kfs, slot, L))
    u = tq.landmarks_in_keyframes(kt, L)
    _same(u, jq.landmarks_in_keyframes(kfs, L))
    # tests/test_frame_queries.py's expectations
    a = to_np(tq.landmarks_in_keyframe(kt, s0, L))
    assert a[5] and a[7] and a.sum() == 2
    assert to_np(u)[[5, 7, 9, L - 1]].all() and to_np(u).sum() == 4
    lms = empty_landmarks(L, 512)
    lms = lms._replace(
        xyz=jnp.asarray(rng.normal(size=(L, 3)).astype(np.float32)),
        valid=jnp.asarray(rng.uniform(size=L) < 0.5))
    lt = _from_tree(LandmarkStore, jax.device_get(lms), "cpu")
    _same(tq.live_landmarks(lt), jq.live_landmarks(lms))
    assert torch.equal(tq.live_landmarks(lt)[1], lt.valid)
