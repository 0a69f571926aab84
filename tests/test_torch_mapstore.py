"""Landmark and keyframe store operations against the JAX package on the
same seeded stores: every op is integer or copy logic, so the results are
exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import rand_desc, to_np, to_t

from sfm_tpu import mapstore as jms
from sfm_tpu_torch import mapstore as ms

L, B, KF, N = 64, 512, 6, 24


def _lms(rng):
    valid = rng.uniform(0, 1, L) < 0.6
    return dict(
        xyz=rng.normal(0, 1, (L, 3)).astype(np.float32),
        desc_votes=rng.integers(-127, 128, (L, B)).astype(np.int8),
        color_sum=rng.uniform(0, 255, (L, 3)).astype(np.float32),
        n_desc=rng.integers(0, 5, L).astype(np.int32),
        n_views=rng.integers(0, 20, L).astype(np.int32),
        kf_alive=rng.integers(0, 6, L).astype(np.int32),
        t_alive=rng.integers(0, 40, L).astype(np.int32),
        valid=valid)


def _frames(rng, k):
    return dict(
        xy=rng.uniform(0, 300, (k, N, 2)).astype(np.float32),
        xy_dist=rng.uniform(0, 300, (k, N, 2)).astype(np.float32),
        desc=rand_desc(rng, k * N).reshape(k, N, 16),
        color=rng.uniform(0, 255, (k, N, 3)).astype(np.float32),
        level=rng.integers(0, 3, (k, N)).astype(np.int32),
        score=rng.uniform(0, 9, (k, N)).astype(np.float32),
        kp_valid=rng.uniform(0, 1, (k, N)) < 0.9,
        landmark=np.where(rng.uniform(0, 1, (k, N)) < 0.7,
                          rng.integers(0, L, (k, N)), -1).astype(np.int32),
        rvec=rng.normal(0, 0.1, (k, 3)).astype(np.float32),
        tvec=rng.normal(0, 0.1, (k, 3)).astype(np.float32),
        frame_no=rng.permutation(50)[:k].astype(np.int32))


def _both(cls_j, cls_t, d):
    return (cls_j(**{k: jnp.asarray(v) for k, v in d.items()}),
            cls_t(**{k: to_t(v) for k, v in d.items()}))


def _eq(ours, ref):
    if dataclasses.is_dataclass(ours):
        for f in dataclasses.fields(ours):
            _eq(getattr(ours, f.name), getattr(ref, f.name))
        return
    r = np.asarray(ref)
    np.testing.assert_array_equal(to_np(ours),
                                  r.view(np.int32) if r.dtype == np.uint32
                                  else r)


@pytest.fixture
def stores():
    rng = np.random.default_rng(0)
    lj, lt = _both(jms.LandmarkStore, ms.LandmarkStore, _lms(rng))
    fr = _frames(rng, KF)
    kvalid = np.array([1, 1, 0, 1, 1, 1], bool)
    kj = jms.KeyframeStore(_both(jms.Frame, ms.Frame, fr)[0],
                           jnp.asarray(kvalid))
    kt = ms.KeyframeStore(_both(jms.Frame, ms.Frame, fr)[1], to_t(kvalid))
    return rng, lj, lt, kj, kt


def test_allocate_slots():
    rng = np.random.default_rng(1)
    free = rng.uniform(0, 1, 40) < 0.3
    want = rng.uniform(0, 1, 30) < 0.6
    _eq(ms.allocate_slots(to_t(free), to_t(want)),
        jms.allocate_slots(jnp.asarray(free), jnp.asarray(want)))


def test_add_landmarks_and_descriptors(stores):
    rng, lj, lt, _, _ = stores
    M = 40
    xyz = rng.normal(0, 1, (M, 3)).astype(np.float32)
    desc = rand_desc(rng, M)
    want = rng.uniform(0, 1, M) < 0.7
    views = rng.integers(1, 4, M).astype(np.int32)
    cols = rng.uniform(0, 255, (M, 3)).astype(np.float32)
    lj2, idj = jms.add_landmarks(lj, jnp.asarray(xyz), jnp.asarray(desc),
                                 jnp.asarray(want), jnp.asarray(views),
                                 colors=jnp.asarray(cols))
    lt2, idt = ms.add_landmarks(lt, to_t(xyz), to_t(desc), to_t(want),
                                to_t(views), colors=to_t(cols))
    _eq(idt, idj)
    _eq(lt2, lj2)
    ids = np.where(rng.uniform(0, 1, M) < 0.8, rng.integers(0, L, M), -1)
    ids = ids.astype(np.int32)
    _eq(ms.add_descriptors(lt2, to_t(ids), to_t(desc), colors=to_t(cols)),
        jms.add_descriptors(lj2, jnp.asarray(ids), jnp.asarray(desc),
                            colors=jnp.asarray(cols)))
    _eq(ms.add_views(lt2, to_t(ids)), jms.add_views(lj2, jnp.asarray(ids)))
    _eq(ms.representative_descriptors(lt2),
        jms.representative_descriptors(lj2))
    _eq(ms.increment_age(lt2, 1, 1), jms.increment_age(lj2, 1, 1))
    np.testing.assert_allclose(to_np(ms.landmark_colors(lt2)),
                               np.asarray(jms.landmark_colors(lj2)),
                               rtol=1e-6)


def test_culling_and_links(stores):
    _, lj, lt, kj, kt = stores
    vj = jms.kf_view_counts(kj, L)
    vt = ms.kf_view_counts(kt, L)
    _eq(vt, vj)
    lj2, tj = jms.cull_landmarks(lj, vj, min_views=2)
    lt2, tt = ms.cull_landmarks(lt, vt, min_views=2)
    _eq(tt, tj)
    _eq(lt2, lj2)
    _eq(ms.clear_links(kt.frames.landmark, tt),
        jms.clear_links(kj.frames.landmark, tj))
    for red in (0.5, 0.9):
        kj2, cj = jms.cull_keyframes(kj, L, redundancy=red, min_others=1)
        kt2, ct = ms.cull_keyframes(kt, L, redundancy=red, min_others=1)
        _eq(ct, cj)
        _eq(kt2.valid, kj2.valid)


def test_insert_keyframe(stores):
    rng, _, _, kj, kt = stores
    one = {k: v[0] for k, v in _frames(rng, 1).items()}
    fj, ft = _both(jms.Frame, ms.Frame, one)
    kj2, sj = jms.insert_keyframe(kj, fj)
    kt2, st = ms.insert_keyframe(kt, ft)
    assert int(st) == int(sj) == 2
    _eq(kt2, kj2)
    # a full store: slot -1 and nothing changes
    full_j = kj2._replace(valid=jnp.ones(KF, bool))
    full_t = kt2.replace(valid=to_t(np.ones(KF, bool)))
    kj3, sj = jms.insert_keyframe(full_j, fj)
    kt3, st = ms.insert_keyframe(full_t, ft)
    assert int(st) == int(sj) == -1
    _eq(kt3, kj3)
