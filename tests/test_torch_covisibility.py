"""The port's twin of tests/test_covisibility.py: the mapping window with
``mapping_use_covisibility`` on (the most covisible keyframes) and off
(the recency window, ``_recent_valid_slots``).

(a) The port's two scans of the fast-return loop, on the CPU, held to
    test_covisibility.py's three assertions.
(b) ``_window_slots`` (re-observation) and ``_hybrid_slots``
    (triangulation), under both settings, against the JAX package's on
    the JAX scan's keyframe table after the same frames, carried across
    by ``state_from_numpy``: the same slots and flags, for every valid
    keyframe as the new one and the mapping pass's window sizes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from render import SpriteScene
from test_covisibility import (K, _cfg, _cross_loop_counts, fastloop_traj)
from torch_port_util import to_np

from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine import mapping as jmapping
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import RUNNING, SfMEngine, state_from_numpy
from sfm_tpu_torch.engine import mapping


def _frames():
    scene = SpriteScene(np.random.default_rng(11), n_sprites=90)
    rv, tv = fastloop_traj()
    return [scene.render(K, rv[i], tv[i], 120, 160) for i in range(len(rv))]


def _port_cfg(covis: bool) -> SfMConfig:
    return SfMConfig(**dataclasses.asdict(_cfg(covis)))


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def jax_state(frames):
    eng = JaxEngine(K, (120, 160), None, _cfg(True))
    for f in frames:
        eng.add_frame(f)
    return jax.device_get(eng.state)


def _port_scan(frames, covis: bool) -> SfMEngine:
    eng = SfMEngine(K, (120, 160), None, _port_cfg(covis), device="cpu")
    for f in frames:
        eng.add_frame(f)
    return eng


def test_port_covisibility_reconnects_loop(frames):
    eng_cov = _port_scan(frames, covis=True)
    assert eng_cov.status == RUNNING
    all_cov, young_cov = _cross_loop_counts(eng_cov)
    eng_rec = _port_scan(frames, covis=False)
    all_rec, young_rec = _cross_loop_counts(eng_rec)
    assert young_cov >= 10, f"covisibility made only {young_cov}"
    assert young_rec <= young_cov // 4, (young_cov, young_rec)
    assert all_cov > all_rec, (all_cov, all_rec)


@pytest.mark.parametrize("covis", [True, False])
def test_window_slots_match_jax(jax_state, covis):
    cfg_j, cfg_t = _cfg(covis), _port_cfg(covis)
    kfs_j = jax_state.kfs
    kfs_t = state_from_numpy(jax_state, "cpu").kfs
    Kn = kfs_j.valid.shape[0]
    L = jax_state.lms.valid.shape[0]
    valid = np.flatnonzero(np.asarray(kfs_j.valid))
    assert len(valid) >= 8       # a table worth choosing from
    # the mapping pass's windows (re-observation, triangulation plus the
    # newest) and the whole table
    sizes = sorted({min(cfg_t.mapping_reobs_keyframes, Kn),
                    min(cfg_t.mapping_tri_keyframes + 1, Kn), Kn})
    for new_slot in valid:
        for m in sizes:
            for name in ("_window_slots", "_hybrid_slots"):
                sj, okj = getattr(jmapping, name)(
                    cfg_j, kfs_j, jnp.asarray(new_slot, jnp.int32), m, L)
                st, okt = getattr(mapping, name)(cfg_t, kfs_t,
                                                 int(new_slot), m, L)
                np.testing.assert_array_equal(to_np(okt), np.asarray(okj),
                                              err_msg=f"{name} m={m}")
                np.testing.assert_array_equal(
                    to_np(st), np.asarray(sj),
                    err_msg=f"{name} m={m} new_slot={new_slot}")
