"""The port's per-frame metrics against the JAX package's StepMetrics.

Every branch reports exactly the StepMetrics fields, in its order, with
its dtypes (int32 counters, a bool flag, float32 vectors) and shapes, and
the same values: counters and flags exactly, poses and the reprojection
error to 1e-4.  ``ba_dropped_obs`` follows the JAX branches: a carried
state with a nonzero counter reports it on a tracked frame and 0 on the
lost branch (and 0 on bootstrap)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import (TEST_CFG_KW, TEST_K, assert_metrics_match,
                             to_t)

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.bootstrap import bootstrap_step as jax_bootstrap_step
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu.features.match import match_features as jax_match
from sfm_tpu.ransac import sample_masked as jax_sample_masked
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (RUNNING, CameraParams, bootstrap_step,
                                  init_state, make_frame, state_from_numpy,
                                  step_frame, tracking_step)
from sfm_tpu_torch.engine.state import frame_from_numpy

JCFG = JaxConfig(**TEST_CFG_KW)
CFG = SfMConfig(**TEST_CFG_KW)
DROPPED = 7


@pytest.fixture(scope="module")
def run():
    scene = SpriteScene(np.random.default_rng(3))
    rvecs, tvecs = strafe_trajectory(10)
    frames = [scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
              for i in range(10)]
    eng = JaxEngine(TEST_K, (240, 320), None, JCFG)
    states = [jax.device_get(eng.state)]
    for f in frames[:8]:
        eng.add_frame(f)
        states.append(jax.device_get(eng.state))
    return dict(eng=eng, frames=frames, states=states)


def _cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def _jax_step(run, tree, image):
    """The JAX engine's jitted step on a copy of ``tree``."""
    return jax.device_get(run["eng"]._step(jax.device_put(tree),
                                           jnp.asarray(image)))


def _jax_frame(run, image, n):
    cam = run["eng"].cam
    return jax.device_get(jax.jit(lambda im, k: jax_make_frame(
        JCFG, cam, im, k))(jnp.asarray(image), jnp.asarray(n, jnp.int32)))


def test_metrics_schema():
    """A fresh step reports every field with its dtype and shape."""
    st, m = step_frame(CFG, _cam(), init_state(CFG, "cpu"),
                       to_t(np.zeros((240, 320), np.float32)), None)
    assert [k for k in m] == list(
        __import__("sfm_tpu.engine.state", fromlist=["StepMetrics"])
        .StepMetrics._fields)
    assert m["n_detected"].dtype == m["status"].dtype == to_t(
        np.int32(0)).dtype
    assert m["keyframe_added"].dtype == to_t(np.bool_(False)).dtype
    assert m["guid_bbox_axes"].shape == (2, 2)


def test_bootstrap_metrics(run):
    """The first frame (keyframe 0) and the bootstrap success on frame 1,
    with the JAX F-RANSAC samples injected.  The success branch runs with
    ba_iterations=0 in both packages: the pair BA on the 0.05 m bootstrap
    baseline leaves the scale gauge nearly free, and the two packages' LM
    iterates drift apart along it (ROADMAP.md, Queue 3).  Its pose is held
    to 1e-2: the translation direction of a two-view solve on that
    baseline moves with the float32 F estimate (measured 3.8e-3)."""
    tree0 = run["states"][0]
    st_j, m_j = _jax_step(run, tree0, run["frames"][0])
    st_t, m_t = step_frame(CFG, _cam(), state_from_numpy(tree0, "cpu"),
                           to_t(run["frames"][0]), None)
    assert_metrics_match(m_t, m_j)

    tree1 = run["states"][1]
    fr = _jax_frame(run, run["frames"][1], 1)
    jcfg0 = dataclasses.replace(JCFG, ba_iterations=0)
    cam = run["eng"].cam
    st_j, m_j = jax.device_get(jax.jit(lambda s, f: jax_bootstrap_step(
        jcfg0, cam, s, f))(tree1, fr))
    assert int(m_j.status) == RUNNING
    prev = tree1.prev
    res = jax_match(prev.desc, prev.xy, prev.kp_valid, fr.desc, fr.xy,
                    fr.kp_valid, min_radius=JCFG.match_min_radius,
                    max_radius=JCFG.match_max_radius,
                    max_distance=JCFG.match_max_distance,
                    ratio=JCFG.match_ratio)
    _, k_f = jax.random.split(tree1.key)
    samples = jax_sample_masked(k_f, res.mask, JCFG.ransac_hypotheses, 8)
    st_t, m_t = bootstrap_step(SfMConfig(**dataclasses.asdict(jcfg0)),
                               _cam(), state_from_numpy(tree1, "cpu"),
                               frame_from_numpy(fr, "cpu"),
                               f_samples=to_t(np.asarray(samples)))
    assert_metrics_match(m_t, m_j, rtol=0.0, atol=1e-2)


def test_lost_branch_metrics(run):
    """A blank frame from a RUNNING state carried with ba_dropped_obs > 0:
    the lost branch reports ba_dropped_obs 0 in both packages."""
    tree = run["states"][8]._replace(
        ba_dropped_obs=np.asarray(DROPPED, np.int32))
    blank = np.full((240, 320), 40.0, np.float32)
    st_j, m_j = _jax_step(run, tree, blank)
    st_t, m_t = step_frame(CFG, _cam(), state_from_numpy(tree, "cpu"),
                           to_t(blank), None)
    assert int(m_j.status) == RUNNING and int(m_j.n_matches) == 0
    assert int(m_j.ba_dropped_obs) == 0
    assert_metrics_match(m_t, m_j)
    assert int(st_t.ba_dropped_obs) == DROPPED


def test_tracked_branch_metrics(run):
    """A tracked frame from the same carried state, with the JAX PnP
    samples injected: ba_dropped_obs is reported as carried."""
    tree = run["states"][8]._replace(
        ba_dropped_obs=np.asarray(DROPPED, np.int32))
    image = run["frames"][8]
    st_j, m_j = _jax_step(run, tree, image)
    assert int(m_j.ba_dropped_obs) == DROPPED
    assert not bool(m_j.keyframe_added)
    fr = _jax_frame(run, image, 8)
    prev = tree.prev
    src_valid = prev.kp_valid & (prev.landmark >= 0)
    res = jax_match(prev.desc, prev.xy, src_valid, fr.desc, fr.xy,
                    fr.kp_valid, min_radius=JCFG.match_min_radius,
                    max_radius=JCFG.match_max_radius,
                    max_distance=JCFG.match_max_distance,
                    ratio=JCFG.match_ratio)
    safe = np.where(src_valid, prev.landmark, 0)
    pnp_valid = np.asarray(res.mask) & np.asarray(tree.lms.valid)[safe]
    _, k_pnp = jax.random.split(tree.key)
    samples = jax_sample_masked(k_pnp, jnp.asarray(pnp_valid),
                                JCFG.pnp_hypotheses, JCFG.pnp_sample_size)
    st_t, m_t = tracking_step(CFG, _cam(), state_from_numpy(tree, "cpu"),
                              frame_from_numpy(fr, "cpu"), None,
                              pnp_samples=to_t(np.asarray(samples)))
    assert_metrics_match(m_t, m_j)
