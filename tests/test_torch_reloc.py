"""Relocalization against the JAX package, and a port-only scan that goes
LOST and recovers.

From a JAX LOST state carried across (state_from_numpy): the global match
of every landmark slot against the frame (exact), the P3P RANSAC with the
JAX samples injected, the inlier links (>= 99% equal) and the metrics
(counters exact), on the recovery frame and on a frame that stays LOST.
The recovered rotation agrees to 1e-4 rad; the translation to 1e-3 m
(unit bootstrap baseline): its depth component is the weak direction of a
pose-only refinement from a P3P start, and the P3P candidates of two
float32 programs already differ by up to ~6e-3 (test_torch_p3p.py;
measured here 7.3e-4 in depth, 1e-5 across)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import (TEST_CFG_KW, TEST_K, assert_metrics_match,
                             to_np, to_t)

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.reloc import reloc_step as jax_reloc_step
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu.features.match import match_features as jax_match
from sfm_tpu.ransac import sample_masked as jax_sample_masked
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch import native
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (LOST, RUNNING, CameraParams, SfMEngine,
                                  reloc_step, state_from_numpy)
from sfm_tpu_torch.engine.state import frame_from_numpy
from sfm_tpu_torch.features.match_pallas import match_features_pallas

JCFG = JaxConfig(**TEST_CFG_KW)
CFG = SfMConfig(**TEST_CFG_KW)
BLANK = np.full((240, 320), 40.0, np.float32)


@pytest.fixture(scope="module")
def lost():
    scene = SpriteScene(np.random.default_rng(3))
    rvecs, tvecs = strafe_trajectory(30)
    frames = [scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
              for i in range(12)]
    eng = JaxEngine(TEST_K, (240, 320), None, JCFG)
    for f in frames[:10]:
        eng.add_frame(f)
    for _ in range(JCFG.max_lost_frames + 2):
        eng.add_frame(BLANK)
    assert eng.status == LOST
    return dict(eng=eng, frames=frames, tree=jax.device_get(eng.state))


def _cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def _both(lost, image):
    """JAX reloc_step and the port's, from the carried LOST state, on one
    image; the port gets the JAX step's PnP samples."""
    tree = lost["tree"]
    cam = lost["eng"].cam
    n = int(tree.frame_count)
    fr = jax.device_get(jax.jit(lambda im: jax_make_frame(
        JCFG, cam, im, jnp.asarray(n, jnp.int32)))(jnp.asarray(image)))
    st_j, m_j = jax.device_get(jax.jit(lambda s, f: jax_reloc_step(
        JCFG, cam, s, f))(tree, fr))
    L = JCFG.max_landmarks
    res_j = jax_match(tree.rep_desc, jnp.zeros((L, 2)), tree.lms.valid,
                      fr.desc, fr.xy, fr.kp_valid, min_radius=0.0,
                      max_radius=1e9, max_distance=JCFG.match_max_distance,
                      ratio=JCFG.match_ratio)
    _, k_pnp = jax.random.split(tree.key)
    samples = jax_sample_masked(k_pnp, res_j.mask & tree.lms.valid,
                                JCFG.pnp_hypotheses, 3)
    st = state_from_numpy(tree, "cpu")
    frame = frame_from_numpy(fr, "cpu")
    st_t, m_t = reloc_step(CFG, _cam(), st, frame,
                           pnp_samples=to_t(np.asarray(samples)))
    res_t = match_features_pallas(
        st.rep_desc, to_t(np.zeros((L, 2), np.float32)), st.lms.valid,
        frame.desc, frame.xy, frame.kp_valid, min_radius=0.0,
        max_radius=1e9, max_distance=CFG.match_max_distance,
        ratio=CFG.match_ratio)
    return (st_t, m_t, res_t), (st_j, m_j, res_j)


def test_reloc_recovers_like_jax(lost):
    (st_t, m_t, res_t), (st_j, m_j, res_j) = _both(lost, lost["frames"][10])
    # the windowless global match: exact
    np.testing.assert_array_equal(to_np(res_t.mask), np.asarray(res_j.mask))
    np.testing.assert_array_equal(to_np(res_t.idx), np.asarray(res_j.idx))
    assert int(m_j.status) == RUNNING and int(m_j.n_inliers) >= 15
    assert_metrics_match(m_t, m_j, rtol=0.0, atol=1e-3)
    assert int(st_t.status) == RUNNING and int(st_t.lost_count) == 0
    np.testing.assert_allclose(to_np(st_t.prev.rvec),
                               np.asarray(st_j.prev.rvec), atol=1e-4)
    np.testing.assert_allclose(to_np(st_t.prev.tvec),
                               np.asarray(st_j.prev.tvec), atol=1e-3)
    links_t = to_np(st_t.prev.landmark)
    links_j = np.asarray(st_j.prev.landmark)
    assert (links_t >= 0).sum() == int(m_j.n_inliers)
    assert (links_t == links_j).mean() >= 0.99


def test_reloc_still_lost_like_jax(lost):
    (st_t, m_t, _), (st_j, m_j, _) = _both(lost, BLANK)
    assert int(m_j.status) == LOST
    assert_metrics_match(m_t, m_j)
    assert int(st_t.status) == LOST
    np.testing.assert_array_equal(to_np(st_t.prev.landmark),
                                  np.asarray(st_j.prev.landmark))


def test_blank_frames_cause_lost_then_recover():
    """tests/test_engine.py::TestLostAndRelocalization on the port's
    engine: blank frames make it LOST, the next real frame relocalizes
    through K1's windowless match (its plain version on the CPU) and P3P,
    and tracking goes on."""
    scene = SpriteScene(np.random.default_rng(3))
    rvecs, tvecs = strafe_trajectory(30)
    eng = SfMEngine(TEST_K, (240, 320), None, CFG, device="cpu")
    for i in range(10):
        eng.add_frame(scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320))
    assert eng.status == RUNNING
    for _ in range(CFG.max_lost_frames + 2):
        m = eng.add_frame(BLANK)
    assert eng.status == LOST and int(m["status"]) == LOST
    m = eng.add_frame(scene.render(TEST_K, rvecs[10], tvecs[10], 240, 320))
    assert eng.status == RUNNING
    assert int(m["n_inliers"]) >= 15 and int(m["n_tracked"]) >= 15
    for i in range(11, 16):
        m = eng.add_frame(scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320))
    assert eng.status == RUNNING and int(m["n_tracked"]) >= 15


def test_reloc_runs_on_k1_dispatch(monkeypatch):
    """The global match goes through K1's dispatch (hamming_match) with the
    whole landmark axis as sources and a window that admits everything."""
    from sfm_tpu_torch.features import match_pallas as mp
    calls = []
    real = mp.hamming_match

    def spy(*args):
        calls.append((tuple(args[0].shape), args[7]))
        return real(*args)

    monkeypatch.setattr(mp, "hamming_match", spy)
    st = state_from_numpy(jax.device_get(
        JaxEngine(TEST_K, (240, 320), None, JCFG).state), "cpu")
    from sfm_tpu_torch.engine.state import make_frame
    frame = make_frame(CFG, _cam(), to_t(BLANK), st.frame_count)
    reloc_step(CFG, _cam(), st, frame)
    assert calls == [((1, CFG.max_landmarks, CFG.desc_words),
                      float(np.float32(1e18)))]
    assert native.LAUNCHES["hamming_match"] == 0
