"""The per-observation PCG solver ``run_ba_cg`` (block-Jacobi PCG on the
per-observation coupling) against the JAX package's and the dense solver
on seeded problems, and against the f64 reference solver
``sfm_tpu.ba.reference``."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import TEST_K, ba_scene, to_np, to_t

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.ba import run_ba_cg as jax_run_ba_cg
from sfm_tpu_torch.ba import BAStats, run_ba, run_ba_cg
from sfm_tpu_torch.ba.residuals import Observations
from test_ba import make_ba_scene
from test_ba_reference import _perturbed_scene, _reference


def _tobs(obs) -> Observations:
    return Observations(to_t(np.asarray(obs[0])).long(),
                        to_t(np.asarray(obs[1])).long(),
                        to_t(np.asarray(obs[2], np.float32)),
                        to_t(np.asarray(obs[3], np.float32)))


def _perturbed(rng, rvec, tvec, X, s_pose=0.02, s_pt=0.05):
    """test_ba.TestConvergence._perturb, as numpy."""
    rv = np.asarray(rvec) + rng.normal(0, s_pose, rvec.shape)
    tv = np.asarray(tvec) + rng.normal(0, s_pose, tvec.shape)
    Xp = np.asarray(X) + rng.normal(0, s_pt, X.shape)
    return (rv.astype(np.float32), tv.astype(np.float32),
            Xp.astype(np.float32))


def test_bastats_dropped_obs_defaults_to_zero():
    st = BAStats(*[to_t(np.float32(0))] * 4)
    assert st.dropped_obs == 0
    assert st._replace(dropped_obs=3).dropped_obs == 3


def test_cg_converges_and_matches_dense(rng):
    """tests/test_ba.py::TestCGSolver::test_cg_converges_and_matches_dense
    on the port: run_ba_cg reaches run_ba's optimum."""
    K, rvec, tvec, X, obs = make_ba_scene(rng)
    rv0, tv0, X0 = _perturbed(rng, rvec, tvec, X, s_pt=0.05)
    rv0[0], tv0[0] = np.asarray(rvec)[0], np.asarray(tvec)[0]
    cam_free = to_t(np.arange(4) > 0)
    lm_free = to_t(np.ones(60, bool))
    args = (to_t(np.asarray(K)), to_t(rv0), to_t(tv0), to_t(X0), _tobs(obs))
    rv_d, tv_d, _, st_d = run_ba(*args, cam_free=cam_free, lm_free=lm_free,
                                 iterations=25)
    rv_c, tv_c, _, st_c = run_ba_cg(*args, cam_free=cam_free,
                                    lm_free=lm_free, iterations=25,
                                    cg_iterations=20)
    assert float(st_c.final_cost) < 1e-2 * float(st_c.initial_cost)
    assert float(st_c.final_cost) < float(st_d.final_cost) * 10 + 1e-4
    np.testing.assert_allclose(to_np(rv_c), to_np(rv_d), atol=2e-3)
    np.testing.assert_allclose(to_np(tv_c), to_np(tv_d), atol=1e-2)


def test_cg_masked_padding_untouched(rng):
    """tests/test_ba.py::TestCGSolver::test_cg_masked_padding_untouched:
    a frozen camera and padding landmarks keep their inputs."""
    K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=40)
    rv0 = np.concatenate([np.asarray(rvec), np.zeros((1, 3))]) + 0.01
    tv0 = np.concatenate([np.asarray(tvec), np.zeros((1, 3))])
    X0 = np.concatenate([np.asarray(X), np.full((8, 3), 7.7)]) + 0.02
    rv0, tv0, X0 = (a.astype(np.float32) for a in (rv0, tv0, X0))
    lm_free = np.concatenate([np.ones(40, bool), np.zeros(8, bool)])
    rv, tv, Xf, st = run_ba_cg(
        to_t(np.asarray(K)), to_t(rv0), to_t(tv0), to_t(X0), _tobs(obs),
        cam_free=to_t(np.array([False, True, True, False])),
        lm_free=to_t(lm_free), iterations=10)
    assert int(st.accepted) > 0
    # up to the exp/log round trip of the zero pose update, as in run_ba
    np.testing.assert_allclose(to_np(rv)[[0, 3]], rv0[[0, 3]], atol=1e-6)
    np.testing.assert_array_equal(to_np(tv)[[0, 3]], tv0[[0, 3]])
    np.testing.assert_array_equal(to_np(Xf)[40:], X0[40:])


def test_cg_frozen_cameras_match_jax():
    """run_ba_cg with every camera frozen (the reduced system is zero, so
    each step is the landmarks' own 3x3 solves) against JAX's, on noisy
    pixels under the true poses: the poses stay put, and the initial cost
    (rel 1e-5), final cost (rel 1e-3), accepted steps and landmarks match."""
    rng = np.random.default_rng(5)
    truth, init, obs = ba_scene(rng, 6, 80, 4, noise_px=0.5, min_obs=2)
    rv0, tv0 = truth["rv"], truth["tv"]
    kw = dict(iterations=15, cg_iterations=10, huber_delta=0.0, tol=1e-4)
    _, _, xj, sj = jax_run_ba_cg(
        jnp.asarray(TEST_K), jnp.asarray(rv0), jnp.asarray(tv0),
        jnp.asarray(init["X"]), JObs(*[jnp.asarray(o) for o in obs]),
        cam_free=jnp.zeros(6, bool), lm_free=jnp.ones(80, bool), **kw)
    rt, tt, xt, st = run_ba_cg(
        to_t(TEST_K), to_t(rv0), to_t(tv0), to_t(init["X"]), _tobs(obs),
        cam_free=to_t(np.zeros(6, bool)), lm_free=to_t(np.ones(80, bool)),
        **kw)
    np.testing.assert_allclose(float(st.initial_cost), float(sj.initial_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    assert int(st.accepted) == int(sj.accepted)
    np.testing.assert_allclose(to_np(rt), rv0, atol=1e-6)
    np.testing.assert_array_equal(to_np(tt), tv0)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-4)


def test_cg_matches_f64_reference(rng):
    """tests/test_ba_reference.py::TestSolverParity::test_run_ba_cg on the
    port: final cost within 1% of the f64 LM's, free poses within its
    tolerances."""
    K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(rng)
    rv_ref, tv_ref, _, costs_ref = _reference(K, rv0, tv0, X0, obs,
                                              cam_free, lm_free)
    rv, tv, _, st = run_ba_cg(
        to_t(np.asarray(K)), to_t(np.asarray(rv0)), to_t(np.asarray(tv0)),
        to_t(np.asarray(X0)), _tobs(obs), cam_free=to_t(cam_free),
        lm_free=to_t(lm_free), iterations=30, cg_iterations=40, tol=1e-8)
    assert abs(float(st.final_cost) - costs_ref[-1]) <= 0.01 * costs_ref[-1]
    np.testing.assert_allclose(to_np(rv), rv_ref, atol=2e-3)
    np.testing.assert_allclose(to_np(tv), tv_ref, atol=5e-3)


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_cg_matches_jax(huber):
    """run_ba_cg against JAX's on a noisy strafe with outliers, dead
    observations, a frozen camera and frozen landmarks: the same initial
    cost (rel 1e-5), final cost (rel 1e-3) and accepted steps."""
    rng = np.random.default_rng(4)
    _, init, obs = ba_scene(rng, 6, 80, 4, noise_px=0.5, outlier_p=0.03,
                            dead_p=0.1, min_obs=2)
    cam_free = np.arange(6) > 0
    lm_free = np.ones(80, bool)
    lm_free[:4] = False
    kw = dict(iterations=12, cg_iterations=15, lam0=1e-3, lam_up=4.0,
              lam_down=2.0, huber_delta=huber, tol=3e-4)
    rj, tj, xj, sj = jax_run_ba_cg(
        jnp.asarray(TEST_K), jnp.asarray(init["rv"]), jnp.asarray(init["tv"]),
        jnp.asarray(init["X"]), JObs(*[jnp.asarray(o) for o in obs]),
        cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free), **kw)
    rt, tt, xt, st = run_ba_cg(
        to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]), to_t(init["X"]),
        _tobs(obs), cam_free=to_t(cam_free), lm_free=to_t(lm_free), **kw)
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    assert int(st.accepted) == int(sj.accepted)
    # the iterates: f32 sums in another order through 15 unconverged CG
    # iterations (measured: 1.2e-5 rad, 1.4e-4 m, landmarks median 5e-5 m
    # and at most 1.7e-3 m, on one seen twice with an outlier)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-3)
    dx = np.abs(to_np(xt) - np.asarray(xj))
    assert np.median(dx) < 1e-4 and dx.max() < 5e-3
    np.testing.assert_array_equal(to_np(xt)[:4], init["X"][:4])
    np.testing.assert_array_equal(to_np(tt)[0], init["tv"][0])
