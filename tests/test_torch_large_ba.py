"""The port's implicit-Schur large solver (``sfm_tpu_torch.ba.large``)
against the JAX package's: the three ways of building the tables (exact,
dropped counts included), ``run_large_ba`` against JAX's f32 route
(``pallas_matvec=False``) with either preconditioner (``schur_diag`` also on
a table with many dead slots and frozen cameras, and its blocks against a
dense f64 Schur complement), the default unchanged bit for bit, and the
large solver against the port's dense solver on a noiseless scene."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, ba_scene, to_np, to_t

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.ba import large as jlarge
from sfm_tpu_torch.ba import large
from sfm_tpu_torch.ba.core import run_ba
from sfm_tpu_torch.ba.residuals import Observations


def _obs(seed, C=6, L=50, max_obs=6, dead_p=0.2):
    rng = np.random.default_rng(seed)
    return ba_scene(rng, C, L, max_obs, noise_px=0.5, dead_p=dead_p)[2]


def _jobs(obs):
    return JObs(*map(jnp.asarray, obs))


def _tobs(obs):
    return Observations(to_t(obs[0]).long(), to_t(obs[1]).long(),
                        to_t(obs[2]), to_t(obs[3]))


def _equal(ours, ref):
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


# (kmax, nmax): no overflow; landmark-side overflow; both sides overflow
@pytest.mark.parametrize("kmax,nmax", [(6, 64), (3, 64), (4, 20)])
def test_build_tables_equal_jax(kmax, nmax):
    obs = _obs(kmax + nmax)
    _equal(large.build_tables(_tobs(obs), 6, 50, nmax, kmax),
           jlarge.build_tables(_jobs(obs), 6, 50, nmax, kmax))


@pytest.mark.parametrize("kmax,nmax", [(6, 64), (3, 64), (4, 20)])
def test_build_tables_device_equal_jax(kmax, nmax):
    obs = _obs(kmax + nmax)
    t, n = large.build_tables_device(_tobs(obs), 6, 50, nmax, kmax)
    tj, nj = jlarge.build_tables_device(_jobs(obs), 6, 50, nmax, kmax)
    _equal(t, tj)
    assert int(n) == int(nj)
    assert (int(n) > 0) == (kmax < 6 or nmax < 64)
    if kmax == 6 and nmax == 64:   # no overflow: the host-built tables
        h = large.build_tables(_tobs(obs), 6, 50, nmax, kmax)
        for a, b in zip(t, h):
            assert (a == b).all()


@pytest.mark.parametrize("kmax", [6, 3, 1])
def test_build_lm_tables_device_equal_jax(kmax):
    obs = _obs(kmax)
    ours = large.build_lm_tables_device(_tobs(obs), 50, kmax)
    ref = jlarge.build_lm_tables_device(_jobs(obs), 50, kmax)
    _equal(ours[:3], ref[:3])
    assert int(ours[3]) == int(ref[3])
    assert ours[0].dtype == torch.int32
    assert (int(ours[3]) > 0) == (kmax < 6)


def _ba_problem(seed, huber):
    rng = np.random.default_rng(seed)
    C, L = 6, 80
    truth, init, obs = ba_scene(rng, C, L, 5, noise_px=0.5,
                                outlier_p=0.04 if huber else 0.0,
                                dead_p=0.05, min_obs=2)
    # two cameras fixed: one pins the pose gauge, the second the scale
    cam_free = np.arange(C) > 1
    lm_free = np.ones(L, bool)
    lm_free[::9] = False
    for k in ("rv", "tv"):
        init[k][:2] = truth[k][:2]
    return init, obs, cam_free, lm_free, C, L


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_run_large_ba_matches_jax(huber):
    init, obs, cam_free, lm_free, C, L = _ba_problem(1, huber)
    kw = dict(iterations=10, cg_iterations=25, lam0=1e-3, lam_up=4.0,
              lam_down=2.0, huber_delta=huber, tol=1e-4)
    rj, tj, xj, sj = jlarge.run_large_ba(
        jnp.asarray(TEST_K), jnp.asarray(init["rv"]), jnp.asarray(init["tv"]),
        jnp.asarray(init["X"]), jlarge.build_tables(_jobs(obs), C, L, 64, 8),
        cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free),
        pallas_matvec=False, **kw)
    rt, tt, xt, st = large.run_large_ba(
        to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]), to_t(init["X"]),
        large.build_tables(_tobs(obs), C, L, 64, 8), cam_free=to_t(cam_free),
        lm_free=to_t(lm_free), **kw)
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-5)
    # f32 sums in another order, and the port's 6x6 preconditioner
    # inverse (LU) against JAX's closed form: final cost rtol 1e-3, poses
    # 1e-4 rad / 1e-3 m, landmarks 1e-3 m
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-3)
    assert int(st.accepted) == int(sj.accepted)
    # frozen parameters stay put (a pose up to the exp/log round trip)
    np.testing.assert_allclose(to_np(rt)[:2], init["rv"][:2], atol=1e-7)
    np.testing.assert_array_equal(to_np(tt)[:2], init["tv"][:2])
    np.testing.assert_array_equal(to_np(xt)[::9], init["X"][::9])


def test_large_solver_agrees_with_dense_solver():
    """Noiseless scene: both of the port's solvers reach zero cost at the
    same solution (the JAX package's test_parity_with_dense_solver)."""
    rng = np.random.default_rng(2)
    C, L = 5, 60
    truth, init, obs = ba_scene(rng, C, L, 5, min_obs=2)
    cam_free = to_t(np.arange(C) > 1)
    lm_free = torch.ones(L, dtype=torch.bool)
    for k in ("rv", "tv"):
        init[k][:2] = truth[k][:2]
    args = (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]), to_t(init["X"]))
    rd, td, xd, sd = run_ba(*args, _tobs(obs), cam_free=cam_free,
                            lm_free=lm_free, iterations=15)
    rl, tl, xl, sl = large.run_large_ba(
        *args, large.build_tables(_tobs(obs), C, L, 64, 5),
        cam_free=cam_free, lm_free=lm_free, iterations=15, cg_iterations=40)
    assert float(sl.final_cost) < 1e-2 and float(sd.final_cost) < 1e-2
    np.testing.assert_allclose(to_np(rl), to_np(rd), atol=1e-3)
    np.testing.assert_allclose(to_np(xl), to_np(xd), atol=5e-3)


def _run_both(init, obs, cam_free, lm_free, C, L, kmax, **kw):
    """JAX's and the port's run_large_ba on one problem (the tables built
    by each package from the same observations)."""
    rj = jlarge.run_large_ba(
        jnp.asarray(TEST_K), jnp.asarray(init["rv"]), jnp.asarray(init["tv"]),
        jnp.asarray(init["X"]), jlarge.build_tables(_jobs(obs), C, L, 64,
                                                    kmax),
        cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free),
        pallas_matvec=False, **kw)
    rt = large.run_large_ba(
        to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]), to_t(init["X"]),
        large.build_tables(_tobs(obs), C, L, 64, kmax),
        cam_free=to_t(cam_free), lm_free=to_t(lm_free), **kw)
    return rt, rj


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_schur_diag_matches_jax(huber):
    """precond="schur_diag" against JAX's on the file's own problems, at
    test_run_large_ba_matches_jax's bounds."""
    init, obs, cam_free, lm_free, C, L = _ba_problem(1, huber)
    (rt, tt, xt, st), (rj, tj, xj, sj) = _run_both(
        init, obs, cam_free, lm_free, C, L, 8, iterations=10,
        cg_iterations=25, huber_delta=huber, tol=1e-4,
        precond="schur_diag")
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-3)
    assert int(st.accepted) == int(sj.accepted)


def _dead_and_frozen_problem():
    """A third of the observations dead (w == 0) and three of eight
    cameras frozen (the two gauge cameras and one in the middle)."""
    rng = np.random.default_rng(7)
    C, L = 8, 90
    truth, init, obs = ba_scene(rng, C, L, 6, noise_px=0.5, dead_p=0.33,
                                min_obs=3)
    cam_free = np.ones(C, bool)
    cam_free[[0, 1, 4]] = False
    for k in ("rv", "tv"):
        init[k][~cam_free] = truth[k][~cam_free]
    return init, obs, cam_free, np.ones(L, bool), C, L


def test_schur_diag_with_dead_slots_and_frozen_cameras():
    """On a table with many dead slots and frozen cameras: JAX's result at
    the parity bounds, the frozen cameras unmoved, and the dead slots'
    contents ignored (junk camera indices and pixels under w == 0 give
    the same result bit for bit)."""
    init, obs, cam_free, lm_free, C, L = _dead_and_frozen_problem()
    kw = dict(iterations=10, cg_iterations=25, tol=1e-4,
              precond="schur_diag")
    (rt, tt, xt, st), (rj, tj, xj, sj) = _run_both(
        init, obs, cam_free, lm_free, C, L, 6, **kw)
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-3)
    np.testing.assert_array_equal(to_np(tt)[~cam_free],
                                  init["tv"][~cam_free])

    tables = large.build_tables(_tobs(obs), C, L, 64, 6)
    dead = tables.lm_w == 0
    assert dead.float().mean() > 0.3
    junk = tables._replace(
        lm_cam=torch.where(dead, torch.arange(L)[:, None] % C,
                           tables.lm_cam).to(torch.int32),
        lm_uv=torch.where(dead[..., None], torch.full_like(tables.lm_uv, 77.),
                          tables.lm_uv))
    args = (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
            to_t(init["X"]))
    common = dict(cam_free=to_t(cam_free), lm_free=to_t(lm_free), **kw)
    ours = large.run_large_ba(*args, tables, **common)
    again = large.run_large_ba(*args, junk, **common)
    for a, b in zip(ours[:3], again[:3]):
        assert torch.equal(a, b)


def test_schur_coupling_diag_against_f64_dense_schur():
    """The preconditioner's blocks: damp(U) minus the per-camera sums of
    W Vinv W^T equal the diagonal blocks of the reduced camera system
    assembled densely in float64, S = damp(U) - W V^-1 W^T (rtol 1e-5:
    f32 products against f64)."""
    from sfm_tpu_torch.ba.core import _damp
    from sfm_tpu_torch.ba.linearize_pallas import (ba_linearize_plain,
                                                   damped_vinv)
    from sfm_tpu_torch.geometry.rotations import exp_so3
    from sfm_tpu_torch.utils.rowsum import RowSum
    init, obs, cam_free, lm_free, C, L = _dead_and_frozen_problem()
    t = large.build_tables(_tobs(obs), C, L, 64, 6)
    W, V, _, U, _, _ = ba_linearize_plain(
        to_t(TEST_K), exp_so3(to_t(init["rv"])), to_t(init["tv"]),
        to_t(init["X"]), to_t(lm_free).float(), to_t(cam_free).float(),
        t.lm_cam, t.lm_uv, t.lm_w)
    lam = 1e-3
    vinv = damped_vinv(V, lam)
    cs = large.camera_slots(t.lm_cam, t.lm_w, C)
    P = large._schur_coupling_diag(W, vinv, RowSum.from_csr(cs.offsets,
                                                            cs.slots))
    ours = to_np(_damp(U, lam) - P)

    # the whole W [C, L, 6, 3] in f64, then S's diagonal blocks
    Wd = np.zeros((C, L, 6, 3))
    Wn, lm_cam, live = (to_np(W).astype(np.float64), to_np(t.lm_cam),
                        to_np(t.lm_w) != 0)
    for l, k in zip(*np.nonzero(live)):
        Wd[lm_cam[l, k], l] += Wn[l, k]
    Vi = to_np(vinv).astype(np.float64)
    S = to_np(_damp(U.double(), lam)) - np.einsum(
        "clab,lbd,cled->cae", Wd, Vi, Wd)
    np.testing.assert_allclose(ours, S, rtol=1e-5, atol=1e-5 * np.abs(S).max())
    # a frozen camera's blocks are its damped U alone: no coupling
    assert (to_np(P)[~cam_free] == 0).all()


@pytest.mark.parametrize("huber,tol", [(0.0, 1e-4), (2.0, 0.0)])
def test_jacobi_u_unchanged_bit_for_bit(huber, tol):
    """The default preconditioner, named or not, is the loop that ran
    before schur_diag was added (kept in test_torch_dist_large_ba.py)."""
    from test_torch_dist_large_ba import _run_large_ba_before
    init, obs, cam_free, lm_free, C, L = _dead_and_frozen_problem()
    args = (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
            to_t(init["X"]), large.build_tables(_tobs(obs), C, L, 64, 6))
    kw = dict(cam_free=to_t(cam_free), lm_free=to_t(lm_free), iterations=8,
              cg_iterations=15, huber_delta=huber, tol=tol)
    ref = _run_large_ba_before(*args, **kw)
    for ours in (large.run_large_ba(*args, **kw),
                 large.run_large_ba(*args, precond="jacobi_u", **kw)):
        for a, b in zip(ours[:3], ref[:3]):
            assert torch.equal(a, b)
        for a, b in zip(ours[3][:4], ref[3][:4]):
            assert float(a) == float(b)


def test_unknown_preconditioner_raises():
    init, obs, cam_free, lm_free, C, L = _ba_problem(1, 0.0)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        large.run_large_ba(
            to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
            to_t(init["X"]), large.build_tables(_tobs(obs), C, L, 64, 8),
            cam_free=to_t(cam_free), lm_free=to_t(lm_free),
            precond="jacobi_s")
