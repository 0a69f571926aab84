"""RANSAC against the JAX package with the JAX package's own samples
injected (jax.random streams cannot be reproduced in torch), plus the
outcome tests on the port's own torch.Generator samples."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, random_scene, to_np, to_t

from sfm_tpu import ransac as jr
from sfm_tpu_torch import ransac
from sfm_tpu_torch.np_geometry import project_np, rodrigues_np


@pytest.fixture
def contaminated():
    rng = np.random.default_rng(0)
    s = random_scene(rng, n_points=160)
    out = rng.uniform(0, 1, 160) < 0.25
    uv1 = s["uv1"].copy()
    uv1[out] = rng.uniform(0, [320, 240], (out.sum(), 2))
    s["uv1n"] = (uv1 + rng.normal(0, 0.3, uv1.shape)).astype(np.float32)
    s["outlier"] = out
    s["valid"] = rng.uniform(0, 1, 160) < 0.95
    return s


def _unit(F):
    F = np.asarray(F, np.float64).reshape(-1)
    F = F / np.linalg.norm(F)
    return F * np.sign(F[np.argmax(np.abs(F))])


def test_fundamental_with_injected_samples(contaminated):
    s = contaminated
    key = jax.random.PRNGKey(3)
    valid = jnp.asarray(s["valid"])
    samples = np.asarray(jr.sample_masked(key, valid, 64, 8))
    ref = jr.ransac_fundamental(key, jnp.asarray(s["uv0"]),
                                jnp.asarray(s["uv1n"]), valid,
                                n_hypotheses=64)
    ours = ransac.ransac_fundamental(None, to_t(s["uv0"]), to_t(s["uv1n"]),
                                     to_t(s["valid"]), n_hypotheses=64,
                                     samples=to_t(samples))
    # atol 2e-3 on the unit-normalised F: f32 eigensolvers differ
    np.testing.assert_allclose(_unit(to_np(ours.model)), _unit(ref.model),
                               atol=2e-3)
    agree = (to_np(ours.inliers) == np.asarray(ref.inliers)).mean()
    assert agree >= 0.99, agree
    # a random outlier can land within 3.84 px^2 of its epipolar line
    assert to_np(ours.inliers)[s["outlier"]].mean() < 0.1


def test_pnp_with_injected_samples(contaminated):
    s = contaminated
    key = jax.random.PRNGKey(4)
    valid = jnp.asarray(s["valid"])
    samples = np.asarray(jr.sample_masked(key, valid, 32, 6))
    prior_r = (s["rvec1"] + 0.01).astype(np.float32)
    prior_t = (s["t1"] + 0.02).astype(np.float32)
    kw = dict(n_hypotheses=32, sample_size=6, threshold=7.0,
              refine_iters=6, min_inliers=5)
    ref = jr.ransac_pnp(key, jnp.asarray(TEST_K), jnp.asarray(s["X"]),
                        jnp.asarray(s["uv1n"]), valid,
                        prior_rvec=jnp.asarray(prior_r),
                        prior_tvec=jnp.asarray(prior_t), **kw)
    ours = ransac.ransac_pnp(None, to_t(TEST_K), to_t(s["X"]),
                             to_t(s["uv1n"]), to_t(s["valid"]),
                             prior_rvec=to_t(prior_r),
                             prior_tvec=to_t(prior_t),
                             samples=to_t(samples), **kw)
    # atol 1e-4 rad / 1e-4 m: refinement through other 6x6 solves
    np.testing.assert_allclose(to_np(ours.rvec), np.asarray(ref.rvec),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(ours.tvec), np.asarray(ref.tvec),
                               atol=1e-4)
    np.testing.assert_array_equal(to_np(ours.inliers),
                                  np.asarray(ref.inliers))
    assert bool(ours.ok) and bool(ref.ok)


def test_sample_masked_draws_distinct_valid_indices():
    g = torch.Generator().manual_seed(0)
    valid = torch.tensor(np.random.default_rng(1).uniform(0, 1, 50) < 0.5)
    samples = ransac.sample_masked(g, valid, 40, 6)
    assert samples.shape == (40, 6)
    assert bool(valid[samples].all())
    for row in samples.tolist():
        assert len(set(row)) == 6
    again = ransac.sample_masked(torch.Generator().manual_seed(0), valid,
                                 40, 6)
    assert torch.equal(samples, again)


def test_pnp_recovers_through_outliers(contaminated):
    """Outcome test on the port's own samples: no prior, 25% outliers."""
    s = contaminated
    res = ransac.ransac_pnp(torch.Generator().manual_seed(7), to_t(TEST_K),
                            to_t(s["X"]), to_t(s["uv1n"]), to_t(s["valid"]),
                            n_hypotheses=64, refine_iters=6)
    assert bool(res.ok)
    np.testing.assert_allclose(to_np(res.rvec), s["rvec1"], atol=2e-3)
    np.testing.assert_allclose(to_np(res.tvec), s["t1"], atol=1e-2)
    inl = to_np(res.inliers)
    # a random outlier can land within 7 px of its projection
    assert inl[s["outlier"]].mean() < 0.1
    assert inl[~s["outlier"] & s["valid"]].mean() > 0.95


def test_p3p_is_not_ported_yet(contaminated):
    """P3P is ported now (the name is kept from when it raised): on the
    port's own 3-point samples it recovers the pose through 25% outliers
    with no prior, and an unknown solver is refused."""
    s = contaminated
    res = ransac.ransac_pnp(torch.Generator().manual_seed(7), to_t(TEST_K),
                            to_t(s["X"]), to_t(s["uv1n"]), to_t(s["valid"]),
                            n_hypotheses=32, refine_iters=6, solver="p3p")
    assert bool(res.ok)
    np.testing.assert_allclose(to_np(res.rvec), s["rvec1"], atol=2e-3)
    np.testing.assert_allclose(to_np(res.tvec), s["t1"], atol=1e-2)
    assert to_np(res.inliers)[~s["outlier"] & s["valid"]].mean() > 0.95
    with pytest.raises(ValueError, match="solver"):
        ransac.ransac_pnp(None, to_t(TEST_K), to_t(s["X"]), to_t(s["uv1n"]),
                          to_t(s["valid"]), solver="epnp")


def _former_refined(K, rv, tv, xyz, uv, valid, threshold, iters):
    """ransac_pnp's refinement as it was written inline before it became
    the module-level ``refined``."""
    from sfm_tpu_torch.geometry.pnp import refine_pose, reprojection_errors
    for _ in range(2):
        inl = (reprojection_errors(K, rv, tv, xyz, uv) < threshold) & valid
        rv, tv = refine_pose(K, rv, tv, xyz, uv, inl.to(torch.float32),
                             iters=iters)
    inl = (reprojection_errors(K, rv, tv, xyz, uv) < threshold) & valid
    return rv, tv, inl, inl.sum(-1)


@pytest.mark.parametrize("batch", [None, 3])
def test_refined_equals_the_former_inline_loop(contaminated, batch):
    """The module-level ``refined`` on the CPU (``refined_plain``) gives
    the former inline loop's pose, inliers and count bit for bit, for one
    pose and for a fleet's batch of poses; the kernel's wrapper refuses
    host tensors before it builds or launches anything."""
    s = contaminated
    K, X, uv, valid = (to_t(TEST_K), to_t(s["X"]), to_t(s["uv1n"]),
                       to_t(s["valid"]))
    rv = to_t((s["rvec1"] + 0.004).astype(np.float32))
    tv = to_t((s["t1"] - 0.01).astype(np.float32))
    if batch:
        g = torch.Generator().manual_seed(batch)
        X, uv, valid = (x.expand(batch, *x.shape).clone() for x in
                        (X, uv, valid))
        uv = uv + 0.2 * torch.randn(uv.shape, generator=g)
        rv = rv + 1e-3 * torch.randn((batch, 3), generator=g)
        tv = tv.expand(batch, 3)
    want = _former_refined(K, rv, tv, X, uv, valid, 7.0, 6)
    got = ransac.refined(K, rv, tv, X, uv, valid, threshold=7.0, iters=6)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].min()) > 0
    with pytest.raises(ValueError, match="CUDA"):
        ransac.refined_kernel(K, rv, tv, X, uv, valid, threshold=7.0,
                              iters=6)


def test_pose_refinements_are_counted_on_the_cpu(contaminated):
    """Every call of either entry (``refine_pose``, ``refined``) counts
    one ``pose_refine``; on the CPU nothing launches the kernel, so
    ``pose_kernel`` stays 0.  ransac_pnp refines once, and once more for
    the fast path."""
    from sfm_tpu_torch.geometry.pnp import refine_pose
    from sfm_tpu_torch.utils.profiling import RECORDER
    s = contaminated
    args = (to_t(TEST_K), to_t(s["X"]), to_t(s["uv1n"]), to_t(s["valid"]))
    prior = (to_t(s["rvec1"]), to_t(s["t1"]))
    with RECORDER.enabled() as trace:
        refine_pose(args[0], *prior, args[1], args[2],
                    args[3].to(torch.float32), iters=2)
        ransac.refined(args[0], *prior, *args[1:], threshold=7.0, iters=2)
        ransac.ransac_pnp(torch.Generator().manual_seed(1), *args,
                          n_hypotheses=8, refine_iters=2)
        ransac.ransac_pnp(torch.Generator().manual_seed(1), *args,
                          n_hypotheses=8, refine_iters=2,
                          prior_rvec=prior[0], prior_tvec=prior[1],
                          fast_path_ratio=0.5)
    assert trace.counter("pose_refine") == 5
    assert trace.counter("pose_kernel") == 0


@pytest.fixture
def planar():
    """A plane seen by two cameras (an exact homography between the views),
    25% of the second view's points replaced by outliers, 0.3 px noise."""
    rng = np.random.default_rng(11)
    n = 150
    xy = rng.uniform(-2, 2, (n, 2))
    X = np.stack([xy[:, 0], xy[:, 1], 5.0 + 0.2 * xy[:, 0] - 0.1 * xy[:, 1]],
                 1)
    R1 = rodrigues_np(np.array([0.02, -0.05, 0.01]))
    t1 = np.array([0.4, 0.05, -0.03])
    uv0 = project_np(TEST_K, np.eye(3), np.zeros(3), X)
    uv1 = project_np(TEST_K, R1, t1, X)
    out = rng.uniform(0, 1, n) < 0.25
    uv1[out] = rng.uniform(0, [320, 240], (out.sum(), 2))
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    return dict(uv0=uv0.astype(np.float32), uv1=uv1.astype(np.float32),
                outlier=out, valid=rng.uniform(0, 1, n) < 0.95)


def test_homography_with_injected_samples(planar):
    """Inliers equal to JAX's, H within 2e-3 after normalisation, with the
    JAX samples injected."""
    s = planar
    key = jax.random.PRNGKey(5)
    valid = jnp.asarray(s["valid"])
    samples = np.asarray(jr.sample_masked(key, valid, 64, 4))
    ref = jr.ransac_homography(key, jnp.asarray(s["uv0"]),
                               jnp.asarray(s["uv1"]), valid, n_hypotheses=64)
    ours = ransac.ransac_homography(None, to_t(s["uv0"]), to_t(s["uv1"]),
                                    to_t(s["valid"]), n_hypotheses=64,
                                    samples=to_t(samples))
    np.testing.assert_allclose(_unit(to_np(ours.model)), _unit(ref.model),
                               atol=2e-3)
    np.testing.assert_array_equal(to_np(ours.inliers),
                                  np.asarray(ref.inliers))
    assert int(ours.n_inliers) == int(ref.n_inliers)
    assert float(ours.score) == float(ref.score)
    inl = to_np(ours.inliers)
    assert inl[s["outlier"]].mean() < 0.05
    assert inl[~s["outlier"] & s["valid"]].mean() > 0.95


def test_homography_on_its_own_samples(planar):
    s = planar
    res = ransac.ransac_homography(torch.Generator().manual_seed(1),
                                   to_t(s["uv0"]), to_t(s["uv1"]),
                                   to_t(s["valid"]), n_hypotheses=64)
    inl = to_np(res.inliers)
    assert inl[s["outlier"]].mean() < 0.05
    assert inl[~s["outlier"] & s["valid"]].mean() > 0.95


@pytest.mark.parametrize("ratio,takes_prior", [(0.3, True), (0.8, False)])
def test_pnp_fast_path_matches_jax(contaminated, ratio, takes_prior):
    """ransac_pnp(fast_path_ratio > 0) against JAX's lax.cond, with the
    JAX samples injected: the refined prior explains ~75% of the valid
    matches, so at 0.3 both take it and at 0.8 both run the hypotheses.
    Inliers equal, the pose within 1e-4."""
    s = contaminated
    key = jax.random.PRNGKey(4)
    valid = jnp.asarray(s["valid"])
    samples = to_t(np.asarray(jr.sample_masked(key, valid, 32, 6)))
    prior_r = (s["rvec1"] + 0.01).astype(np.float32)
    prior_t = (s["t1"] + 0.02).astype(np.float32)
    kw = dict(n_hypotheses=32, sample_size=6, threshold=7.0,
              refine_iters=6, min_inliers=5)

    def jax_pnp(r):
        return jr.ransac_pnp(key, jnp.asarray(TEST_K), jnp.asarray(s["X"]),
                             jnp.asarray(s["uv1n"]), valid,
                             prior_rvec=jnp.asarray(prior_r),
                             prior_tvec=jnp.asarray(prior_t),
                             fast_path_ratio=r, **kw)

    def port_pnp(r):
        return ransac.ransac_pnp(None, to_t(TEST_K), to_t(s["X"]),
                                 to_t(s["uv1n"]), to_t(s["valid"]),
                                 prior_rvec=to_t(prior_r),
                                 prior_tvec=to_t(prior_t), samples=samples,
                                 fast_path_ratio=r, **kw)

    ref, ours = jax_pnp(ratio), port_pnp(ratio)
    np.testing.assert_allclose(to_np(ours.rvec), np.asarray(ref.rvec),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(ours.tvec), np.asarray(ref.tvec),
                               atol=1e-4)
    np.testing.assert_array_equal(to_np(ours.inliers),
                                  np.asarray(ref.inliers))
    assert int(ours.n_inliers) == int(ref.n_inliers)
    assert bool(ours.ok) and bool(ref.ok)
    # the branch each took.  A ratio near 0 always takes the refined prior,
    # a ratio of 0 never does.  JAX's lax.cond takes it when the refined
    # prior's inliers reach the ratio of the valid matches (its predicate);
    # the port's result is that branch's bit for bit, and the branches
    # differ in the last bits (both refine onto the same inliers)
    fast_j = jax_pnp(1e-6)
    fast_t, full_t = port_pnp(1e-6), port_pnp(0.0)
    n_f = int(fast_j.n_inliers)
    assert n_f == int(fast_t.n_inliers)
    assert (n_f >= ratio * int(s["valid"].sum())) == takes_prior
    assert not torch.equal(fast_t.tvec, full_t.tvec)
    for a, b in zip(ours, fast_t if takes_prior else full_t):
        assert torch.equal(a, b)
