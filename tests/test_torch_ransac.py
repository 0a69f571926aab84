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
