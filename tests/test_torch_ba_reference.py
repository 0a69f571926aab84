"""The f64 reference solver's port copy (``sfm_tpu_torch/ba/reference.py``,
numpy on the host) against the JAX package's, bit for bit, and the port's
solvers against it: tests/test_ba_reference.py's ``TestSolverParity`` on
the port (final cost within 1% of the reference's, free rvecs within
2e-3 and tvecs within 5e-3), on that file's 4x60 perturbed scene and its
10x300 medium scene, both made by chip_smoke.py's anchor phase (in numpy:
the 4x60 scene equals the test file's bit for bit here), and on the
anchor phase's problem at FLAGSHIP's BA width cut to 8 x 256 (its
construction, fewer cameras and landmarks)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_port_util import to_np, to_t

from sfm_tpu.ba import reference as jref
from sfm_tpu_torch.ba import reference as ref
from sfm_tpu_torch.ba.residuals import Observations
from test_ba_reference import _perturbed_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problems(smoke):
    return smoke.anchor_problems(wide=(8, 256, 8))


@pytest.fixture(scope="module")
def references(smoke, problems):
    return smoke.anchor_references(problems)


def test_the_anchor_scene_is_the_test_files(problems):
    """chip_smoke's numpy 4x60 scene equals tests/test_ba_reference.py's
    (made with JAX arrays) bit for bit."""
    K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(
        np.random.default_rng(0))
    p = problems["4x60"]
    for a, b in ((p["K"], K), (p["rv"], rv0), (p["tv"], tv0), (p["X"], X0),
                 (p["cam_free"], cam_free), (p["lm_free"], lm_free)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(p["obs"], obs):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_rotations_equal_jax():
    rng = np.random.default_rng(1)
    for w in [*rng.normal(0, 1.0, (10, 3)), np.zeros(3), np.full(3, 1e-13),
              np.array([0.0, 0.0, np.pi - 1e-8])]:
        np.testing.assert_array_equal(ref._exp_so3(w), jref._exp_so3(w))
        R = jref._exp_so3(w)
        np.testing.assert_array_equal(ref._log_so3(R), jref._log_so3(R))
        np.testing.assert_array_equal(ref._hat(w), jref._hat(w))


@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_linearize_and_cost_equal_jax(problems, huber):
    p = problems["10x300 medium"]
    K = np.asarray(p["K"], np.float64)
    Rs = np.stack([ref._exp_so3(r) for r in p["rv"]])
    ci, li, uv, w = (np.asarray(a) for a in p["obs"])
    args = (K, Rs, p["tv"], p["X"], ci, li, uv.astype(np.float64),
            w.astype(np.float64), huber)
    for a, b in zip(ref._linearize(*args), jref._linearize(*args)):
        np.testing.assert_array_equal(a, b)
    cargs = (K, p["rv"], p["tv"], p["X"], ci, li, uv, w, huber)
    assert ref._cost_only(*cargs) == jref._cost_only(*cargs)


@pytest.mark.parametrize("obs_as", ["numpy", "torch"])
def test_reference_ba_obs_equals_jax(obs_as):
    """``reference_ba_obs`` on the 4x60 scene, given the port's
    Observations of torch tensors (or numpy arrays), equals JAX's on its
    own scene bit for bit."""
    K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(
        np.random.default_rng(0))
    kw = dict(cam_free=cam_free, lm_free=lm_free, iterations=40, tol=1e-10)
    theirs = jref.reference_ba_obs(K, rv0, tv0, X0, obs, **kw)
    arrays = [np.asarray(a) for a in obs]
    mine = Observations(*(map(to_t, arrays) if obs_as == "torch"
                          else arrays))
    ours = ref.reference_ba_obs(to_t(np.asarray(K)), to_t(np.asarray(rv0)),
                                to_t(np.asarray(tv0)), to_t(np.asarray(X0)),
                                mine, **kw)
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == theirs[3]
    assert len(ours[3]) > 3 and ours[3][-1] < 0.1 * ours[3][0]


def test_reference_self_consistency(smoke):
    """tests/test_ba_reference.py's ``TestReferenceSelfConsistency`` on the
    copy: a noiseless scene to zero, and the accepted costs monotone."""
    for noise_px in (0.0, 0.5):
        p = smoke.anchor_small(np.random.default_rng(0), noise_px=noise_px)
        _, _, _, costs = ref.reference_ba(
            p["K"], p["rv"], p["tv"], p["X"], *p["obs"],
            cam_free=p["cam_free"], lm_free=p["lm_free"], iterations=40,
            tol=1e-10)
        assert all(b < a for a, b in zip(costs, costs[1:]))
        if noise_px == 0.0:
            assert costs[-1] < 1e-10 * costs[0]


@pytest.mark.parametrize("problem", ["4x60", "10x300 medium", "8x256 kmax 8"])
@pytest.mark.parametrize("solver", ["run_ba", "run_ba_cg",
                                    "run_large_ba jacobi_u",
                                    "run_large_ba schur_diag"])
def test_solver_parity(smoke, problems, references, problem, solver):
    """Each port solver on the CPU reaches the f64 reference's optimum:
    final cost within 1%, free poses within 2e-3 rad and 5e-3 (the JAX
    test's bounds, chip_smoke's anchor gates)."""
    torch.manual_seed(0)
    p = problems[problem]
    rv, tv, cost, _ = smoke.anchor_solve(torch, "cpu", p, solver)
    (rv_ref, tv_ref, _, costs), _ = references[problem]
    assert abs(cost - costs[-1]) <= smoke.ANCHOR_COST_RTOL * costs[-1], \
        f"final cost {cost:.6g} vs reference {costs[-1]:.6g}"
    free = p["cam_free"]
    assert not free.all()
    np.testing.assert_allclose(rv[free], rv_ref[free],
                               atol=smoke.ANCHOR_RVEC_ATOL)
    np.testing.assert_allclose(tv[free], tv_ref[free],
                               atol=smoke.ANCHOR_TVEC_ATOL)
    # the frozen cameras stay where they started
    np.testing.assert_allclose(rv[~free], p["rv"][~free], atol=1e-6)
    np.testing.assert_allclose(tv[~free], p["tv"][~free], atol=1e-6)


def test_anchor_phase_rehearsed(smoke, problems, references):
    """chip_smoke's anchor phase on the CPU (no launch counts there): the
    port's solvers against the references on the cut problems, then
    schur_diag beside jacobi_u on a small bench_ba problem, whose rerun
    must repeat bit for bit, as jacobi_u's must."""
    from sfm_tpu_torch.ba.large import run_large_ba
    pr = smoke.ba_problem(torch, "cpu", 40, 2000, 4)

    def bench_once(precond="jacobi_u"):
        return run_large_ba(pr["K"], pr["rv"], pr["tv"], pr["X"],
                            pr["tables"], cam_free=pr["cam_free"],
                            lm_free=pr["lm_free"], iterations=4,
                            cg_iterations=25, tol=0.0, precond=precond)

    out = smoke.run_anchor(torch, "cpu", bench_once, problems,
                           lambda: references, bench_iterations=4,
                           kernels=())
    assert len(out["rows"]) == 3 * len(smoke.ANCHOR_SOLVERS)
    assert all(r["cost_rel"] <= 0.01 for r in out["rows"].values())
    b = out["bench_ba"]
    assert list(b) == ["jacobi_u", "schur_diag", "schur_diag rerun",
                       "jacobi_u rerun"]
    assert b["schur_diag"]["final_cost"] == b["schur_diag rerun"]["final_cost"]
    assert b["jacobi_u"]["final_cost"] == b["jacobi_u rerun"]["final_cost"]
    assert b["schur_diag"]["final_cost"] < b["schur_diag"]["initial_cost"]
