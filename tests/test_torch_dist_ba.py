"""The port's landmark-sharded dense BA (``parallel.dist_ba``) against the
JAX package's, on tests/test_parallel.py's scenes: the JAX solver on 4 or
8 virtual CPU devices in this process, the port on as many gloo ranks
spawned on the CPU.  ``partition_observations`` is held equal bit for
bit, overflow included."""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from test_ba import make_ba_scene
from torch_port_util import (dist_solver_worker, load_ranks, spawn_ranks,
                             to_np, to_t)

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.parallel import build_dist_ba as jbuild_dist_ba
from sfm_tpu.parallel import partition_observations as jpartition
from sfm_tpu_torch.ba.residuals import Observations
from sfm_tpu_torch.parallel import partition_observations


def _mesh(n):
    import jax
    return Mesh(np.array(jax.devices()[:n]), ("map",))


def _problem(rng, n_cams, n_pts, drv, dX):
    """make_ba_scene's scene with the gauge camera 0 frozen, the other
    poses moved by drv and every landmark by dX (numpy)."""
    K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=n_cams, n_pts=n_pts)
    rv0 = np.asarray(rvec).copy()
    rv0[1:] += drv
    cam_free = np.arange(n_cams) > 0
    return dict(K=np.asarray(K), rv=rv0, tv=np.asarray(tvec),
                X=np.asarray(X) + dX, cam_free=cam_free,
                lm_free=np.ones(n_pts, bool),
                obs=tuple(np.asarray(o) for o in obs)), np.asarray(rvec)


def _jax_dist(p, n, n_pts, cap, **kw):
    obs_sh, shard = jpartition(JObs(*map(jnp.asarray, p["obs"])), n_pts, n,
                               cap)
    fn = jbuild_dist_ba(_mesh(n), "map", n_cams=p["rv"].shape[0],
                        shard_size=shard, **kw)
    out = fn(*(jnp.asarray(p[k]) for k in ("K", "rv", "tv", "X")), obs_sh,
             jnp.asarray(p["cam_free"]), jnp.asarray(p["lm_free"]))
    return [np.asarray(o) for o in out[:3]], out[3]


def _port_job(name, p, n, n_pts, cap, **kw):
    obs_sh, shard = partition_observations(
        Observations(*map(to_t, p["obs"])), n_pts, n, cap)
    args = dict(p, obs=tuple(to_np(o) for o in obs_sh))
    return (name, "dense", dict(n_cams=p["rv"].shape[0], shard_size=shard,
                                **kw), args)


def _gathered(ranks):
    """rvec / tvec of rank 0 (after holding every rank's equal to it bit
    for bit) and the landmarks of all shards in mesh order."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["rv"], ranks[0]["rv"])
        np.testing.assert_array_equal(r["tv"], ranks[0]["tv"])
        np.testing.assert_array_equal(r["final_cost"], ranks[0]["final_cost"])
    order = sorted(ranks, key=lambda r: int(r["map_rank"]))
    return ranks[0], np.concatenate([r["X"] for r in order])


@pytest.mark.parametrize("n_lms,n_shards,cap", [
    (64, 4, 128),    # test_parallel's partition
    (64, 4, 40),     # every bucket over its cap
    (64, 5, 64),     # 64 landmarks do not split in 5: 4 fall in no shard
])
def test_partition_observations_equal_jax(n_lms, n_shards, cap):
    rng = np.random.default_rng(0)
    _, _, _, _, obs = make_ba_scene(rng, n_cams=4, n_pts=n_lms)
    w = np.asarray(obs.w).copy()
    w[rng.uniform(0, 1, w.shape) < 0.1] = 0     # dead observations too
    obs_np = tuple(np.asarray(o) for o in obs[:3]) + (w,)
    ours, shard = partition_observations(
        Observations(*map(to_t, obs_np)), n_lms, n_shards, cap)
    ref, shard_j = jpartition(JObs(*map(jnp.asarray, obs_np)), n_lms,
                              n_shards, cap)
    assert shard == shard_j
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    if cap == 40:
        assert (to_np(ours.w) > 0).sum() == n_shards * cap
    if n_shards == 5:
        assert (to_np(ours.w) > 0).sum() < (w > 0).sum()


def test_four_ranks_equal_jax_four_devices(tmp_path):
    """test_parallel's parity scene (12 iterations) at huber_delta 0 and
    0.5 (where the cost is the JAX package's sum w |r|^2 under the IRLS
    weights, not robust_cost), 4 ranks against 4 devices."""
    rng = np.random.default_rng(0)
    p, _ = _problem(rng, 4, 64, 0.01, 0.03)
    p["rv"][0] += 0.01      # test_parallel moves the gauge camera too
    jobs, refs = [], {}
    for name, huber in (("plain", 0.0), ("huber", 0.5)):
        jobs.append(_port_job(name, p, 4, 64, 128, iterations=12,
                              huber_delta=huber))
        refs[name] = _jax_dist(p, 4, 64, 128, iterations=12,
                               huber_delta=huber)
    spawn_ranks(dist_solver_worker, 4, (tmp_path, jobs), tmp_path)
    for name, ((rv_j, tv_j, X_j), st_j) in refs.items():
        r0, X = _gathered(load_ranks(tmp_path, name, 4))
        np.testing.assert_allclose(r0["rv"], rv_j, atol=1e-4)
        np.testing.assert_allclose(r0["tv"], tv_j, atol=1e-4)
        np.testing.assert_allclose(X, X_j, atol=1e-3)
        c, c_j = float(r0["final_cost"]), float(st_j.final_cost)
        assert abs(c - c_j) <= 1e-3 * max(c_j, 1.0), (name, c, c_j)
        assert float(r0["initial_cost"]) == pytest.approx(
            float(st_j.initial_cost), rel=1e-5)


def test_converges_on_eight_ranks(tmp_path):
    """test_parallel's 8-device convergence case on 8 ranks, at its
    limits, beside the JAX solver on 8 devices."""
    rng = np.random.default_rng(0)
    p, truth = _problem(rng, 6, 160, 0.02, 0.05)
    spawn_ranks(dist_solver_worker, 8,
                (tmp_path, [_port_job("eight", p, 8, 160, 256,
                                      iterations=15)]), tmp_path)
    r0, X = _gathered(load_ranks(tmp_path, "eight", 8))
    assert float(r0["final_cost"]) < 1e-2 * float(r0["initial_cost"])
    np.testing.assert_allclose(r0["rv"], truth, atol=5e-3)
    (rv_j, _, _), _ = _jax_dist(p, 8, 160, 256, iterations=15)
    np.testing.assert_allclose(r0["rv"], rv_j, atol=1e-4)
