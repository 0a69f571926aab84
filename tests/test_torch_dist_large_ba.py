"""The port's landmark-sharded implicit-Schur BA
(``parallel.dist_large_ba``) against the JAX package's, on
tests/test_parallel.py's scenes (the JAX solver on 4 or 8 virtual CPU
devices, the port on as many gloo ranks spawned on the CPU) and against
the port's own ``run_large_ba``; ``partition_tables`` equal to JAX's bit
for bit; and ``run_large_ba`` unchanged bit for bit by the loop it now
shares with the distributed solver."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from synthetic import DEFAULT_K, project_np, rodrigues_np
from test_ba import make_ba_scene
from torch_port_util import (TEST_K, ba_scene, dist_solver_worker,
                             load_ranks, spawn_ranks, to_np, to_t)

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.parallel.dist_large_ba import build_dist_large_ba as jbuild
from sfm_tpu.parallel.dist_large_ba import partition_tables as jpartition
from sfm_tpu_torch.ba import large
from sfm_tpu_torch.ba.core import BAStats, _damp, _inv
from sfm_tpu_torch.ba.residuals import Observations
from sfm_tpu_torch.parallel import partition_tables


def _mesh(n):
    import jax
    return Mesh(np.array(jax.devices()[:n]), ("map",))


def _tobs(obs):
    return Observations(*map(to_t, obs))


def _parity_problem():
    """test_parallel's parity scene: 4 cameras, 64 landmarks."""
    rng = np.random.default_rng(0)
    K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=4, n_pts=64)
    rv0 = np.asarray(rvec).copy()
    rv0[1:] += 0.01
    return dict(K=np.asarray(K), rv=rv0, tv=np.asarray(tvec),
                X=np.asarray(X) + 0.03, cam_free=np.arange(4) > 0,
                lm_free=np.ones(64, bool),
                obs=tuple(np.asarray(o) for o in obs))


def _eight_problem():
    """test_parallel's 8-shard scene: 10 cameras, 320 landmarks, 160 each."""
    rng = np.random.default_rng(0)
    n_cams, n_pts = 10, 320
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(6, 12, n_pts)], 1).astype(np.float32)
    cam_idx, lm_idx, uvs, rvs, tvs = [], [], [], [], []
    for c in range(n_cams):
        rv = rng.uniform(-0.02, 0.02, 3).astype(np.float32)
        tv = np.array([0.2 * c, 0, 0], np.float32)
        rvs.append(rv)
        tvs.append(tv)
        sel = rng.choice(n_pts, 160, replace=False)
        uvs.append(project_np(DEFAULT_K, rodrigues_np(rv), tv,
                              X[sel]).astype(np.float32))
        cam_idx.append(np.full(160, c))
        lm_idx.append(sel)
    rv0 = np.stack(rvs)
    rv0[1:] += 0.01
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return dict(K=DEFAULT_K, rv=rv0, tv=np.stack(tvs), X=X0,
                cam_free=np.arange(n_cams) > 0,
                lm_free=np.ones(n_pts, bool),
                obs=(np.concatenate(cam_idx).astype(np.int32),
                     np.concatenate(lm_idx).astype(np.int32),
                     np.concatenate(uvs), np.ones(n_cams * 160,
                                                  np.float32))), \
        np.stack(rvs)


def _port_job(name, p, n, nmax, kmax, **kw):
    C, L = p["rv"].shape[0], p["X"].shape[0]
    tabs, shard = partition_tables(_tobs(p["obs"]), C, L, n, nmax, kmax)
    return (name, "large", dict(n_cams=C, shard_size=shard, **kw),
            dict(p, tables=tuple(to_np(t) for t in tabs)))


def _jax_dist(p, n, nmax, kmax, **kw):
    C, L = p["rv"].shape[0], p["X"].shape[0]
    tabs, shard = jpartition(JObs(*map(jnp.asarray, p["obs"])), C, L, n,
                             nmax, kmax)
    fn = jbuild(_mesh(n), "map", n_cams=C, shard_size=shard, **kw)
    out = fn(*(jnp.asarray(p[k]) for k in ("K", "rv", "tv", "X")), tabs,
             jnp.asarray(p["cam_free"]), jnp.asarray(p["lm_free"]))
    return [np.asarray(o) for o in out[:3]], out[3]


def _gathered(ranks):
    for r in ranks[1:]:
        for k in ("rv", "tv", "final_cost", "accepted"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
    order = sorted(ranks, key=lambda r: int(r["map_rank"]))
    return ranks[0], np.concatenate([r["X"] for r in order])


# (n_shards, nmax, kmax): no overflow; the camera-major rows overflow;
# both tables overflow; 64 landmarks in 5 shards (4 in none)
@pytest.mark.parametrize("n_shards,nmax,kmax", [
    (4, 64, 4), (4, 10, 4), (4, 10, 2), (5, 64, 4)])
def test_partition_tables_equal_jax(n_shards, nmax, kmax):
    obs = ba_scene(np.random.default_rng(3), 4, 64, 4, dead_p=0.1)[2]
    ours, shard = partition_tables(_tobs(obs), 4, 64, n_shards, nmax, kmax)
    ref, shard_j = jpartition(JObs(*map(jnp.asarray, obs)), 4, 64,
                              n_shards, nmax, kmax)
    assert shard == shard_j
    assert ours.lm_cam.shape[0] == n_shards
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_partition_tables_on_a_device():
    """The vectorised build equals the host build where nothing overflows,
    and raises where an observation would be dropped."""
    obs = ba_scene(np.random.default_rng(3), 4, 64, 4, dead_p=0.1)[2]
    host, shard = partition_tables(_tobs(obs), 4, 64, 4, 64, 4)
    dev, shard_d = partition_tables(_tobs(obs), 4, 64, 4, 64, 4,
                                    device="cpu")
    assert shard == shard_d
    for a, b in zip(dev, host):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="drops"):
        partition_tables(_tobs(obs), 4, 64, 4, 10, 4, device="cpu")


def test_four_ranks_equal_jax_and_run_large_ba(tmp_path):
    """test_parallel's parity scene (10 LM x 40 CG) on 4 ranks: against
    JAX's solver on 4 devices and against the port's own run_large_ba
    (tol 0) on the whole problem, at test_parallel's limits; every rank
    with the same poses bit for bit."""
    p = _parity_problem()
    kw = dict(iterations=10, cg_iterations=40)
    spawn_ranks(dist_solver_worker, 4,
                (tmp_path, [_port_job("four", p, 4, 64, 4, **kw)]), tmp_path)
    r0, X = _gathered(load_ranks(tmp_path, "four", 4))
    assert float(r0["final_cost"]) < 1e-2
    (rv_j, _, X_j), _ = _jax_dist(p, 4, 64, 4, **kw)
    np.testing.assert_allclose(r0["rv"], rv_j, atol=1e-3)
    np.testing.assert_allclose(X, X_j, atol=5e-3)
    tables = large.build_tables(_tobs(p["obs"]), 4, 64, 64, 4)
    rv_s, _, X_s, _ = large.run_large_ba(
        *(to_t(p[k]) for k in ("K", "rv", "tv", "X")), tables,
        cam_free=to_t(p["cam_free"]), lm_free=to_t(p["lm_free"]), tol=0.0,
        **kw)
    np.testing.assert_allclose(r0["rv"], to_np(rv_s), atol=1e-3)
    np.testing.assert_allclose(X, to_np(X_s), atol=5e-3)


def test_converges_on_eight_ranks(tmp_path):
    """test_parallel's 8-shard convergence case on 8 ranks, at its limits,
    beside the JAX solver on 8 devices."""
    p, truth = _eight_problem()
    kw = dict(iterations=10, cg_iterations=30)
    spawn_ranks(dist_solver_worker, 8,
                (tmp_path, [_port_job("eight", p, 8, 160, 8, **kw)]),
                tmp_path)
    r0, X = _gathered(load_ranks(tmp_path, "eight", 8))
    assert float(r0["final_cost"]) < 1e-3 * float(r0["initial_cost"])
    np.testing.assert_allclose(r0["rv"], truth, atol=2e-3)
    (rv_j, _, X_j), _ = _jax_dist(p, 8, 160, 8, **kw)
    np.testing.assert_allclose(r0["rv"], rv_j, atol=1e-3)
    np.testing.assert_allclose(X, X_j, atol=5e-3)


def _run_large_ba_before(K, rvec, tvec, xyz, tables, *, cam_free, lm_free,
                         iterations, cg_iterations, lam0=1e-3, lam_up=4.0,
                         lam_down=2.0, huber_delta=0.0, tol=1e-4):
    """run_large_ba's loop as it stood before it was shared with the
    distributed solver (the body verbatim)."""
    C = rvec.shape[0]
    cam_free_f = cam_free.to(torch.float32)
    lm_free_f = lm_free.to(torch.float32)
    lm_cam = tables.lm_cam.to(torch.int32).contiguous()
    lm_uv = tables.lm_uv.contiguous()
    lm_w = tables.lm_w.contiguous()
    K = K.contiguous()
    eye6 = torch.eye(6, dtype=xyz.dtype, device=xyz.device)
    cslots = large.camera_slots(lm_cam, lm_w, C)

    def linearize(rvec, tvec, xyz):
        *blocks, cost = large.ba_linearize(
            K, large.exp_so3(rvec).contiguous(), tvec.contiguous(),
            xyz.contiguous(), lm_free_f, cam_free_f, lm_cam, lm_uv, lm_w,
            huber_delta, slots=cslots)
        return blocks, cost

    blocks, cost = linearize(rvec, tvec, xyz)
    cost0 = cost
    lam, accepted = lam0, 0
    for _ in range(iterations):
        W, V, g_lm, U, g_cam = blocks
        Ud = _damp(U, lam)
        op = large.SchurOperator(W, lm_cam, large.damped_vinv(V, lam),
                                 cslots)

        def matvec(x):
            return (Ud @ x[:, :, None])[..., 0] - op.w_vinv_wt_x(x)

        rhs = g_cam - op.w_vinv_g(g_lm, C)
        d_cam = large._pcg(matvec, _inv(Ud + 1e-6 * eye6), rhs,
                           cg_iterations)
        d_cam = d_cam * cam_free_f[:, None]
        d_lm = op.back_substitute(g_lm, d_cam) * lm_free_f[:, None]
        rv_new, tv_new = large.apply_pose_update(rvec, tvec, d_cam[:, :3],
                                                 d_cam[:, 3:])
        xyz_new = xyz + d_lm
        blocks_new, new_cost = linearize(rv_new, tv_new, xyz_new)
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        done = ok & (cost - new_cost < tol * torch.clamp(cost, min=1.0))
        ok, done = torch.stack([ok, done]).tolist()
        if ok:
            rvec, tvec, xyz, blocks, cost = (rv_new, tv_new, xyz_new,
                                             blocks_new, new_cost)
            lam = max(lam / lam_down, 1e-9)
            accepted += 1
        else:
            lam = min(lam * lam_up, 1e6)
        if done:
            break
    return rvec, tvec, xyz, BAStats(cost0, cost, torch.tensor(lam),
                                    torch.tensor(accepted))


@pytest.mark.parametrize("huber,tol", [(0.0, 1e-4), (2.0, 0.0)])
def test_run_large_ba_unchanged_bit_for_bit(huber, tol):
    rng = np.random.default_rng(5)
    _, init, obs = ba_scene(rng, 8, 120, 5, noise_px=0.5, outlier_p=0.04,
                            dead_p=0.05, min_obs=2)
    tables = large.build_tables(_tobs(obs), 8, 120, 120, 5)
    args = (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
            to_t(init["X"]), tables)
    kw = dict(cam_free=torch.arange(8) > 1, lm_free=torch.ones(120, dtype=bool),
              iterations=8, cg_iterations=15, huber_delta=huber, tol=tol)
    ours = large.run_large_ba(*args, **kw)
    ref = _run_large_ba_before(*args, **kw)
    for a, b in zip(ours[:3], ref[:3]):
        assert torch.equal(a, b)
    for a, b in zip(ours[3][:4], ref[3][:4]):
        assert float(a) == float(b)
