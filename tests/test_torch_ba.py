"""The dense-Schur LM bundle adjustment against the JAX package's run_ba on
a seeded problem (both must converge to the same solution), and the
observation / compaction helpers (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, to_np, to_t

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.ba import core as jcore
from sfm_tpu.mapstore import Frame as JFrame, KeyframeStore as JKfs
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.ba.residuals import Observations, apply_pose_update
from sfm_tpu_torch.mapstore import Frame, KeyframeStore
from sfm_tpu_torch.np_geometry import project_np, rodrigues_np
from sfm_tpu_torch.utils.rowsum import RowSum

C, L = 4, 60


def _problem(seed):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-2, 2, L),
                  rng.uniform(4, 8, L)], 1)
    rv = np.concatenate([np.zeros((1, 3)),
                         rng.uniform(-0.05, 0.05, (C - 1, 3))])
    tv = np.concatenate([np.zeros((1, 3)),
                         np.stack([np.linspace(0.3, 0.9, C - 1),
                                   rng.uniform(-.05, .05, C - 1),
                                   rng.uniform(-.05, .05, C - 1)], 1)])
    cam_idx = np.repeat(np.arange(C), L)
    lm_idx = np.tile(np.arange(L), C)
    uv = np.concatenate([project_np(TEST_K, rodrigues_np(rv[c]), tv[c], X)
                         for c in range(C)])
    uv = uv + rng.normal(0, 0.5, uv.shape)
    uv[rng.uniform(0, 1, len(uv)) < 0.03] += 25.0   # a few outliers
    w = (rng.uniform(0, 1, len(uv)) < 0.9).astype(np.float32)
    f = np.float32
    init = dict(rv=(rv + rng.normal(0, 0.01, rv.shape)).astype(f),
                tv=(tv + rng.normal(0, 0.02, tv.shape)).astype(f),
                X=(X + rng.normal(0, 0.05, X.shape)).astype(f))
    init["rv"][0] = 0.0
    init["tv"][0] = 0.0
    obs = (cam_idx.astype(np.int32), lm_idx.astype(np.int32),
           uv.astype(f), w)
    cam_free = np.arange(C) > 0
    lm_free = np.ones(L, bool)
    lm_free[:3] = False
    return init, obs, cam_free, lm_free


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_run_ba_matches_jax(huber):
    init, obs, cam_free, lm_free = _problem(0)
    kw = dict(iterations=10, lam0=1e-3, lam_up=4.0, lam_down=2.0,
              huber_delta=huber, tol=3e-4)
    rj, tj, xj, sj = jcore.run_ba(
        jnp.asarray(TEST_K), jnp.asarray(init["rv"]), jnp.asarray(init["tv"]),
        jnp.asarray(init["X"]), JObs(*[jnp.asarray(o) for o in obs]),
        cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free), **kw)
    tobs = Observations(to_t(obs[0]).long(), to_t(obs[1]).long(),
                        to_t(obs[2]), to_t(obs[3]))
    rt, tt, xt, st = core.run_ba(
        to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]), to_t(init["X"]),
        tobs, cam_free=to_t(cam_free), lm_free=to_t(lm_free), **kw)
    # both converge: the cost drops by the same large factor
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    # same solution; tolerances are f32 normal equations summed in another
    # order (1e-4 rad, 1e-3 m)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-3)
    # frozen parameters stay put
    np.testing.assert_array_equal(to_np(rt)[0], init["rv"][0])
    np.testing.assert_array_equal(to_np(xt)[:3], init["X"][:3])


def test_observations_and_compaction():
    rng = np.random.default_rng(1)
    Kn, N, Ln = 3, 10, 40
    fields = dict(
        xy=rng.uniform(0, 300, (Kn, N, 2)).astype(np.float32),
        xy_dist=np.zeros((Kn, N, 2), np.float32),
        desc=np.zeros((Kn, N, 16), np.uint32),
        color=np.zeros((Kn, N, 3), np.float32),
        level=np.zeros((Kn, N), np.int32),
        score=np.zeros((Kn, N), np.float32),
        kp_valid=rng.uniform(0, 1, (Kn, N)) < 0.9,
        landmark=np.where(rng.uniform(0, 1, (Kn, N)) < 0.7,
                          rng.integers(0, Ln, (Kn, N)), -1).astype(np.int32),
        rvec=np.zeros((Kn, 3), np.float32), tvec=np.zeros((Kn, 3), np.float32),
        frame_no=np.arange(Kn, dtype=np.int32))
    kvalid = np.array([True, False, True])
    lm_valid = rng.uniform(0, 1, Ln) < 0.6
    kj = JKfs(JFrame(**{k: jnp.asarray(v) for k, v in fields.items()}),
              jnp.asarray(kvalid))
    kt = KeyframeStore(Frame(**{k: to_t(v) for k, v in fields.items()}),
                       to_t(kvalid))
    oj = jcore.observations_from_keyframes(kj, jnp.asarray(lm_valid))
    ot = core.observations_from_keyframes(kt, to_t(lm_valid))
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    xyz = rng.normal(0, 1, (Ln, 3)).astype(np.float32)
    for cap in (8, 64):
        cj = jcore.compact_ba_problem(jnp.asarray(xyz), jnp.asarray(lm_valid),
                                      oj, cap)
        ct = core.compact_ba_problem(to_t(xyz), to_t(lm_valid), ot, cap)
        for a, b in ((ct[0], cj[0]), (ct[1], cj[1]), (ct[3], cj[3])):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
        for a, b in zip(ct[2], cj[2]):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
        moved = (ct[0] + 1.0)
        np.testing.assert_array_equal(
            to_np(core.scatter_back_landmarks(to_t(xyz), moved, ct[3])),
            np.asarray(jcore.scatter_back_landmarks(
                jnp.asarray(xyz), jnp.asarray(to_np(moved)), cj[3])))


def _both_problems(seed):
    init, obs, cam_free, lm_free = _problem(seed)
    jargs = (jnp.asarray(TEST_K), jnp.asarray(init["rv"]),
             jnp.asarray(init["tv"]), jnp.asarray(init["X"]),
             JObs(*[jnp.asarray(o) for o in obs]))
    targs = (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
             to_t(init["X"]),
             Observations(to_t(obs[0]).long(), to_t(obs[1]).long(),
                          to_t(obs[2]), to_t(obs[3])))
    return init, jargs, targs, cam_free, lm_free


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_total_cost_matches_jax(huber):
    """rtol 1e-5; at the problem's start and at its true poses."""
    from sfm_tpu.ba import residuals as jres
    from sfm_tpu_torch.ba import residuals
    _, jargs, targs, _, _ = _both_problems(0)
    ours = residuals.total_cost(*targs, huber_delta=huber)
    ref = jres.total_cost(*jargs, huber_delta=huber)
    assert ours.dtype == torch.float32 and ours.shape == ()
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    # the solver's own cost on the same point
    _, cost = core._assemble_cg(*targs, torch.ones(C), torch.ones(L), huber,
                                core._Sums.of(targs[4], C, L))
    np.testing.assert_allclose(float(ours), float(cost), rtol=1e-6)


@pytest.mark.parametrize("huber", [0.0, 2.0])
@pytest.mark.parametrize("mode", ["POSE_ONLY", "STRUCT_ONLY",
                                  "STRUCT_AND_POSE"])
def test_run_ba_modes_match_jax(mode, huber):
    """run_ba(mode=...) against JAX's at the existing run_ba parity's
    tolerances (final cost rtol 1e-3, rvec 1e-4, tvec and xyz 1e-3); the
    frozen block comes back bit for bit."""
    assert [int(m) for m in core.BAMode] == [int(m) for m in jcore.BAMode]
    assert [m.name for m in core.BAMode] == [m.name for m in jcore.BAMode]
    init, jargs, targs, cam_free, lm_free = _both_problems(0)
    kw = dict(iterations=10, lam0=1e-3, lam_up=4.0, lam_down=2.0,
              huber_delta=huber, tol=3e-4)
    rj, tj, xj, sj = jcore.run_ba(
        *jargs, cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free),
        mode=jcore.BAMode[mode], **kw)
    rt, tt, xt, st = core.run_ba(
        *targs, cam_free=to_t(cam_free), lm_free=to_t(lm_free),
        mode=core.BAMode[mode], **kw)
    assert float(st.final_cost) < float(st.initial_cost)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(to_np(tt), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), atol=1e-3)
    poses_moved = not (np.array_equal(to_np(rt), init["rv"])
                       and np.array_equal(to_np(tt), init["tv"]))
    lms_moved = not np.array_equal(to_np(xt), init["X"])
    if mode == "POSE_ONLY":
        np.testing.assert_array_equal(to_np(xt), init["X"])
        assert poses_moved
    elif mode == "STRUCT_ONLY":
        np.testing.assert_array_equal(to_np(rt), init["rv"])
        np.testing.assert_array_equal(to_np(tt), init["tv"])
        assert lms_moved
        # JAX passes its frozen cameras through a zero step of
        # apply_pose_update: log(exp(r)) moves them in the last bits
        assert 0 < np.abs(np.asarray(rj) - init["rv"]).max() < 1e-6
    else:
        assert poses_moved and lms_moved


def _lm_loop_before_modes(assemble, step, rvec, tvec, xyz, cam_free_f,
                          lm_free_f, *, iterations, lam0, lam_up, lam_down,
                          tol):
    """ba/core.py's _lm_loop as it was before run_ba took a mode, kept to
    hold run_ba(mode=STRUCT_AND_POSE) to its earlier iterates."""
    blocks, cost = assemble(rvec, tvec, xyz)
    cost0 = cost
    lam = torch.tensor(lam0, dtype=torch.float32, device=xyz.device)
    accepted = torch.zeros((), dtype=torch.int32, device=xyz.device)
    for _ in range(iterations):
        d_cam, d_lm = step(blocks, lam)
        d_cam = d_cam * cam_free_f[:, None]
        d_lm = d_lm * lm_free_f[:, None]
        rv_new, tv_new = apply_pose_update(rvec, tvec, d_cam[:, :3],
                                           d_cam[:, 3:])
        xyz_new = xyz + d_lm
        blocks_new, new_cost = assemble(rv_new, tv_new, xyz_new)
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        done = ok & (cost - new_cost < tol * torch.clamp(cost, min=1.0))
        rvec = torch.where(ok, rv_new, rvec)
        tvec = torch.where(ok, tv_new, tvec)
        xyz = torch.where(ok, xyz_new, xyz)
        blocks = tuple(torch.where(ok, n, o)
                       for n, o in zip(blocks_new, blocks))
        lam = torch.where(ok, torch.clamp(lam / lam_down, min=1e-9),
                          torch.clamp(lam * lam_up, max=1e6))
        cost = torch.where(ok, new_cost, cost)
        accepted = accepted + ok.to(torch.int32)
        if bool(done):
            break
    return rvec, tvec, xyz, core.BAStats(cost0, cost, lam, accepted)


def _run_ba_before_modes(K, rvec, tvec, xyz, obs, *, cam_free, lm_free,
                         iterations=20, lam0=1e-3, lam_up=4.0, lam_down=2.0,
                         huber_delta=0.0, tol=1e-4):
    """ba/core.py's run_ba as it was before it took a mode."""
    cam_free_f = cam_free.to(torch.float32)
    lm_free_f = lm_free.to(torch.float32)
    C_, L_ = rvec.shape[0], xyz.shape[0]
    sums = core._Sums.of(obs, C_, L_)
    pair_sum = RowSum(obs.cam_idx * L_ + obs.lm_idx, C_ * L_)
    return _lm_loop_before_modes(
        lambda rv, tv, X: core._assemble(K, rv, tv, X, obs, cam_free_f,
                                         lm_free_f, huber_delta, sums,
                                         pair_sum),
        lambda blocks, lam: core._solve_step(*blocks, lam),
        rvec, tvec, xyz, cam_free_f, lm_free_f, iterations=iterations,
        lam0=lam0, lam_up=lam_up, lam_down=lam_down, tol=tol)


@pytest.mark.parametrize("seed,huber", [(0, 0.0), (0, 2.0), (3, 2.0)])
def test_run_ba_full_unchanged_bit_for_bit(seed, huber):
    """The default mode gives the iterates of run_ba before modes existed,
    bit for bit (every output, the stats included)."""
    _, _, targs, cam_free, lm_free = _both_problems(seed)
    kw = dict(cam_free=to_t(cam_free), lm_free=to_t(lm_free), iterations=8,
              huber_delta=huber, tol=1e-6)
    ours = core.run_ba(*targs, **kw)
    before = _run_ba_before_modes(*targs, **kw)
    for a, b in zip(ours[:3] + tuple(ours[3][:4]),
                    before[:3] + tuple(before[3][:4])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(ours[3].accepted) >= 2
