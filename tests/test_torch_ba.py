"""The dense-Schur LM bundle adjustment against the JAX package's run_ba on
a seeded problem (both must converge to the same solution), and the
observation / compaction helpers (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import TEST_K, to_np, to_t

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.ba import core as jcore
from sfm_tpu.mapstore import Frame as JFrame, KeyframeStore as JKfs
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.ba.residuals import Observations
from sfm_tpu_torch.mapstore import Frame, KeyframeStore
from sfm_tpu_torch.np_geometry import project_np, rodrigues_np

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
