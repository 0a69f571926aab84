"""K2's plain version (``sfm_tpu_torch.ba.linearize_pallas``) against the
JAX package's fused Pallas linearizer (interpret mode, tile 16, the exact
"bf16x3" precision) and against its XLA landmark-/camera-major blocks, at
kmax 4 and 16 with Huber weights and free masks; ``damped_vinv`` against
``damped_vinv_tiled``."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import (TEST_K, ba_scene, far_ba_problem,
                             gradient_distances, to_np, to_t)

from sfm_tpu.ba import Observations as JObs
from sfm_tpu.ba.large import (_blocks_cam_major, _blocks_lm_major,
                              build_tables)
from sfm_tpu.ba.linearize_pallas import (build_lin_tables, damped_vinv_tiled,
                                         fused_blocks)
from sfm_tpu.ba.schur_pallas import pack_lm_tiles, unpack_lm_tiles
from sfm_tpu.geometry.rotations import exp_so3 as jexp_so3
from sfm_tpu_torch.ba.linearize_pallas import (ba_linearize,
                                               ba_linearize_plain, damped_vinv)

# (cameras, landmarks, kmax, max observations per landmark, Huber delta,
# free masks): kmax 4 overflows some landmarks; kmax 16 has slots 8..15
# live (the TPU kernel once clamped slots >= 8 to row 7)
CASES = {"kmax4": (5, 70, 4, 5, 0.0, False),
         "kmax4-huber-masks": (5, 70, 4, 5, 1.5, True),
         "kmax16-huber-masks": (16, 40, 16, 14, 2.0, True)}


def _inputs(name):
    C, L, kmax, max_obs, huber, masks = CASES[name]
    rng = np.random.default_rng(len(name) + kmax)
    _, init, obs = ba_scene(rng, C, L, max_obs, noise_px=0.7, outlier_p=0.1,
                            dead_p=0.1)
    tables = build_tables(JObs(*map(jnp.asarray, obs)), C, L, nmax=4 * L,
                          kmax=kmax)
    cam_free = np.ones(C, np.float32)
    lm_free = np.ones(L, np.float32)
    if masks:
        cam_free[0] = 0.0
        lm_free[::7] = 0.0
    R = np.asarray(jexp_so3(jnp.asarray(init["rv"])))
    return dict(K=TEST_K, R=R, tv=init["tv"], X=init["X"], lm_free=lm_free,
                cam_free=cam_free, tables=tables, C=C, L=L, kmax=kmax,
                huber=huber)


def _port(p):
    t = p["tables"]
    return ba_linearize_plain(
        to_t(p["K"]), to_t(p["R"]), to_t(p["tv"]), to_t(p["X"]),
        to_t(p["lm_free"]), to_t(p["cam_free"]), to_t(t.lm_cam),
        to_t(t.lm_uv), to_t(t.lm_w), p["huber"])


def _close(a, b):
    """rtol 1e-4, atol 1e-5 of the largest entry: f32 sums taken in
    another order cancel on small entries (the JAX package's own parity
    test uses the same bound)."""
    a, b = to_np(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-5 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("name", list(CASES))
def test_k2_matches_fused_pallas(name):
    p = _inputs(name)
    t = p["tables"]
    lt = build_lin_tables(t.lm_cam, t.lm_uv, t.lm_w, p["C"], tile=16)
    wt, vg_t, U, g_cam, cost = fused_blocks(
        jnp.asarray(p["K"]), jnp.asarray(p["R"]), jnp.asarray(p["tv"]),
        jnp.asarray(p["X"]), jnp.asarray(p["lm_free"]),
        jnp.asarray(p["cam_free"]), lt, precision="bf16x3",
        huber_delta=p["huber"], interpret=True)
    L, kmax = p["L"], p["kmax"]
    # wt[iT, c, k*8 + r, j] = W[iT*16 + j, k, r, c]
    nT = wt.shape[0]
    W_j = np.asarray(wt).reshape(nT, 3, kmax, 8, 16).transpose(
        0, 4, 2, 3, 1).reshape(nT * 16, kmax, 8, 3)[:L, :, :6]
    V_j = np.asarray(unpack_lm_tiles(vg_t[:, :9], L)).reshape(L, 3, 3)
    g_j = np.asarray(unpack_lm_tiles(vg_t[:, 9:12], L))
    W, V, g_lm, U_t, g_cam_t, cost_t = _port(p)
    for a, b in ((W, W_j), (V, V_j), (g_lm, g_j), (U_t, U),
                 (g_cam_t, g_cam)):
        _close(a, b)
    np.testing.assert_allclose(float(cost_t), float(cost), rtol=1e-5)
    assert float(cost_t) > 0 and np.abs(W_j).max() > 0


@pytest.mark.parametrize("name", list(CASES))
def test_k2_matches_xla_blocks(name):
    """Against the XLA route's blocks (``_blocks_lm_major`` for W, V, g_lm
    and the cost, ``_blocks_cam_major`` for U and g_cam)."""
    p = _inputs(name)
    args = (jnp.asarray(p["K"]), jnp.asarray(p["R"]), jnp.asarray(p["tv"]),
            jnp.asarray(p["X"]), p["tables"], jnp.asarray(p["cam_free"]),
            jnp.asarray(p["lm_free"]), p["huber"])
    r, A, B, rw, w = _blocks_lm_major(*args)
    _, Ac, _, rwc, _ = _blocks_cam_major(*args)
    W_j = jnp.einsum("lkia,lkib->lkab", A, B)
    V_j = jnp.einsum("lkia,lkib->lab", B, B)
    g_j = -jnp.einsum("lkia,lki->la", B, rw)
    U_j = jnp.einsum("cnia,cnib->cab", Ac, Ac)
    gc_j = -jnp.einsum("cnia,cni->ca", Ac, rwc)
    cost_j = jnp.sum(jnp.sum(r * r, -1) * w)
    W, V, g_lm, U, g_cam, cost = _port(p)
    for a, b in ((W, W_j), (V, V_j), (g_lm, g_j), (U, U_j), (g_cam, gc_j)):
        _close(a, b)
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-5)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_k2_plain_keeps_a_far_cameras_near_points(seed):
    """A problem ~230 units from the world's origin at depths of 4-8 (a
    long scan's late keyframes): K2's g_lm and g_cam entry by entry within
    chip_smoke.py's GRAD_TOL of the plain version run in float64 (2^-17
    and 2^-20 of each entry's term magnitude).  With p = R X + t summed in
    float32 they read 3.7e-5 to 4.7e-5 and 1.0e-6 to 5.1e-6."""
    args = far_ba_problem(seed)
    _, _, g_lm, _, g_cam, _ = ba_linearize_plain(*args)
    d_lm, d_cam = gradient_distances(args, g_lm, g_cam)
    assert d_lm <= 2.0 ** -17 and d_cam <= 2.0 ** -20, (d_lm, d_cam)


def test_k2_dispatch_on_cpu_is_the_plain_version():
    p = _inputs("kmax4-huber-masks")
    t = p["tables"]
    args = (to_t(p["K"]), to_t(p["R"]), to_t(p["tv"]), to_t(p["X"]),
            to_t(p["lm_free"]), to_t(p["cam_free"]), to_t(t.lm_cam),
            to_t(t.lm_uv), to_t(t.lm_w), p["huber"])
    for a, b in zip(ba_linearize(*args), ba_linearize_plain(*args)):
        assert (a == b).all()


def test_damped_vinv_matches_tiled():
    rng = np.random.default_rng(0)
    L = 37
    Vs = rng.normal(0, 1, (L, 3, 3)).astype(np.float32)
    V = np.einsum("lab,lcb->lac", Vs, Vs) + np.eye(3, dtype=np.float32)
    V[5] = 0.0   # a dead landmark: the 1e-20 determinant floor's case
    lam = 0.37
    want_t = damped_vinv_tiled(
        pack_lm_tiles(jnp.asarray(V.reshape(L, 9)), 16, pad_rows=16), lam)
    want = np.asarray(unpack_lm_tiles(want_t[:, :9], L)).reshape(L, 3, 3)
    got = to_np(damped_vinv(to_t(V), lam))
    # the same closed form, element for element: rtol 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[5], 1e6 * np.eye(3), rtol=1e-5)
