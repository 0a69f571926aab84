"""Every ported geometry function against the JAX package on the same
seeded inputs (float32; rtol 1e-4 unless a test states another bound and
its reason)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, random_scene, to_np, to_t

from sfm_tpu.geometry import camera as jcam
from sfm_tpu.geometry import epipolar as jepi
from sfm_tpu.geometry import estimation as jest
from sfm_tpu.geometry import pnp as jpnp
from sfm_tpu.geometry import rotations as jrot
from sfm_tpu.geometry import triangulate as jtri
from sfm_tpu.geometry import twoview as jtwo
from sfm_tpu_torch.geometry import camera, epipolar, estimation, pnp
from sfm_tpu_torch.geometry import rotations, triangulate, twoview
from sfm_tpu_torch.np_geometry import project_np, rodrigues_np

RTOL = 1e-4


def close(a, b, rtol=RTOL, atol=1e-5):
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture
def scene():
    return random_scene(np.random.default_rng(0))


def test_rotations():
    rng = np.random.default_rng(1)
    rv = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    rv[0] = 0.0
    rv[1] = [1e-5, 0, 0]
    R = rotations.exp_so3(to_t(rv))
    close(R, jrot.exp_so3(jnp.asarray(rv)))
    close(rotations.log_so3(R), jrot.log_so3(jnp.asarray(to_np(R))),
          atol=1e-5)
    close(rotations.hat(to_t(rv)), jrot.hat(jnp.asarray(rv)))
    # near pi the port takes the axis from the symmetric part and its sign
    # from the skew part: each rotation comes back within 1e-4.  The JAX
    # package's axis from the diagonal of (R + I) / 2 is 6.5e-3 off on the
    # first, and its positive largest component flips the other two (an
    # error of 2 (pi - |r|) in angle), so it is not the reference here.
    rpi = np.array([[3.13, 0.05, -0.02], [-3.13, 0.05, -0.02],
                    [0.02, -3.12, 0.3]], np.float32)
    Rp = np.asarray(jrot.exp_so3(jnp.asarray(rpi)))
    close(rotations.log_so3(to_t(Rp)), rpi, atol=1e-4)
    assert np.abs(np.asarray(jrot.log_so3(jnp.asarray(Rp)))[1:]
                  - rpi[1:]).max() > 1.0


def test_nearest_rotation():
    """SVD here, Horn's quaternion closed form in the JAX package: the
    same optimum.  atol 1e-4: the JAX form solves a quartic in f32."""
    rng = np.random.default_rng(2)
    R = np.asarray(jrot.exp_so3(jnp.asarray(
        rng.uniform(-1, 1, (32, 3)).astype(np.float32))))
    M = (R * rng.uniform(0.5, 2.0, (32, 1, 1))
         + rng.normal(0, 0.05, R.shape)).astype(np.float32)
    close(rotations.nearest_rotation(to_t(M)),
          jrot.nearest_rotation(jnp.asarray(M)), atol=1e-4)


def test_camera(scene):
    rng = np.random.default_rng(3)
    rv, tv = scene["rvec1"], scene["t1"]
    X = scene["X"]
    K = TEST_K
    close(camera.project(to_t(K), to_t(rv), to_t(tv), to_t(X)),
          jcam.project(jnp.asarray(K), jnp.asarray(rv), jnp.asarray(tv),
                       jnp.asarray(X)))
    close(camera.depths(to_t(rv), to_t(tv), to_t(X)),
          jcam.depths(jnp.asarray(rv), jnp.asarray(tv), jnp.asarray(X)))
    # a batch of poses against one point set
    rvs = rng.uniform(-0.2, 0.2, (4, 3)).astype(np.float32)
    tvs = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    batched = camera.project(to_t(K), to_t(rvs), to_t(tvs), to_t(X))
    for i in range(4):
        close(batched[i], jcam.project(jnp.asarray(K), jnp.asarray(rvs[i]),
                                       jnp.asarray(tvs[i]), jnp.asarray(X)))
    d = np.array([0.05, -0.02, 0.001, -0.001, 0.003], np.float32)
    uv = scene["uv0"]
    Kopt = jcam.optimal_new_camera_matrix(K, d, (240, 320))
    close(camera.optimal_new_camera_matrix(K, d, (240, 320)), Kopt,
          rtol=1e-5)
    close(camera.undistort_pixels(to_t(K), to_t(d), to_t(Kopt), to_t(uv)),
          jcam.undistort_pixels(jnp.asarray(K), jnp.asarray(d),
                                jnp.asarray(Kopt), jnp.asarray(uv)),
          atol=1e-3)


def test_triangulate(scene):
    K = TEST_K
    P0 = K @ np.eye(3, 4, dtype=np.float32)
    P1 = np.asarray(jnp.asarray(K) @ jtri.projection_matrix(
        jnp.asarray(scene["rvec1"]), jnp.asarray(scene["t1"])))
    close(triangulate.projection_matrix(to_t(scene["rvec1"]),
                                        to_t(scene["t1"])),
          jtri.projection_matrix(jnp.asarray(scene["rvec1"]),
                                 jnp.asarray(scene["t1"])))
    X = triangulate.triangulate_pair(to_t(P0), to_t(P1), to_t(scene["uv0"]),
                                     to_t(scene["uv1"]))
    close(X, jtri.triangulate_pair(jnp.asarray(P0), jnp.asarray(P1),
                                   jnp.asarray(scene["uv0"]),
                                   jnp.asarray(scene["uv1"])), rtol=1e-3)
    close(X, scene["X"], rtol=1e-3, atol=1e-3)


def test_epipolar(scene):
    K = TEST_K
    z = np.zeros(3, np.float32)
    args = (K, z, z, K, scene["rvec1"], scene["t1"])
    F = epipolar.fundamental_from_poses(*[to_t(a) for a in args])
    Fj = jepi.fundamental_from_poses(*[jnp.asarray(a) for a in args])
    close(F, Fj, rtol=1e-4, atol=1e-9)
    uv0, uv1 = scene["uv0"], scene["uv1"]
    valid = np.ones(len(uv0), bool)
    for ours, ref in zip(
            epipolar.epiline_distance_sq(F, to_t(uv0), to_t(uv1)),
            jepi.epiline_distance_sq(Fj, jnp.asarray(uv0), jnp.asarray(uv1))):
        close(ours, ref, atol=1e-3)
    keep = epipolar.filter_matches_epipolar(
        F, to_t(uv0), to_t(uv1), to_t(scene["X"]), to_t(z), to_t(z),
        to_t(scene["rvec1"]), to_t(scene["t1"]), 7.0, valid=to_t(valid))
    assert bool(keep.all())
    H = np.asarray(jest.estimate_homography(
        jnp.asarray(uv0), jnp.asarray(uv1), jnp.ones(len(uv0))))
    s, inl = epipolar.homography_score(to_t(H), to_t(uv0), to_t(uv1),
                                       to_t(valid))
    sj, inlj = jepi.homography_score(jnp.asarray(H), jnp.asarray(uv0),
                                     jnp.asarray(uv1), jnp.asarray(valid))
    close(s, sj, rtol=1e-3)
    np.testing.assert_array_equal(to_np(inl), np.asarray(inlj))
    sf, _ = epipolar.fundamental_score(F, to_t(uv0), to_t(uv1), to_t(valid))
    sfj, _ = jepi.fundamental_score(Fj, jnp.asarray(uv0), jnp.asarray(uv1),
                                    jnp.asarray(valid))
    close(sf, sfj, rtol=1e-3)
    close(epipolar.mean_transfer_error(to_t(H), to_t(uv0), to_t(uv1),
                                       to_t(valid)),
          jepi.mean_transfer_error(jnp.asarray(H), jnp.asarray(uv0),
                                   jnp.asarray(uv1), jnp.asarray(valid)),
          rtol=1e-3)
    close(epipolar.mean_epipolar_error(F, to_t(uv0), to_t(uv1), to_t(valid)),
          jepi.mean_epipolar_error(Fj, jnp.asarray(uv0), jnp.asarray(uv1),
                                   jnp.asarray(valid)), rtol=1e-3, atol=1e-4)


def _unit_up_to_sign(M):
    M = np.asarray(M, np.float64).reshape(-1)
    M = M / np.linalg.norm(M)
    return M * np.sign(M[np.argmax(np.abs(M))])


def test_estimators(scene):
    """F and H compared after normalisation (eigenvector sign and scale
    are arbitrary); atol 2e-3 for the f32 eigensolvers on 9x9 systems."""
    uv0, uv1 = scene["uv0"], scene["uv1"]
    rng = np.random.default_rng(4)
    w = (rng.uniform(0, 1, len(uv0)) < 0.7).astype(np.float32)
    F = estimation.estimate_fundamental(to_t(uv0), to_t(uv1), to_t(w))
    Fj = jest.estimate_fundamental(jnp.asarray(uv0), jnp.asarray(uv1),
                                   jnp.asarray(w))
    np.testing.assert_allclose(_unit_up_to_sign(to_np(F)),
                               _unit_up_to_sign(Fj), atol=2e-3)
    H = estimation.estimate_homography(to_t(uv0), to_t(uv1), to_t(w))
    Hj = jest.estimate_homography(jnp.asarray(uv0), jnp.asarray(uv1),
                                  jnp.asarray(w))
    np.testing.assert_allclose(_unit_up_to_sign(to_np(H)),
                               _unit_up_to_sign(Hj), atol=2e-3)
    # batched weights: one estimate per weight row
    W = (rng.uniform(0, 1, (3, len(uv0))) < 0.5).astype(np.float32)
    Fb = estimation.estimate_fundamental(to_t(uv0), to_t(uv1), to_t(W))
    for i in range(3):
        Fi = jest.estimate_fundamental(jnp.asarray(uv0), jnp.asarray(uv1),
                                       jnp.asarray(W[i]))
        np.testing.assert_allclose(_unit_up_to_sign(to_np(Fb[i])),
                                   _unit_up_to_sign(Fi), atol=2e-3)


def test_twoview_recover_pose(scene):
    """Poses compared after the cheirality vote (the SVD's signs differ
    between the packages, the chosen candidate does not)."""
    K = TEST_K
    uv0, uv1 = scene["uv0"], scene["uv1"]
    valid = np.ones(len(uv0), bool)
    z = np.zeros(3, np.float32)
    F = np.asarray(jepi.fundamental_from_poses(
        jnp.asarray(K), jnp.asarray(z), jnp.asarray(z), jnp.asarray(K),
        jnp.asarray(scene["rvec1"]), jnp.asarray(scene["t1"])))
    E = (K.T @ F @ K).astype(np.float32)
    ours = twoview.recover_pose_from_essential(
        to_t(E), to_t(K), to_t(K), to_t(uv0), to_t(uv1), to_t(valid))
    ref = jtwo.recover_pose_from_essential(
        jnp.asarray(E), jnp.asarray(K), jnp.asarray(K), jnp.asarray(uv0),
        jnp.asarray(uv1), jnp.asarray(valid))
    close(ours[0], ref[0], atol=1e-3)
    close(ours[1], ref[1], atol=1e-3)
    assert int(ours[4]) == int(ref[4]) == len(uv0)
    t = scene["t1"] / np.linalg.norm(scene["t1"])
    close(ours[1], t, atol=1e-3)
    # homography path on a planar scene
    rng = np.random.default_rng(5)
    Xp = np.stack([rng.uniform(-2, 2, 150), rng.uniform(-2, 2, 150),
                   np.full(150, 5.0)], 1)
    from sfm_tpu_torch.np_geometry import project_np, rodrigues_np
    rv1 = np.array([0.03, -0.02, 0.01])
    t1 = np.array([0.5, 0.05, -0.05])
    p0 = project_np(K, np.eye(3), np.zeros(3), Xp).astype(np.float32)
    p1 = project_np(K, rodrigues_np(rv1), t1, Xp).astype(np.float32)
    vp = np.ones(150, bool)
    Hj = jest.estimate_homography(jnp.asarray(p0), jnp.asarray(p1),
                                  jnp.ones(150))
    ours = twoview.recover_pose_from_homography(
        to_t(np.asarray(Hj)), to_t(K), to_t(K), to_t(p0), to_t(p1),
        to_t(vp))
    ref = jtwo.recover_pose_from_homography(
        Hj, jnp.asarray(K), jnp.asarray(K), jnp.asarray(p0), jnp.asarray(p1),
        jnp.asarray(vp))
    close(ours[0], ref[0], atol=2e-3)
    close(ours[1], ref[1], atol=2e-3)
    close(ours[0], rv1, atol=2e-3)


def test_pnp(scene):
    """DLT pose: eigh here, inverse iteration in the JAX package (atol
    1e-3 on exact data).  refine_pose: solve here, closed-form 6x6 there
    (atol 1e-4)."""
    K, X, uv = TEST_K, scene["X"], scene["uv1"]
    w = np.ones(len(X), np.float32)
    rv, tv = pnp.pnp_dlt(to_t(K), to_t(X), to_t(uv), to_t(w))
    rvj, tvj = jpnp.pnp_dlt(jnp.asarray(K), jnp.asarray(X), jnp.asarray(uv),
                            jnp.asarray(w))
    close(rv, rvj, atol=1e-3)
    close(tv, tvj, atol=1e-3)
    close(rv, scene["rvec1"], atol=1e-3)
    rng = np.random.default_rng(6)
    uvn = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    rv0 = (scene["rvec1"] + 0.02).astype(np.float32)
    tv0 = (scene["t1"] - 0.05).astype(np.float32)
    ours = pnp.refine_pose(to_t(K), to_t(rv0), to_t(tv0), to_t(X),
                           to_t(uvn), to_t(w), iters=6)
    ref = jpnp.refine_pose(jnp.asarray(K), jnp.asarray(rv0),
                           jnp.asarray(tv0), jnp.asarray(X),
                           jnp.asarray(uvn), jnp.asarray(w), iters=6)
    close(ours[0], ref[0], atol=1e-4)
    close(ours[1], ref[1], atol=1e-4)
    close(pnp.reprojection_errors(to_t(K), ours[0], ours[1], to_t(X),
                                  to_t(uvn)),
          jpnp.reprojection_errors(jnp.asarray(K), ref[0], ref[1],
                                   jnp.asarray(X), jnp.asarray(uvn)),
          atol=1e-3)
    # batched weights -> batched poses
    W = np.stack([w, (rng.uniform(0, 1, len(X)) < 0.5).astype(np.float32)])
    rvb, _ = pnp.pnp_dlt(to_t(K), to_t(X), to_t(uv), to_t(W))
    assert rvb.shape == (2, 3)
    close(rvb[1], scene["rvec1"], atol=1e-3)
    assert torch.isfinite(rvb).all()


def test_quat_to_matrix_and_rotate_points():
    """rtol 1e-5 against the JAX package (atol 1e-6 for entries near 0)."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (64, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    R = rotations.quat_to_matrix(to_t(q))
    close(R, jrot.quat_to_matrix(jnp.asarray(q)), rtol=1e-5, atol=1e-6)
    # a rotation: orthonormal with determinant 1
    np.testing.assert_allclose(to_np(R @ R.transpose(-1, -2)),
                               np.broadcast_to(np.eye(3), (64, 3, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(to_np(torch.linalg.det(R)), 1.0, atol=1e-5)
    pts = rng.normal(0, 2, (3, 40, 3)).astype(np.float32)
    rv = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    for r, p in ((rv[0], pts[0]), (rv, pts)):      # one pose; a batch
        close(rotations.rotate_points(to_t(r), to_t(p)),
              jrot.rotate_points(jnp.asarray(r), jnp.asarray(p)),
              rtol=1e-5, atol=1e-6)


def test_project_cam_and_distort_pixels(scene):
    """rtol 1e-5 against the JAX package; distort_pixels with a nonzero
    model, round-tripped through the port's undistortion."""
    K = TEST_K
    R = rodrigues_np(scene["rvec1"])
    cam_pts = (scene["X"] @ R.T + scene["t1"]).astype(np.float32)
    close(camera.project_cam(to_t(K), to_t(cam_pts)),
          jcam.project_cam(jnp.asarray(K), jnp.asarray(cam_pts)),
          rtol=1e-5, atol=1e-6)
    d = np.array([-0.25, 0.07, 0.001, -0.0005, 0.002], np.float32)
    Kopt = jcam.optimal_new_camera_matrix(K, d, (240, 320))
    uv = scene["uv0"]
    ours = camera.distort_pixels(to_t(K), to_t(d), to_t(Kopt), to_t(uv))
    close(ours, jcam.distort_pixels(jnp.asarray(K), jnp.asarray(d),
                                    jnp.asarray(Kopt), jnp.asarray(uv)),
          rtol=1e-5, atol=1e-6)
    assert np.abs(to_np(ours) - uv).max() > 1.0     # the model does work
    back = camera.undistort_pixels(to_t(K), to_t(d), to_t(Kopt), ours)
    np.testing.assert_allclose(to_np(back), uv, atol=1e-2)
    xy = np.random.default_rng(6).uniform(-0.5, 0.5, (50, 2)).astype(
        np.float32)
    close(camera.distort_norm(to_t(d), to_t(xy)),
          jcam.distort_norm(jnp.asarray(d), jnp.asarray(xy)),
          rtol=1e-5, atol=1e-6)


def test_triangulate_nviews_and_homogeneous_pair():
    """atol 1e-3 against the JAX package (f32 eigensolvers of A^T A)."""
    rng = np.random.default_rng(7)
    V, N = 5, 24
    X = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                  rng.uniform(4, 8, N)], 1)
    rv = np.concatenate([np.zeros((1, 3)),
                         rng.uniform(-0.05, 0.05, (V - 1, 3))])
    tv = np.concatenate([np.zeros((1, 3)),
                         np.stack([np.linspace(0.2, 0.8, V - 1),
                                   rng.uniform(-.05, .05, V - 1),
                                   rng.uniform(-.05, .05, V - 1)], 1)])
    Ps = np.stack([TEST_K @ np.concatenate(
        [rodrigues_np(rv[v]), tv[v][:, None]], 1) for v in range(V)]
    ).astype(np.float32)
    uvs = np.stack([project_np(TEST_K, rodrigues_np(rv[v]), tv[v], X)
                    for v in range(V)], 1)                    # [N, V, 2]
    uvs = (uvs + rng.normal(0, 0.1, uvs.shape)).astype(np.float32)
    mask = rng.uniform(0, 1, (N, V)) < 0.8
    mask[:, :2] = True
    j_nv = jax.vmap(jtri.triangulate_nviews, (None, 0, 0))
    ours = triangulate.triangulate_nviews(to_t(Ps), to_t(uvs), to_t(mask))
    close(ours, j_nv(jnp.asarray(Ps), jnp.asarray(uvs), jnp.asarray(mask)),
          rtol=0, atol=1e-3)
    close(ours, X, rtol=0, atol=0.1)
    # one point, no batch axis
    close(triangulate.triangulate_nviews(to_t(Ps), to_t(uvs[0]),
                                         to_t(mask[0])),
          jtri.triangulate_nviews(jnp.asarray(Ps), jnp.asarray(uvs[0]),
                                  jnp.asarray(mask[0])), rtol=0, atol=1e-3)
    pair = triangulate.triangulate_pair_h(to_t(Ps[0]), to_t(Ps[-1]),
                                          to_t(uvs[:, 0]), to_t(uvs[:, -1]))
    close(pair, jtri.triangulate_pair_h(
        jnp.asarray(Ps[0]), jnp.asarray(Ps[-1]), jnp.asarray(uvs[:, 0]),
        jnp.asarray(uvs[:, -1])), rtol=0, atol=1e-3)
    close(pair, X, rtol=0, atol=0.1)
