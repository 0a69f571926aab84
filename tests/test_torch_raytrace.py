"""The port's ray-traced validation renderer (``sfm_tpu_torch/raytrace.py``,
numpy) against the JAX package's (``sfm_tpu/raytrace.py``): the same
seeds give the same scenes, frames, trajectories and alignments bit for
bit.  Frames are rendered at 60x80 with a scaled K, so that the tests stay
fast; the code path is the one a 480x640 frame takes."""

import numpy as np
import pytest

from sfm_tpu import raytrace as jrt
from sfm_tpu_torch import raytrace as rt

K = np.array([[66.0, 0, 40.0], [0, 66.0, 30.0], [0, 0, 1]], np.float32)
DIST = [-0.22, 0.06, 0.0009, -0.0007, 0.0]
H, W = 60, 80


def test_every_public_name_is_ported():
    names = {n for n in vars(jrt) if not n.startswith("__")
             and callable(getattr(jrt, n)) and getattr(
                 getattr(jrt, n), "__module__", "") == jrt.__name__}
    assert names == {"_hash01", "value_noise", "_rot", "RayScene",
                     "orbit_arc_trajectory", "sim3_align", "sim3_ate"}
    assert all(hasattr(rt, n) for n in names)


@pytest.mark.parametrize("seed,n_boxes", [(11, 24), (5, 12)])
def test_scene_equal(seed, n_boxes):
    a, b = rt.RayScene(seed, n_boxes), jrt.RayScene(seed, n_boxes)
    for k in ("bmin", "bmax", "box_seed", "light"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.floor_y == b.floor_y and a.seed == b.seed


@pytest.mark.parametrize("pose", [0, 7])
@pytest.mark.parametrize("dist", [None, DIST], ids=["pinhole", "distorted"])
def test_render_equal(pose, dist):
    rv, tv = rt.orbit_arc_trajectory(12, radius=5.5, arc=0.7)
    a = rt.RayScene(seed=11, n_boxes=24).render(
        K, rv[pose], tv[pose], H, W, d=dist, noise_std=2.5, frame_no=pose)
    b = jrt.RayScene(seed=11, n_boxes=24).render(
        K, rv[pose], tv[pose], H, W, d=dist, noise_std=2.5, frame_no=pose)
    assert a.dtype == b.dtype == np.float32 and a.shape == (H, W)
    np.testing.assert_array_equal(a, b)
    assert a.std() > 10          # a textured frame, not a blank one


@pytest.mark.parametrize("frame_no", [0, 13])
def test_render_grey_by_frame_number(frame_no):
    """The frame number seeds the sensor noise and the exposure wobble."""
    rv, tv = rt.orbit_arc_trajectory(4)
    kw = dict(d=DIST, noise_std=2.0, frame_no=frame_no)
    a = rt.RayScene(seed=3).render(K, rv[1], tv[1], H, W, **kw)
    b = jrt.RayScene(seed=3).render(K, rv[1], tv[1], H, W, **kw)
    np.testing.assert_array_equal(a, b)
    other = rt.RayScene(seed=3).render(K, rv[1], tv[1], H, W, d=DIST,
                                       noise_std=2.0, frame_no=frame_no + 1)
    assert not np.array_equal(a, other)


def test_value_noise_equal():
    rng = np.random.default_rng(0)
    u, v = rng.uniform(-20, 20, (2, 50, 40))
    for seed, octaves in ((0, 2), (977, 1), (12345, 3)):
        np.testing.assert_array_equal(
            rt.value_noise(u, v, seed, octaves=octaves),
            jrt.value_noise(u, v, seed, octaves=octaves))
    np.testing.assert_array_equal(rt._rot(np.array([0.1, -0.4, 0.2])),
                                  jrt._rot(np.array([0.1, -0.4, 0.2])))
    np.testing.assert_array_equal(rt._rot(np.zeros(3)), np.eye(3))


@pytest.mark.parametrize("n,radius,arc,height", [(60, 5.5, 0.7, -0.2),
                                                 (28, 5.0, 0.55, -0.2),
                                                 (1, 4.0, 0.3, 0.1)])
def test_orbit_arc_trajectory_equal(n, radius, arc, height):
    a = rt.orbit_arc_trajectory(n, radius=radius, arc=arc, height=height)
    b = jrt.orbit_arc_trajectory(n, radius=radius, arc=arc, height=height)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("reflect", [False, True])
def test_sim3_align_and_ate_equal(reflect):
    """A noisy similarity of a trajectory (mirrored: the reflection
    branch of the SVD), aligned by both packages."""
    rng = np.random.default_rng(1 + reflect)
    gt = rng.normal(size=(20, 3))
    R = rt._rot(np.array([0.3, -0.2, 0.5]))
    if reflect:
        R = R @ np.diag([1.0, 1.0, -1.0])
    est = (0.7 * gt @ R.T + [0.2, -1.0, 3.0]
           + rng.normal(0, 0.01, gt.shape))
    for x, y in zip(rt.sim3_align(est, gt), jrt.sim3_align(est, gt)):
        np.testing.assert_array_equal(x, y)
    ate = rt.sim3_ate(est, gt)
    assert ate == jrt.sim3_ate(est, gt)
    assert (ate < 0.05) != reflect
