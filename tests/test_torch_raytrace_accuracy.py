"""The port on imagery its development renderer did not draw: frames of
the ray-traced validation renderer (``sfm_tpu_torch/raytrace.py``: true 3D
occluded surfaces, world-space textures, whole-frame lens distortion,
sensor noise and exposure wobble).

``make_frame`` on a distorted ray-traced 240x320 frame against the JAX
package's: the same keypoints, their undistorted positions to rtol 1e-6
(the same iterative inverse of the lens model, in another library's f32
ops), and descriptors within tests/test_torch_features.py's bit-flip
bound.  Then the port's engine (on the CPU) on
tests/test_raytrace_accuracy.py's 28-frame scan, at that test's gates:
RUNNING at the end, more than 40 landmarks, an extent over 1 m, and a
sim(3) keyframe ATE under 8% of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K, to_np, to_t

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import RUNNING, SfMEngine
from sfm_tpu_torch.engine.state import make_frame
from sfm_tpu_torch.raytrace import (RayScene, _rot, orbit_arc_trajectory,
                                    sim3_ate)

# tests/test_raytrace_accuracy.py's configuration, camera and lens
CFG_KW = dict(
    max_keypoints=192, max_keyframes=8, max_landmarks=1024,
    image_height=240, image_width=320, pyramid_levels=3,
    ransac_hypotheses=64, pnp_hypotheses=32, ba_iterations=6,
    keyframe_min_tracked=15, keyframe_time_lag=6, min_init_matches=25)
K = np.array([[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1]], np.float32)
DIST = [-0.18, 0.05, 0.0008, -0.0006, 0.0]
FLIP_BOUND = 0.002            # tests/test_torch_features.py's


@pytest.mark.parametrize("frame_no", [0, 17])
def test_make_frame_on_a_distorted_raytraced_frame(frame_no):
    scene = RayScene(seed=5)
    rv, tv = orbit_arc_trajectory(28, radius=5.0, arc=0.55)
    img = scene.render(K, rv[frame_no], tv[frame_no], 240, 320, d=DIST,
                       noise_std=2.0, frame_no=frame_no)
    jcfg = JaxConfig(**TEST_CFG_KW)
    jcam = JaxEngine(K, (240, 320), DIST, jcfg).cam
    ref = jax.device_get(jax.jit(lambda im, n: jax_make_frame(
        jcfg, jcam, im, n))(jnp.asarray(img), jnp.asarray(frame_no,
                                                          jnp.int32)))
    eng = SfMEngine(K, (240, 320), DIST, SfMConfig(**TEST_CFG_KW),
                    device="cpu")
    np.testing.assert_allclose(to_np(eng.cam.Kopt), np.asarray(jcam.Kopt),
                               rtol=1e-6)
    assert not np.allclose(to_np(eng.cam.Kopt), K)
    ours = make_frame(eng.config, eng.cam, to_t(img),
                      torch.tensor(frame_no, dtype=torch.int32))
    valid = np.asarray(ref.kp_valid)
    assert valid.sum() > 100
    np.testing.assert_array_equal(to_np(ours.kp_valid), valid)
    np.testing.assert_array_equal(to_np(ours.xy_dist),
                                  np.asarray(ref.xy_dist))
    np.testing.assert_array_equal(to_np(ours.level), np.asarray(ref.level))
    np.testing.assert_array_equal(to_np(ours.score), np.asarray(ref.score))
    # undistorted into Kopt: off the distorted positions by up to pixels
    assert np.abs(np.asarray(ref.xy) - np.asarray(ref.xy_dist))[valid].max() \
        > 1.0
    np.testing.assert_allclose(to_np(ours.xy)[valid], np.asarray(ref.xy)[valid],
                               rtol=1e-6)
    a = np.unpackbits(to_np(ours.desc)[valid].view(np.uint8), axis=-1)
    b = np.unpackbits(np.asarray(ref.desc)[valid].view(np.uint32)
                      .view(np.uint8), axis=-1)
    assert float((a != b).mean()) < FLIP_BOUND


def test_engine_tracks_raytraced_distorted_scene():
    """tests/test_raytrace_accuracy.py's scan and gates, on the port."""
    scene = RayScene(seed=5)
    n = 28
    rvecs, tvecs = orbit_arc_trajectory(n, radius=5.0, arc=0.55)
    eng = SfMEngine(K, (240, 320), DIST, SfMConfig(**CFG_KW), device="cpu")
    for i in range(n):
        img = scene.render(K, rvecs[i], tvecs[i], 240, 320, d=DIST,
                           noise_std=2.0, frame_no=i)
        m = eng.add_frame(img)
    assert eng.status == RUNNING
    assert int(m["n_landmarks"]) > 40
    traj = eng.get_trajectory()
    fns = eng.keyframe_numbers()
    est_c = np.stack([-_rot(traj[i, :3]).T @ traj[i, 3:]
                      for i in range(len(traj))])
    gt_c = np.stack([-_rot(rvecs[f]).T @ tvecs[f] for f in fns])
    ate = sim3_ate(est_c, gt_c)
    extent = np.linalg.norm(gt_c[-1] - gt_c[0])
    assert extent > 1.0            # the arc actually moved
    assert ate < 0.08 * extent, f"ATE {ate:.3f} vs extent {extent:.3f}"
