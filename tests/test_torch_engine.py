"""The port's engine against the JAX engine.

(a) From JAX engine states carried across with state_from_numpy: one
    tracking step right after bootstrap, on the same frame with the JAX
    PnP samples injected, and one mapping pass on an established map.
    Both BA solvers: the dense one and the large implicit-Schur one.
(b) The same SpriteScene scan through both engines at TEST_CFG, and a
    port-only scan with the large solver.
(c) The package imports with JAX made unimportable.
(d) chip_smoke.py refuses to run without a card."""

import dataclasses
import importlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import TEST_K, to_np, to_t

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.mapping import mapping_pass as jax_mapping_pass
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu.engine.tracking import tracking_step as jax_tracking_step
from sfm_tpu.features.match import match_features as jax_match
from sfm_tpu.ransac import sample_masked as jax_sample_masked
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (RUNNING, CameraParams, SfMEngine,
                                  mapping_pass, state_from_numpy,
                                  state_to_numpy, tracking_step)
from sfm_tpu_torch.engine.state import frame_from_numpy
from sfm_tpu_torch.synthetic import keyframe_ate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_engine.py's TEST_CFG
TEST_CFG = JaxConfig(
    max_keypoints=192, max_keyframes=8, max_landmarks=1024,
    image_height=240, image_width=320, pyramid_levels=3,
    ransac_hypotheses=64, pnp_hypotheses=32, ba_iterations=6,
    keyframe_min_tracked=15, keyframe_time_lag=6, min_init_matches=25)
CFG = SfMConfig(**dataclasses.asdict(TEST_CFG))
N_FRAMES = 30
# five keyframes (0, 1, 7, 13, 19): an established map.  Earlier maps
# (three keyframes, a 0.05 m bootstrap baseline) leave the BA's scale
# gauge nearly free, and the two packages' LM iterates then drift apart
# along it from the last bits of their sums (both to the same cost).
MAP_FRAME = 24


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(3)
    scene = SpriteScene(rng)
    rvecs, tvecs = strafe_trajectory(N_FRAMES)
    frames = [scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
              for i in range(N_FRAMES)]
    eng = JaxEngine(TEST_K, (240, 320), None, TEST_CFG)
    metrics, boot_state = [], None
    for i, f in enumerate(frames):
        metrics.append(eng.add_frame(f))
        if boot_state is None and int(metrics[-1]["status"]) == RUNNING:
            boot_state = (i, jax.device_get(eng.state))
        if i == MAP_FRAME:
            map_state = jax.device_get(eng.state)
    return dict(frames=frames, rvecs=rvecs, tvecs=tvecs, jax_eng=eng,
                jax_metrics=metrics, boot=boot_state, map_state=map_state)


def _port_cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def test_state_round_trip(scan):
    _, tree = scan["boot"]
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(back["kfs"]["frames"]["desc"],
                                  np.asarray(tree.kfs.frames.desc))
    np.testing.assert_array_equal(back["lms"]["xyz"], np.asarray(tree.lms.xyz))
    assert back["rep_desc"].dtype == np.uint32
    assert back["status"].item() == RUNNING


def test_tracking_step_from_jax_state(scan):
    boot_i, tree = scan["boot"]
    img = jnp.asarray(scan["frames"][boot_i + 1])
    cam = scan["jax_eng"].cam
    fr_j = jax.jit(lambda im, n: jax_make_frame(TEST_CFG, cam, im, n))(
        img, jnp.asarray(boot_i + 1, jnp.int32))
    st_j, m_j = jax.jit(lambda s, f: jax_tracking_step(
        TEST_CFG, cam, s, f, None))(tree, fr_j)
    # the JAX step's PnP samples: its key split and its match mask
    _, k_pnp = jax.random.split(tree.key)
    prev = tree.prev
    src_valid = prev.kp_valid & (prev.landmark >= 0)
    res = jax_match(prev.desc, prev.xy, src_valid, fr_j.desc, fr_j.xy,
                    fr_j.kp_valid, min_radius=TEST_CFG.match_min_radius,
                    max_radius=TEST_CFG.match_max_radius,
                    max_distance=TEST_CFG.match_max_distance,
                    ratio=TEST_CFG.match_ratio)
    safe = np.where(src_valid, prev.landmark, 0)
    pnp_valid = np.asarray(res.mask) & np.asarray(tree.lms.valid)[safe]
    samples = jax_sample_masked(k_pnp, jnp.asarray(pnp_valid),
                                TEST_CFG.pnp_hypotheses,
                                TEST_CFG.pnp_sample_size)

    st_t, m_t = tracking_step(
        CFG, _port_cam(), state_from_numpy(tree, "cpu"),
        frame_from_numpy(jax.device_get(fr_j), "cpu"), None,
        pnp_samples=to_t(np.asarray(samples)))
    assert int(m_t["n_matches"]) == int(m_j.n_matches)
    assert int(m_t["n_inliers"]) == int(m_j.n_inliers)
    assert abs(int(m_t["n_tracked"]) - int(m_j.n_tracked)) <= 2
    # pose: 1e-4 rad / 1e-4 (unit-baseline) m; refinement solves differ
    np.testing.assert_allclose(to_np(st_t.prev.rvec),
                               np.asarray(st_j.prev.rvec), atol=1e-4)
    np.testing.assert_allclose(to_np(st_t.prev.tvec),
                               np.asarray(st_j.prev.tvec), atol=1e-4)
    links_t = to_np(st_t.prev.landmark)
    links_j = np.asarray(st_j.prev.landmark)
    assert (links_t == links_j).mean() >= 0.99


def test_mapping_pass_from_jax_state(scan):
    """A mapping pass on the newest keyframe of the JAX engine's map:
    triangulation, re-observation, culling and the dense BA."""
    tree = scan["map_state"]
    cam = scan["jax_eng"].cam
    valid = np.asarray(tree.kfs.valid)
    slot = int(np.argmax(np.where(valid, tree.kfs.frames.frame_no, -1)))
    assert valid.sum() >= 3
    st_j = jax.device_get(jax.jit(lambda s: jax_mapping_pass(
        TEST_CFG, cam, s, jnp.asarray(slot, jnp.int32)))(tree))
    st_t = mapping_pass(CFG, _port_cam(), state_from_numpy(tree, "cpu"),
                        slot)
    # triangulation, re-observation and both cullings are discrete and
    # agree exactly
    assert int(np.asarray(st_j.lms.valid).sum()) >= 50
    np.testing.assert_array_equal(to_np(st_t.lms.valid),
                                  np.asarray(st_j.lms.valid))
    np.testing.assert_array_equal(to_np(st_t.kfs.valid),
                                  np.asarray(st_j.kfs.valid))
    kv = np.asarray(st_j.kfs.valid)
    np.testing.assert_array_equal(to_np(st_t.kfs.frames.landmark)[kv],
                                  np.asarray(st_j.kfs.frames.landmark)[kv])
    # the BA: f32 normal equations summed in another order (measured on
    # this map: 4e-7 rad, 3e-4 m, median landmark 4e-4 m)
    np.testing.assert_allclose(to_np(st_t.kfs.frames.rvec)[kv],
                               np.asarray(st_j.kfs.frames.rvec)[kv],
                               atol=1e-4)
    np.testing.assert_allclose(to_np(st_t.kfs.frames.tvec)[kv],
                               np.asarray(st_j.kfs.frames.tvec)[kv],
                               atol=3e-3)
    lv = np.asarray(st_j.lms.valid)
    dx = np.abs(to_np(st_t.lms.xyz) - np.asarray(st_j.lms.xyz))[lv]
    assert np.median(dx) < 5e-3


# (ba_kmax, ba_local_window): every observation kept; slots overflowing a
# kmax of 3 dropped (the counter is compared); the local observation window
@pytest.mark.parametrize("kmax,window", [(16, 0), (3, 0), (16, 2)])
def test_large_mapping_pass_from_jax_state(scan, kmax, window):
    """The mapping pass with ba_solver="large" on the JAX engine's map,
    against JAX's large solver on its f32 route (use_pallas_ba=False)."""
    tree = scan["map_state"]
    cam = scan["jax_eng"].cam
    cfg_j = dataclasses.replace(TEST_CFG, ba_solver="large", ba_kmax=kmax,
                                ba_local_window=window, use_pallas_ba=False,
                                ba_huber_delta=2.0)
    cfg_t = SfMConfig(**dataclasses.asdict(cfg_j))
    valid = np.asarray(tree.kfs.valid)
    slot = int(np.argmax(np.where(valid, tree.kfs.frames.frame_no, -1)))
    st_j = jax.device_get(jax.jit(lambda s: jax_mapping_pass(
        cfg_j, cam, s, jnp.asarray(slot, jnp.int32)))(tree))
    st_t = mapping_pass(cfg_t, _port_cam(), state_from_numpy(tree, "cpu"),
                        slot)
    np.testing.assert_array_equal(to_np(st_t.lms.valid),
                                  np.asarray(st_j.lms.valid))
    np.testing.assert_array_equal(to_np(st_t.kfs.valid),
                                  np.asarray(st_j.kfs.valid))
    assert int(st_t.ba_dropped_obs) == int(st_j.ba_dropped_obs)
    assert (int(st_t.ba_dropped_obs) > 0) == (kmax == 3)
    kv = np.asarray(st_j.kfs.valid)
    # both run the implicit-Schur PCG in f32 with sums in another order:
    # 1e-4 rad, 3e-3 m (unit baseline) as for the dense pass
    np.testing.assert_allclose(to_np(st_t.kfs.frames.rvec)[kv],
                               np.asarray(st_j.kfs.frames.rvec)[kv],
                               atol=1e-4)
    np.testing.assert_allclose(to_np(st_t.kfs.frames.tvec)[kv],
                               np.asarray(st_j.kfs.frames.tvec)[kv],
                               atol=3e-3)
    lv = np.asarray(st_j.lms.valid)
    dx = np.abs(to_np(st_t.lms.xyz) - np.asarray(st_j.lms.xyz))[lv]
    assert np.median(dx) < 5e-3
    # the BA moved the map (the comparison is not of untouched inputs)
    moved = np.abs(np.asarray(st_j.kfs.frames.tvec)
                   - np.asarray(tree.kfs.frames.tvec))[kv]
    assert moved.max() > 1e-4


def test_scan_matches_jax_engine(scan):
    eng = SfMEngine(TEST_K, (240, 320), None, CFG, device="cpu", seed=0)
    ours = [eng.add_frame(f) for f in scan["frames"]]
    st_t = np.array([int(m["status"]) for m in ours])
    st_j = np.array([int(m["status"]) for m in scan["jax_metrics"]])
    boot_t = int(np.argmax(st_t == RUNNING))
    boot_j = int(np.argmax(st_j == RUNNING))
    assert abs(boot_t - boot_j) <= 1
    assert (st_t[boot_t:] == RUNNING).all()
    assert (st_j[boot_j:] == RUNNING).all()
    n_kf_j = int(np.asarray(scan["jax_eng"].state.kfs.valid).sum())
    assert abs(int(eng.state.kfs.valid.sum()) - n_kf_j) <= 1
    ate, extent = keyframe_ate(eng.get_trajectory(), eng.keyframe_numbers(),
                               scan["rvecs"], scan["tvecs"])
    assert ate < 0.02 * extent, (ate, extent)
    pts, cols = eng.get_reconstruction()
    assert len(pts) >= 60 and (pts[:, 2] > 0).mean() > 0.95
    assert cols.dtype == np.uint8


def test_deferred_chunks_track():
    """add_frames with chunks of keyframe_time_lag frames (deferred mapping,
    the chip_smoke.py path) on the TEST_CFG scan."""
    rng = np.random.default_rng(3)
    scene = SpriteScene(rng)
    rvecs, tvecs = strafe_trajectory(24)
    frames = np.stack([scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
                       for i in range(24)])
    cfg = dataclasses.replace(CFG, track_widen_capacity=256,
                              mapping_reobs_capacity=256,
                              ba_landmark_capacity=256, ba_huber_delta=2.0)
    eng = SfMEngine(TEST_K, (240, 320), None, cfg, device="cpu")
    ms = []
    for i in range(0, 24, cfg.keyframe_time_lag):
        ms += eng.add_frames(frames[i:i + cfg.keyframe_time_lag])
    status = np.array([int(m["status"]) for m in ms])
    assert (status[2:] == RUNNING).all()
    assert int(eng.state.kfs.valid.sum()) >= 3
    assert int(eng.state.pending_map_slot) == -1


def test_large_solver_scan():
    """The port's engine with ba_solver="large" on the SpriteScene scan
    (deferred mapping in chunks), with the dense scan's gates."""
    rng = np.random.default_rng(3)
    scene = SpriteScene(rng)
    rvecs, tvecs = strafe_trajectory(N_FRAMES)
    frames = np.stack([scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
                       for i in range(N_FRAMES)])
    cfg = dataclasses.replace(CFG, ba_solver="large", ba_kmax=8,
                              ba_cg_iterations=12, ba_huber_delta=2.0,
                              ba_landmark_capacity=256)
    eng = SfMEngine(TEST_K, (240, 320), None, cfg, device="cpu")
    ms = []
    for i in range(0, N_FRAMES, cfg.keyframe_time_lag):
        ms += eng.add_frames(frames[i:i + cfg.keyframe_time_lag])
    status = np.array([int(m["status"]) for m in ms])
    boot = int(np.argmax(status == RUNNING))
    assert boot <= 2 and (status[boot:] == RUNNING).all()
    assert int(eng.state.kfs.valid.sum()) >= 4
    assert all(int(m["ba_dropped_obs"]) >= 0 for m in ms)
    ate, extent = keyframe_ate(eng.get_trajectory(), eng.keyframe_numbers(),
                               rvecs, tvecs)
    assert ate < 0.02 * extent, (ate, extent)
    pts, _ = eng.get_reconstruction()
    assert len(pts) >= 60 and np.isfinite(pts).all()


def test_distorted_camera_scan():
    """Frames rendered through a radial-tangential model, engine given the
    same coefficients: every keypoint is undistorted once into Kopt
    (tests/test_engine.py::TestDistortedCamera, same scene and gates)."""
    scene = SpriteScene(np.random.default_rng(3))
    dist = [-0.25, 0.07, 0.001, -0.0005, 0.0]
    rvecs, tvecs = strafe_trajectory(24, step=0.07, yaw_rate=0.001)
    eng = SfMEngine(TEST_K, (240, 320), dist, CFG, device="cpu")
    assert not np.allclose(to_np(eng.cam.Kopt), TEST_K)
    for i in range(24):
        m = eng.add_frame(scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320,
                                       dist=dist))
    assert eng.status == RUNNING
    assert int(m["n_landmarks"]) > 40
    ate, extent = keyframe_ate(eng.get_trajectory(), eng.keyframe_numbers(),
                               rvecs, tvecs)
    assert ate < 0.08 * extent, (ate, extent)


def test_flagship_engine_and_unported_solver():
    """SfMEngine takes the FLAGSHIP preset (the large solver), the cg
    solver, periodic global BA and loop closure (the RING preset): no
    option of SfMConfig is refused any more."""
    from sfm_tpu_torch.config import FLAGSHIP, RING
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    eng = SfMEngine(K, (480, 640), config=SfMConfig(**FLAGSHIP),
                    device="cpu")
    assert eng.config.ba_solver == "large" and eng.status == 0
    for kw in (dict(ba_solver="cg"), dict(global_ba_every=32),
               dict(loop_detect_every=8)):
        eng = SfMEngine(K, (480, 640), config=SfMConfig(**{**FLAGSHIP, **kw}),
                        device="cpu")
        assert all(getattr(eng.config, k) == v for k, v in kw.items())
    eng = SfMEngine(K, (480, 640), config=SfMConfig(**RING), device="cpu")
    assert eng.config.loop_detect_every == 8 and eng.loop_closures == []
    assert eng.probe_loop_closure() is False     # no keyframe yet
    step = importlib.import_module("sfm_tpu_torch.engine.step")
    assert not hasattr(step, "_UNPORTED")
    assert not hasattr(step, "check_supported")


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import sfm_tpu_torch, sfm_tpu_torch.engine\n"
            "import sfm_tpu_torch.features.match_pallas\n"
            "import sfm_tpu_torch.features.patches_pallas\n"
            "import sfm_tpu_torch.ba.large, sfm_tpu_torch.ba.schur_pallas\n"
            "import sfm_tpu_torch.ba.linearize_pallas\n"
            "import sfm_tpu_torch.cli, sfm_tpu_torch.guidance\n"
            "import sfm_tpu_torch.viz, sfm_tpu_torch.engine.reloc\n"
            "import sfm_tpu_torch.features.flow, sfm_tpu_torch.geometry.poly\n"
            "import sfm_tpu_torch.io, sfm_tpu_torch.io.ply\n"
            "import sfm_tpu_torch.io.video, sfm_tpu_torch.io.checkpoint\n"
            "import sfm_tpu_torch.io.runtime, sfm_tpu_torch.io.tum\n"
            "import sfm_tpu_torch.engine.global_ba, sfm_tpu_torch.utils\n"
            "import sfm_tpu_torch.engine.loop\n"
            "import sfm_tpu_torch.parallel, sfm_tpu_torch.parallel.multiscan\n"
            "import sfm_tpu_torch.parallel.pipeline, sfm_tpu_torch.serving\n"
            "import sfm_tpu_torch.frame_queries\n"
            "from sfm_tpu_torch.ba import run_ba_cg\n"
            "bad = [m for m in sys.modules if m == 'sfm_tpu' or "
            "m.startswith('sfm_tpu.') or m.startswith('jax')]\n"
            "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
