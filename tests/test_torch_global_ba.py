"""Global BA and the cg mapping solver against the JAX engine.

One JAX scan at TEST_CFG size with the configuration of
tests/test_engine.py::TestLargeSolverEngine (the large mapping solver on a
local window, global BA every 3 keyframes) gives: the frames after which
the JAX engine ran global BA, and its state on an established map (five
keyframes).  From that carried state, the port's ``run_global_ba`` is held
against JAX's (its f32 route, ``use_pallas=False``), and the cg branch of
the mapping pass against JAX's.  The port's engine then runs the same scan
and must run global BA after the same frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import TEST_CFG_KW, TEST_K, to_np, to_t

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine.global_ba import run_global_ba as jax_run_global_ba
from sfm_tpu.engine.mapping import mapping_pass as jax_mapping_pass
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (RUNNING, CameraParams, SfMEngine,
                                  mapping_pass, state_from_numpy)
from sfm_tpu_torch.engine.global_ba import run_global_ba
from sfm_tpu_torch.np_geometry import rodrigues_np
from sfm_tpu_torch.synthetic import (SpriteScene, keyframe_ate,
                                     strafe_trajectory, umeyama_ate)

# tests/test_engine.py::TestLargeSolverEngine's configuration
GBA_KW = dict(TEST_CFG_KW, ba_solver="large", ba_kmax=6, ba_cg_iterations=12,
              ba_local_window=4, global_ba_every=3, global_ba_iterations=6,
              global_ba_cg_iterations=15)
N_FRAMES = 30
# keyframes 0, 1, 7, 13, 19, after one global BA: an established map
MAP_FRAME = 24


def _frames():
    scene = SpriteScene(np.random.default_rng(3))
    rvecs, tvecs = strafe_trajectory(N_FRAMES)
    return ([scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
             for i in range(N_FRAMES)], rvecs, tvecs)


def _record_global_ba(eng, frame):
    """Wrap ``eng.global_ba``: each call appends (the frame index in
    ``frame[0]``, its stats) to the returned list."""
    calls, real = [], eng.global_ba

    def wrapped():
        out = real()
        calls.append((frame[0], out))
        return out
    eng.global_ba = wrapped
    return calls


@pytest.fixture(scope="module")
def jax_scan():
    frames, rvecs, tvecs = _frames()
    eng = JaxEngine(TEST_K, (240, 320), None, JaxConfig(**GBA_KW))
    frame = [0]
    calls = _record_global_ba(eng, frame)
    for i, f in enumerate(frames):
        frame[0] = i
        eng.add_frame(f)
        if i == MAP_FRAME:
            map_state = jax.device_get(eng.state)
    return dict(frames=frames, rvecs=rvecs, tvecs=tvecs, cam=eng.cam,
                calls=calls, map_state=map_state)


def _port_cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=to_t(np.zeros(5, np.float32)), Kopt=K)


def _centres(kfs, valid):
    rv = to_np(kfs.frames.rvec)[valid]
    tv = to_np(kfs.frames.tvec)[valid]
    return np.stack([-rodrigues_np(r).T @ t for r, t in zip(rv, tv)])


# kmax 0 takes ba_kmax (6: nothing dropped); 3 drops 126 observations.
# (At 2, two views a landmark, the 6 LM steps are still far from the
# optimum and the two packages' f32 iterates part along the weak depth
# direction: final costs 1.9e-3 apart after agreeing to 3e-5 at step 3.)
@pytest.mark.parametrize("kmax", [0, 3])
def test_global_ba_from_jax_state(jax_scan, kmax):
    """run_global_ba on the carried JAX map, against JAX's: costs,
    accepted steps and dropped observations (a kmax of 3 drops some),
    the fixed oldest keyframe, the keyframe centres up to sim(3), and the
    landmark slots it must not touch."""
    tree = jax_scan["map_state"]
    kw = dict(GBA_KW, global_ba_kmax=kmax, ba_huber_delta=2.0)
    st_j, sj = jax_run_global_ba(JaxConfig(**kw), jax_scan["cam"],
                                 jax.tree.map(jnp.asarray, tree),
                                 use_pallas=False)
    st_j, sj = jax.device_get((st_j, sj))
    st_t, stats = run_global_ba(SfMConfig(**kw), _port_cam(),
                                state_from_numpy(tree, "cpu"))
    np.testing.assert_allclose(float(stats.initial_cost),
                               float(sj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(stats.final_cost),
                               float(sj.final_cost), rtol=1e-3)
    assert int(stats.accepted) == int(sj.accepted) > 0
    assert float(stats.final_cost) < 0.99 * float(stats.initial_cost)
    assert int(stats.dropped_obs) == int(sj.dropped_obs)
    assert (int(stats.dropped_obs) > 0) == (kmax == 3)

    kv = np.asarray(tree.kfs.valid)
    assert kv.sum() == 5
    fn = np.asarray(tree.kfs.frames.frame_no)
    oldest = int(np.argmin(np.where(kv, fn, 2 ** 30)))
    for name in ("rvec", "tvec"):
        a = to_np(getattr(st_t.kfs.frames, name))
        np.testing.assert_array_equal(
            a[oldest], np.asarray(getattr(st_j.kfs.frames, name))[oldest])
        # invalid keyframe slots keep their poses
        np.testing.assert_array_equal(
            a[~kv], np.asarray(getattr(tree.kfs.frames, name))[~kv])
    c_t, c_j = _centres(st_t.kfs, kv), _centres(st_j.kfs, kv)
    order = np.argsort(fn[kv])
    extent = np.linalg.norm(c_j[order[-1]] - c_j[order[0]])
    assert umeyama_ate(c_t, c_j) < 1e-3 * extent
    lv = np.asarray(tree.lms.valid)
    xyz_t = to_np(st_t.lms.xyz)
    np.testing.assert_array_equal(xyz_t[~lv], np.asarray(tree.lms.xyz)[~lv])
    np.testing.assert_array_equal(xyz_t[~lv], np.asarray(st_j.lms.xyz)[~lv])
    # only poses and positions change
    np.testing.assert_array_equal(to_np(st_t.lms.valid), lv)
    np.testing.assert_array_equal(to_np(st_t.kfs.frames.landmark),
                                  np.asarray(tree.kfs.frames.landmark))


@pytest.mark.parametrize("window,capacity", [(0, 0), (4, 256)])
def test_cg_mapping_pass_from_jax_state(jax_scan, window, capacity):
    """The mapping pass with ba_solver="cg" on the carried JAX map,
    against JAX's (the full landmark axis without a local window, and a
    compacted axis with one)."""
    tree = jax_scan["map_state"]
    kw = dict(TEST_CFG_KW, ba_solver="cg", ba_cg_iterations=15,
              ba_huber_delta=2.0, ba_local_window=window,
              ba_landmark_capacity=capacity)
    valid = np.asarray(tree.kfs.valid)
    slot = int(np.argmax(np.where(valid, tree.kfs.frames.frame_no, -1)))
    st_j = jax.device_get(jax.jit(lambda s: jax_mapping_pass(
        JaxConfig(**kw), jax_scan["cam"], s,
        jnp.asarray(slot, jnp.int32)))(tree))
    st_t = mapping_pass(SfMConfig(**kw), _port_cam(),
                        state_from_numpy(tree, "cpu"), slot)
    np.testing.assert_array_equal(to_np(st_t.lms.valid),
                                  np.asarray(st_j.lms.valid))
    np.testing.assert_array_equal(to_np(st_t.kfs.valid),
                                  np.asarray(st_j.kfs.valid))
    kv = np.asarray(st_j.kfs.valid)
    np.testing.assert_array_equal(to_np(st_t.kfs.frames.landmark)[kv],
                                  np.asarray(st_j.kfs.frames.landmark)[kv])
    # f32 PCG with sums in another order: the mapping pass's 1e-4 rad and
    # 3e-3 m (unit baseline), landmarks by their median
    np.testing.assert_allclose(to_np(st_t.kfs.frames.rvec)[kv],
                               np.asarray(st_j.kfs.frames.rvec)[kv],
                               atol=1e-4)
    np.testing.assert_allclose(to_np(st_t.kfs.frames.tvec)[kv],
                               np.asarray(st_j.kfs.frames.tvec)[kv],
                               atol=3e-3)
    lv = np.asarray(st_j.lms.valid)
    dx = np.abs(to_np(st_t.lms.xyz) - np.asarray(st_j.lms.xyz))[lv]
    assert np.median(dx) < 5e-3
    moved = np.abs(np.asarray(st_j.kfs.frames.tvec)
                   - np.asarray(tree.kfs.frames.tvec))[kv]
    assert moved.max() > 1e-4


def test_engine_runs_global_ba_after_the_same_frames(jax_scan):
    """tests/test_engine.py::TestLargeSolverEngine on the port (per-frame
    add_frame): global BA after the same frames as the JAX engine, no call
    raises the cost, ATE < 8% of the extent, and an explicit call
    returns the stats and keeps the scan RUNNING."""
    eng = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**GBA_KW),
                    device="cpu")
    frame = [0]
    calls = _record_global_ba(eng, frame)
    for i, f in enumerate(jax_scan["frames"]):
        frame[0] = i
        eng.add_frame(f)
    assert eng.status == RUNNING
    assert [i for i, _ in calls] == [i for i, _ in jax_scan["calls"]]
    assert len(calls) >= 1
    for _, st in calls:
        assert np.isfinite(st["final_cost"])
        assert st["final_cost"] <= st["initial_cost"]
    ate, extent = keyframe_ate(eng.get_trajectory(), eng.keyframe_numbers(),
                               jax_scan["rvecs"], jax_scan["tvecs"])
    assert ate < 0.08 * extent, (ate, extent)
    stats = eng.global_ba()
    assert set(stats) == {"initial_cost", "final_cost", "lam", "accepted",
                          "dropped_obs"}
    assert all(isinstance(v, np.ndarray) for v in stats.values())
    assert float(stats["final_cost"]) <= float(stats["initial_cost"])
    assert int(stats["dropped_obs"]) == 0
    assert eng.status == RUNNING and eng._kfs_since_global_ba == 0


def test_add_frames_counts_keyframes_for_global_ba(jax_scan):
    """add_frames (deferred mapping) feeds the chunk's keyframe_added sum
    to the schedule: one global BA per global_ba_every insertions."""
    cfg = SfMConfig(**GBA_KW)
    eng = SfMEngine(TEST_K, (240, 320), None, cfg, device="cpu")
    calls = _record_global_ba(eng, [0])
    frames = np.stack(jax_scan["frames"])
    ms = []
    for i in range(0, N_FRAMES, cfg.keyframe_time_lag):
        ms += eng.add_frames(frames[i:i + cfg.keyframe_time_lag])
    inserted = sum(int(m["keyframe_added"]) for m in ms)
    assert inserted >= 4
    assert len(calls) == inserted // cfg.global_ba_every
    assert eng._kfs_since_global_ba == inserted % cfg.global_ba_every
    assert all(st["final_cost"] <= st["initial_cost"] for _, st in calls)
