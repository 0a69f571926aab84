"""The port's multi-scan fleet against the JAX package's.

One module fixture runs the JAX ``MultiScanDriver`` once, at
tests/test_parallel.py's configuration (120x160, 3 scans, 12 frames in
chunks of 4), and keeps its states and metrics after each chunk.  Then:
(a) ``make_frames`` against ``jax.vmap(make_frame)``, exactly;
(b) ``fleet_tracking_step`` against the JAX driver's tracking chunk (the
    vmapped ``build_step(..., defer_mapping=True, fleet_tracking_only=True)``)
    from its carried state, scan 0 made to insert a keyframe and scan 2 made
    LOST, with each scan's JAX PnP samples injected;
(c) the fleet's ``map_one`` against the JAX driver's vmapped ``map_one`` on
    that state: the keyframe pose is not written back into ``prev``;
(d) the port's ``MultiScanDriver.step_chunk`` end to end on the same frames:
    statuses per scan and frame, keyframes, trajectory error."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import assert_metrics_match, to_np, to_t

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine.state import CameraParams as JaxCam
from sfm_tpu.engine.state import make_frame as jax_make_frame
from sfm_tpu.parallel.multiscan import MultiScanDriver as JaxDriver
from sfm_tpu.ransac import sample_masked as jax_sample_masked
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import run_pending_mapping, tracking
from sfm_tpu_torch.engine.state import (LOST, RUNNING, CameraParams,
                                        index_state, make_frames,
                                        state_from_numpy)
from sfm_tpu_torch.parallel import MultiScanDriver, map_one
from sfm_tpu_torch.synthetic import (SpriteScene, keyframe_ate,
                                     strafe_trajectory)

# tests/test_parallel.py::TestMultiScanDriver's configuration and scans
CFG_KW = dict(max_keypoints=96, max_keyframes=4, max_landmarks=256,
              image_height=120, image_width=160, pyramid_levels=2,
              ransac_hypotheses=32, pnp_hypotheses=16, ba_iterations=3,
              keyframe_min_tracked=10, keyframe_time_lag=4,
              min_init_matches=15, mapping_tri_keyframes=2,
              mapping_reobs_keyframes=2)
JCFG = JaxConfig(**CFG_KW)
CFG = SfMConfig(**CFG_KW)
K = np.array([[130., 0, 80], [0, 130., 60], [0, 0, 1]], np.float32)
B, T, N_FRAMES = 3, 4, 12
# tests/test_torch_features.py's bound on descriptor bits that differ from
# the JAX package's
FLIP_BOUND = 0.002


def fleet_chunks(n_frames=N_FRAMES, rgb=False):
    """[T, B, H, W(, 3)] float32 chunks of test_parallel's fleet."""
    scenes = [SpriteScene(np.random.default_rng(20 + b), n_sprites=80)
              for b in range(B)]
    rv, tv = strafe_trajectory(n_frames, step=0.08)
    return [np.stack([np.stack([s.render(K, rv[c * T + i], tv[c * T + i],
                                         120, 160, rgb=rgb) for s in scenes])
                      for i in range(T)]).astype(np.float32)
            for c in range(n_frames // T)], (rv, tv)


def port_cam():
    return CameraParams(K=to_t(K), d=torch.zeros(5), Kopt=to_t(K))


@pytest.fixture(scope="module")
def fleet():
    chunks, truth = fleet_chunks()
    jcam = JaxCam(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    drv = JaxDriver(JCFG, jcam, batch=B, bucket=2)
    states, metrics = [jax.device_get(drv.states)], []
    for ch in chunks:
        metrics.append(jax.device_get(drv.step_chunk(jnp.asarray(ch))))
        states.append(jax.device_get(drv.states))
    return dict(chunks=chunks, truth=truth, drv=drv, jcam=jcam,
                states=states, metrics=metrics)


def _scan(tree, b):
    return jax.tree.map(lambda x: x[b], tree)


def test_make_frames_matches_vmapped_make_frame(fleet):
    imgs = fleet["chunks"][1][0]                       # [B, H, W]
    fno = np.array([4, 7, 9], np.int32)
    fr_j = jax.device_get(jax.jit(jax.vmap(
        lambda im, n: jax_make_frame(JCFG, fleet["jcam"], im, n)))(
            jnp.asarray(imgs), jnp.asarray(fno)))
    fr_t = make_frames(CFG, port_cam(), to_t(imgs), to_t(fno))
    for f in dataclasses.fields(fr_t):
        a = to_np(getattr(fr_t, f.name))
        b = np.asarray(getattr(fr_j, f.name))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        if f.name == "xy":
            # the undistorted pixels: XLA fuses the fixed-point iteration
            # and rounds a few entries one unit differently (2.6% of them,
            # within 4e-6 px); the detected pixels (xy_dist) are exact
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        elif f.name == "desc":
            # the descriptor's matmuls sum in another BLAS order, as for
            # one frame (tests/test_torch_features.py's FLIP_BOUND); the
            # same bits flip for one image alone (make_frame): the batch
            # changes none
            bits = lambda d: np.unpackbits(d.view(np.uint8), axis=-1)
            assert (bits(a) != bits(b)).mean() < FLIP_BOUND
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert to_np(fr_t.kp_valid).sum(-1).min() > 40


def _carried(fleet):
    """The JAX fleet's state after chunk 0 (frames 0-3), with scan 0 due a
    keyframe on the chunk's last frame, 7 (its policy counters moved: the
    lag passes there first, and the track ratio always), and scan 2
    LOST."""
    s = jax.tree.map(np.array, fleet["states"][1])
    assert (s.status == RUNNING).all()
    s.last_kf_frame_no[0] = 7 - JCFG.keyframe_time_lag
    s.last_kf_tracked[0] = 10000
    s.status[2] = LOST
    return s


@pytest.fixture(scope="module")
def tracked(fleet):
    """(b)'s two runs: the JAX tracking chunk and the port's four
    fleet_tracking_step calls, from the same carried state and frames."""
    s0 = _carried(fleet)
    images = fleet["chunks"][1]
    st_j, m_j = jax.device_get(fleet["drv"]._track_chunk(
        jax.tree.map(jnp.asarray, s0), jnp.asarray(images)))
    # each RUNNING scan's PnP key per frame: the tracking step splits the
    # scan's key once per frame (both its branches keep the new key)
    keys = [np.asarray(s0.key[b]) for b in range(B)]
    k_pnp = []
    for _ in range(T):
        row = []
        for b in range(B):
            keys[b], k = jax.random.split(keys[b])
            row.append(k)
        k_pnp.append(row)
    cam = port_cam()
    st = state_from_numpy(s0, "cpu")
    ms = []
    for t in range(T):
        valid = {}

        def record(generators, v, n_hyp, s):
            valid["v"] = v
            return torch.zeros((B, n_hyp, s), dtype=torch.int64)
        frames = make_frames(CFG, cam, to_t(images[t]), st.frame_count)
        real = tracking.sample_masked_fleet
        tracking.sample_masked_fleet = record
        try:
            tracking.fleet_tracking_step(CFG, cam, st, frames, None)
        finally:
            tracking.sample_masked_fleet = real
        samples = torch.stack([to_t(np.asarray(jax_sample_masked(
            k_pnp[t][b], jnp.asarray(to_np(valid["v"][b])),
            CFG.pnp_hypotheses, CFG.pnp_sample_size))).to(torch.int64)
            for b in range(B)])
        st, m = tracking.fleet_tracking_step(CFG, cam, st, frames, None,
                                             pnp_samples=samples)
        ms.append(m)
    return dict(s0=s0, st_j=st_j, m_j=m_j, st=st, ms=ms)


def test_fleet_tracking_step_matches_jax(tracked):
    st, st_j, m_j, ms = (tracked[k] for k in ("st", "st_j", "m_j", "ms"))
    for t in range(T):
        for b in range(B):
            # counters and flags exactly; poses to 1e-3 rad / m (a 0.08 m
            # step per frame): the refinement solves differ in the last
            # bits, and on the first frame, from 16-23 matches, the two
            # poses end 7.7e-4 m apart (measured on a CPU; 6e-5 after it)
            mt = {k: v[b] for k, v in ms[t].items()}
            mj = type(m_j)(*(np.asarray(x)[t, b] for x in m_j))
            assert_metrics_match(mt, mj, rtol=0, atol=1e-3)
    kf = np.asarray(m_j.keyframe_added)
    assert kf[3, 0] and not kf[:3, 0].any() and not kf[:, 2].any()
    # the inserting scan records its slot; the LOST scan is untouched and
    # its frame count does not advance
    np.testing.assert_array_equal(to_np(st.pending_map_slot),
                                  np.asarray(st_j.pending_map_slot))
    assert int(st.pending_map_slot[0]) >= 0
    np.testing.assert_array_equal(to_np(st.frame_count),
                                  np.asarray(st_j.frame_count))
    assert to_np(st.frame_count).tolist() == [8, 8, 4]
    for name in ("status", "lost_count", "last_kf_frame_no",
                 "last_kf_tracked"):
        np.testing.assert_array_equal(to_np(getattr(st, name)),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(to_np(st.kfs.valid),
                                  np.asarray(st_j.kfs.valid))
    np.testing.assert_array_equal(to_np(st.lms.n_views),
                                  np.asarray(st_j.lms.n_views))
    np.testing.assert_array_equal(to_np(st.lms.t_alive),
                                  np.asarray(st_j.lms.t_alive))
    assert (to_np(st.prev.landmark) == np.asarray(st_j.prev.landmark)
            ).mean() >= 0.99
    np.testing.assert_allclose(to_np(st.prev.rvec),
                               np.asarray(st_j.prev.rvec), atol=1e-3)
    np.testing.assert_allclose(to_np(st.prev.tvec),
                               np.asarray(st_j.prev.tvec), atol=1e-3)
    s0 = tracked["s0"]
    for name in ("rvec", "tvec", "landmark", "frame_no"):
        np.testing.assert_array_equal(to_np(getattr(st.prev, name))[2],
                                      getattr(s0.prev, name)[2])


def test_fleet_map_one_matches_jax(fleet, tracked):
    """The fleet's mapping pass on each scan with a pending keyframe: the
    JAX driver's vmapped map_one and the port's, from the JAX state after
    (b).  Neither writes the optimised keyframe pose back into ``prev``
    nor refreshes ``last_kf_tracked``, as the single-scan deferred mapping
    does."""
    st_j = tracked["st_j"]
    pending = np.asarray(st_j.pending_map_slot)
    assert pending.tolist()[2] == -1 and (pending[:2] >= 0).all()
    out_j = jax.device_get(fleet["drv"]._map_all(
        jax.tree.map(jnp.asarray, st_j)))
    assert (np.asarray(out_j.pending_map_slot) == -1).all()
    st_t = state_from_numpy(st_j, "cpu")
    for b in range(B):
        sub = map_one(CFG, port_cam(), index_state(st_t, b))
        j, before = _scan(out_j, b), _scan(st_j, b)
        assert int(sub.pending_map_slot) == -1
        np.testing.assert_array_equal(to_np(sub.lms.valid), j.lms.valid)
        np.testing.assert_array_equal(to_np(sub.kfs.valid), j.kfs.valid)
        kv = j.kfs.valid
        np.testing.assert_array_equal(to_np(sub.kfs.frames.landmark)[kv],
                                      j.kfs.frames.landmark[kv])
        np.testing.assert_array_equal(to_np(sub.lms.n_desc), j.lms.n_desc)
        # the BA, as tests/test_torch_engine.py's mapping pass: 1e-4 rad,
        # 3e-3 m
        np.testing.assert_allclose(to_np(sub.kfs.frames.rvec)[kv],
                                   j.kfs.frames.rvec[kv], atol=1e-4)
        np.testing.assert_allclose(to_np(sub.kfs.frames.tvec)[kv],
                                   j.kfs.frames.tvec[kv], atol=3e-3)
        # prev and the policy count keep their tracking-step values
        for pv in (to_np(sub.prev.tvec), j.prev.tvec):
            np.testing.assert_array_equal(pv, before.prev.tvec)
        assert int(sub.last_kf_tracked) == int(j.last_kf_tracked) \
            == int(before.last_kf_tracked)
        if pending[b] < 0:
            # no pending slot: nothing changes
            np.testing.assert_array_equal(to_np(sub.lms.xyz), before.lms.xyz)
            np.testing.assert_array_equal(j.lms.xyz, before.lms.xyz)
    # scan 0's keyframe is its reference frame, and the BA moved its pose:
    # the single-scan deferred mapping writes it back, the fleet's does not
    kf, sl = _scan(out_j, 0).kfs.frames, pending[0]
    assert kf.frame_no[sl] == _scan(st_j, 0).prev.frame_no == 7
    assert np.abs(kf.tvec[sl] - _scan(st_j, 0).prev.tvec).max() > 1e-6
    single = run_pending_mapping(CFG, port_cam(), index_state(st_t, 0))
    np.testing.assert_array_equal(to_np(single.prev.tvec),
                                  to_np(single.kfs.frames.tvec[sl]))


def test_driver_step_chunk_matches_jax(fleet):
    drv = MultiScanDriver(CFG, port_cam(), batch=B, bucket=2, device="cpu")
    ms = [drv.step_chunk(ch) for ch in fleet["chunks"]]
    st_j = fleet["states"][-1]
    for c, (m, mj) in enumerate(zip(ms, fleet["metrics"])):
        np.testing.assert_array_equal(to_np(m["status"]),
                                      np.asarray(mj.status), err_msg=str(c))
    np.testing.assert_array_equal(to_np(drv.states.status), st_j.status)
    np.testing.assert_array_equal(to_np(drv.states.frame_count),
                                  st_j.frame_count)
    assert (to_np(drv.states.pending_map_slot) == -1).all()
    rv, tv = fleet["truth"]

    def ate(kfs):
        valid, fn = to_np(kfs.valid), to_np(kfs.frames.frame_no)
        order = np.argsort(fn[valid])
        traj = np.concatenate([to_np(kfs.frames.rvec)[valid],
                               to_np(kfs.frames.tvec)[valid]], 1)[order]
        return np.sort(fn[valid]), *keyframe_ate(traj, np.sort(fn[valid]),
                                                 rv, tv)
    for b in range(B):
        fn_t, ate_t, extent = ate(index_state(drv.states, b).kfs)
        fn_j, ate_j, _ = ate(_scan(st_j, b).kfs)
        assert abs(len(fn_t) - len(fn_j)) <= 1, (b, fn_t, fn_j)
        assert len(fn_t) >= 3
        # three keyframes over 12 frames of a 120x160 scan: the JAX fleet
        # reads 0.6-32% of the extent; the port within 1% of the extent of
        # it (measured on a CPU: 0.7%)
        assert ate_t <= ate_j + 0.01 * extent, (b, ate_t, ate_j, extent)
