"""The port's pipelined mapping (parallel/pipeline.py) against the JAX
package's.

- ``merge_mapping_result`` bit for bit against JAX's on every merge of a
  JAX pipelined TEST-size scan (states carried with ``state_from_numpy``),
  and on one of them made to hold a keyframe inserted during the flight,
  landmarks culled by the pass and votes that saturate.
- ``AsyncMappingEngine`` on the CPU over the 30-frame scan of
  tests/test_pipeline.py: that test's checks; two runs bit-identical and
  equal to the dispatch / merge schedule written out serially here.
- The pipeline maps with ``mapping_pass`` itself, without the new
  keyframe's descriptor votes that ``run_pending_mapping`` adds.
- An exception on the mapping worker reaches the caller."""

import importlib

import jax
import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K, to_t

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine.state import CameraParams as JaxCam
from sfm_tpu.parallel import pipeline as jpipe
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import (CameraParams, init_state, mapping_pass,
                                  run_pending_mapping, state_from_numpy,
                                  state_to_numpy, step_frame)
from sfm_tpu_torch.engine.state import scalar
from sfm_tpu_torch.np_geometry import rodrigues_np
from sfm_tpu_torch.parallel import pipeline
from sfm_tpu_torch.parallel.pipeline import (AsyncMappingEngine,
                                             merge_mapping_result)
from sfm_tpu_torch.synthetic import (SpriteScene, strafe_trajectory,
                                     umeyama_ate)

# tests/test_pipeline.py's CFG and scene
CFG = SfMConfig(**TEST_CFG_KW)
N_FRAMES = 30
MERGE_LAG = 2


def _cam():
    K = to_t(TEST_K)
    return CameraParams(K=K, d=torch.zeros(5), Kopt=K)


@pytest.fixture(scope="module")
def scene():
    scene = SpriteScene(np.random.default_rng(3))
    rvecs, tvecs = strafe_trajectory(N_FRAMES)
    frames = [scene.render(TEST_K, rvecs[i], tvecs[i], 240, 320)
              for i in range(N_FRAMES)]
    return frames, rvecs, tvecs


@pytest.fixture(scope="module")
def jax_merges(scene):
    """Every merge of the JAX pipelined scan (tests/test_pipeline.py's,
    tracking and mapping on two virtual CPU devices): (Sk, S0, M, merged)
    as numpy trees."""
    frames = scene[0]
    devs = jax.devices()
    K = np.asarray(TEST_K)
    eng = jpipe.AsyncMappingEngine(
        JaxConfig(**TEST_CFG_KW), JaxCam(K=K, d=np.zeros(5, np.float32),
                                         Kopt=K),
        track_device=devs[0], map_device=devs[1 % len(devs)],
        merge_lag=MERGE_LAG)
    real, merges = eng._merge, []

    def recorded(sk, s0, m):
        out = real(sk, s0, m)
        merges.append(jax.device_get((sk, s0, m, out)))
        return out
    eng._merge = recorded
    for f in frames:
        eng.step(f)
    eng.flush()
    return merges


def _port(tree):
    return state_from_numpy(tree, "cpu")


def _assert_states_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_states_equal(a[k], b[k], f"{path}.{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_merge_equals_jax_on_the_scans_merges(jax_merges):
    assert len(jax_merges) >= 2
    for sk, s0, m, out in jax_merges:
        ours = merge_mapping_result(_port(sk), _port(s0), _port(m))
        _assert_states_equal(state_to_numpy(ours),
                             state_to_numpy(_port(out)))


def test_merge_equals_jax_with_flight_inserts_culls_and_saturation(
        jax_merges):
    # writable copies
    sk, s0, m, _ = (jax.tree.map(np.array, t) for t in jax_merges[-1])
    # a keyframe inserted during the flight: Sk's reference frame in a slot
    # free in S0 and in M
    free = np.nonzero(~s0.kfs.valid & ~m.kfs.valid & ~sk.kfs.valid)[0]
    assert len(free), "no free keyframe slot to insert into"
    f = int(free[0])
    for name in sk.prev._fields:
        getattr(sk.kfs.frames, name)[f] = getattr(sk.prev, name)
    sk.kfs.valid[f] = True
    # landmarks the pass culled: some of the new keyframe's links
    links = sk.prev.landmark[(sk.prev.landmark >= 0) & sk.prev.kp_valid]
    same = s0.lms.valid & m.lms.valid
    linked_same = np.unique(links[same[links]])
    assert len(linked_same) >= 12
    culled = linked_same[:5]
    m.lms.valid[culled] = False
    # descriptor votes that saturate both ways, on stable slots
    up, down = linked_same[5:8], linked_same[8:11]
    for rows, v in ((up, 100), (down, -100)):
        s0.lms.desc_votes[rows] = 0
        sk.lms.desc_votes[rows] = v
        m.lms.desc_votes[rows] = v
    ref = jax.device_get(jax.jit(jpipe.merge_mapping_result)(sk, s0, m))
    ours = merge_mapping_result(_port(sk), _port(s0), _port(m))
    _assert_states_equal(state_to_numpy(ours), state_to_numpy(_port(ref)))
    # the case holds what it is meant to: the inserted keyframe kept, its
    # links to the culled landmarks cleared, the votes clipped to +-127
    out = state_to_numpy(ours)
    assert out["kfs"]["valid"][f]
    assert not np.isin(out["kfs"]["frames"]["landmark"][f], culled).any()
    assert not np.isin(out["prev"]["landmark"], culled).any()
    assert np.isin(sk.kfs.frames.landmark[f], culled).any()
    assert (out["lms"]["desc_votes"][up] == 127).all()
    assert (out["lms"]["desc_votes"][down] == -127).all()


def serial_scan(frames, merge_lag=MERGE_LAG):
    """The pipeline's schedule written out on one thread: a deferred step
    per frame, the pending slot queued, a join after ``merge_lag`` frames
    or when another slot is queued, a dispatch when none is in flight."""
    cam, state = _cam(), init_state(CFG, "cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    queue, inflight, since = [], None, 0
    for img in frames:
        state, _ = step_frame(CFG, cam, state, to_t(img), gen,
                              defer_mapping=True)
        slot = int(state.pending_map_slot)
        if slot >= 0:
            queue.append(slot)
            state = state.replace(pending_map_slot=scalar(-1, "cpu"))
        if inflight is not None:
            since += 1
            if since >= merge_lag or queue:
                state, inflight = merge_mapping_result(state, *inflight), None
        if inflight is None and queue:
            inflight = (state, mapping_pass(CFG, cam, state, queue.pop(0)))
            since = 0
    if inflight is not None:
        state = merge_mapping_result(state, *inflight)
    for slot in queue:
        state = merge_mapping_result(state, state,
                                     mapping_pass(CFG, cam, state, slot))
    return state


def _async_scan(frames, **kw):
    eng = AsyncMappingEngine(CFG, _cam(), merge_lag=MERGE_LAG, device="cpu",
                             **kw)
    metrics = [eng.step(f) for f in frames]
    eng.flush()
    return eng, metrics


@pytest.fixture(scope="module")
def port_scan(scene):
    return _async_scan(scene[0])


def test_async_scan_stays_running(port_scan):
    eng, metrics = port_scan
    assert eng.status == 1
    assert int(metrics[-1]["n_keyframes"]) >= 3
    assert int(metrics[-1]["n_landmarks"]) >= 50
    assert eng.timer.counts["mapping"] >= 2
    assert eng.timer.counts["mapping"] == eng.timer.counts["merge"]


def test_async_scan_trajectory(port_scan, scene):
    eng, _ = port_scan
    _, rvecs, tvecs = scene
    kfs = eng.state.kfs
    valid = kfs.valid.numpy()
    fns = kfs.frames.frame_no.numpy()[valid]
    rv = kfs.frames.rvec.numpy()[valid]
    tv = kfs.frames.tvec.numpy()[valid]
    order = np.argsort(fns)
    est_c = np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in order])
    gt_c = np.stack([-rodrigues_np(rvecs[f]).T @ tvecs[f]
                     for f in fns[order]])
    extent = np.linalg.norm(gt_c[-1] - gt_c[0])
    assert umeyama_ate(est_c, gt_c) < 0.10 * extent


def test_merged_links_consistent(port_scan):
    """No frame links to an invalid landmark slot after the merges."""
    st = port_scan[0].state
    lms_valid = st.lms.valid.numpy()

    def check(landmark, kp_valid):
        linked = (landmark >= 0) & kp_valid
        assert lms_valid[landmark[linked]].all()

    for s in np.nonzero(st.kfs.valid.numpy())[0]:
        check(st.kfs.frames.landmark[s].numpy(),
              st.kfs.frames.kp_valid[s].numpy())
    check(st.prev.landmark.numpy(), st.prev.kp_valid.numpy())


def test_view_counter_deltas_survive_merge(port_scan):
    st = port_scan[0].state
    assert st.lms.n_views.numpy()[st.lms.valid.numpy()].max() >= 5


def test_runs_repeat_and_equal_the_serial_schedule(port_scan, scene):
    again, _ = _async_scan(scene[0])
    first = state_to_numpy(port_scan[0].state)
    _assert_states_equal(state_to_numpy(again.state), first)
    _assert_states_equal(state_to_numpy(serial_scan(scene[0])), first)


def test_split_devices_copy_and_equal_one_device(port_scan, scene,
                                                monkeypatch):
    """track_device and map_device given as distinct devices (both the CPU
    here: torch.device("cpu") and torch.device("cpu", 0) differ, so the
    copy of S0 at each dispatch and of M at each join runs): the result
    equals the single-device pipeline's bit for bit.  A card test in
    test_torch_kernels_cuda.py runs the same path with the mapping on the
    card."""
    copies = []
    real = pipeline.tree_map

    def counted(fn, tree, *others):
        copies.append(type(tree).__name__)
        return real(fn, tree, *others)
    monkeypatch.setattr(pipeline, "tree_map", counted)
    eng, metrics = _async_scan(scene[0], track_device=torch.device("cpu"),
                               map_device=torch.device("cpu", 0))
    assert eng.d_track != eng.d_map
    passes = eng.timer.counts["mapping"]
    assert passes >= 2 and copies == ["SfMState"] * (2 * passes)
    _assert_states_equal(state_to_numpy(eng.state),
                         state_to_numpy(port_scan[0].state))
    for a, b in zip(metrics, port_scan[1]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_maps_without_the_keyframes_descriptor_votes(
        scene, monkeypatch):
    """JAX's pipeline calls mapping_pass on the tracked state as it is; the
    deferred tracking step left the new keyframe's descriptor votes and
    colours out, and run_pending_mapping (the port's add_frames path) adds
    them before its pass.  The pipeline keeps JAX's behaviour."""
    cam, state = _cam(), init_state(CFG, "cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    for img in scene[0]:
        state, _ = step_frame(CFG, cam, state, to_t(img), gen,
                              defer_mapping=True)
        if int(state.status) == 1 and int(state.pending_map_slot) >= 0:
            break
    slot = int(state.pending_map_slot)
    assert slot >= 0
    seen = {}

    def spy(name, real):
        def wrapped(cfg, cam, st, s):
            seen[name] = st
            return real(cfg, cam, st, s)
        return wrapped
    step_mod = importlib.import_module("sfm_tpu_torch.engine.step")
    monkeypatch.setattr(pipeline, "mapping_pass",
                        spy("pipeline", mapping_pass))
    monkeypatch.setattr(step_mod, "mapping_pass", spy("inline", mapping_pass))
    eng = AsyncMappingEngine(CFG, cam, device="cpu")
    m = eng._map(state, slot, None)
    inline = run_pending_mapping(CFG, cam, state)
    fr = state.kfs.frames
    n_links = int((fr.kp_valid[slot] & (fr.landmark[slot] >= 0)).sum())
    assert n_links > 0
    assert seen["pipeline"] is state
    assert int(seen["inline"].lms.n_desc.sum()) \
        == int(state.lms.n_desc.sum()) + n_links
    assert not torch.equal(seen["inline"].lms.color_sum, state.lms.color_sum)
    _assert_states_equal(state_to_numpy(m), state_to_numpy(
        mapping_pass(CFG, cam, state, slot)))
    # run_pending_mapping also refreshes last_kf_tracked and writes the
    # BA'd keyframe pose into prev; the pipeline does neither
    fr_i = inline.kfs.frames
    assert int(inline.last_kf_tracked) == int(
        (fr_i.kp_valid[slot] & (fr_i.landmark[slot] >= 0)).sum())
    assert torch.equal(m.last_kf_tracked, state.last_kf_tracked)
    assert torch.equal(m.prev.rvec, state.prev.rvec)
    assert torch.equal(m.prev.tvec, state.prev.tvec)


def test_a_worker_exception_reaches_the_caller(scene, monkeypatch):
    def boom(*a):
        raise RuntimeError("mapping failed on the worker")
    monkeypatch.setattr(pipeline, "mapping_pass", boom)
    eng = AsyncMappingEngine(CFG, _cam(), merge_lag=MERGE_LAG, device="cpu")
    with pytest.raises(RuntimeError, match="mapping failed on the worker"):
        for f in scene[0]:
            eng.step(f)
        eng.flush()
    assert eng._inflight is None


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        assert AsyncMappingEngine(CFG, _cam()).d_map.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncMappingEngine(CFG, _cam())
