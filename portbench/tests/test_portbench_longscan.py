"""The long-session cell ``longscan.sweep`` at a small size on the CPU: its
own sizes here (``small.py`` holds the other cells'), a 64-frame session
of the serpentine sweep at 240x320 with global BA every 4 keyframe
insertions, so that a window holds two calls.

A sound run is correct; the comparison fails the control (the plain
reference in bfloat16 in the tracker's pose refinement's, the mapping
BA's and global BA's place) and the faults: a global BA that returns its
input unchanged, every other frame skipped, every pose answered
inverted.  Also: the frozen scene and path are the port's, and what the
driver keeps of a global BA call is not written in place afterwards."""

import importlib

import numpy as np
import pytest
import torch

from portbench.run import run_cell

SEED = 2 ** 31 + 77
SMALL = dict(
    config={"image_size": [240, 320],
            "K": [[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1.0]],
            "session_frames": 64},
    engine=dict(max_keypoints=192, max_keyframes=16, max_landmarks=2048,
                image_height=240, image_width=320, pyramid_levels=3,
                ransac_hypotheses=64, min_init_matches=25,
                ba_landmark_capacity=512, track_widen_capacity=512,
                mapping_reobs_capacity=512, ba_local_window=4,
                mapping_tri_keyframes=4, mapping_reobs_keyframes=4,
                global_ba_every=4),
    traffic=dict(warm_frames=16))


@pytest.fixture(scope="module", autouse=True)
def render_here():
    """The frames rendered in this process and every run: a pool's start-up
    and the checkout's cache are not what these tests check."""
    with pytest.MonkeyPatch.context() as mp:
        drv = importlib.import_module("portbench.drivers.longscan")
        mp.setattr(drv, "RENDER_WORKERS", 0)
        mp.setattr(drv, "FRAME_CACHE", None)
        yield


def run(control=0):
    return run_cell("longscan.sweep", SEED, 60.0, 0, device="cpu",
                    control=control, overrides=SMALL)


def values(r):
    return {k: c["value"] for k, c in r["compared"].items()}


@pytest.fixture(scope="module")
def sound():
    return run()


def test_sound_session_is_correct(sound):
    assert sound["correct"] is True and sound["failed"] == 0
    assert sound["attempted"] == 64 - 16     # the window starts at frame 16


def test_control_in_bfloat16_fails(sound):
    r = run(control=1)
    assert r["correct"] is False
    v, s = values(r), values(sound)
    assert v["gba_cost_gap"] > 1e3 * s["gba_cost_gap"]
    assert v["map_cost_px2"] > 3 * s["map_cost_px2"]


def test_global_ba_returning_its_input_unchanged_fails(monkeypatch, sound):
    step = importlib.import_module("sfm_tpu_torch.engine.step")
    real = step.run_global_ba

    def unchanged(cfg, cam, state):
        return state, real(cfg, cam, state)[1]
    monkeypatch.setattr(step, "run_global_ba", unchanged)
    r = run()
    assert r["correct"] is False
    assert values(r)["gba_cost_gap"] > 1e3 * values(sound)["gba_cost_gap"]


def test_skipping_frames_fails(monkeypatch):
    from sfm_tpu_torch.engine import SfMEngine
    real = SfMEngine.add_frames

    def skipping(self, images):
        """Every other frame skipped, answered with the frame before's."""
        outs = real(self, images[::2])
        return [outs[i // 2] if i % 2 == 0 else
                dict(outs[i // 2], keyframe_added=False)
                for i in range(len(images))]
    monkeypatch.setattr(SfMEngine, "add_frames", skipping)
    r = run()
    assert r["correct"] is False
    assert values(r)["repeat_pct"] >= 40.0


def test_poses_inverted_fail(monkeypatch, sound):
    from sfm_tpu_torch.engine import SfMEngine
    from portbench.reference.synthetic import log_rotation, rodrigues_np
    real = SfMEngine.add_frames

    def inverted(self, images):
        """Each pose answered camera-to-world, the other convention."""
        outs = []
        for m in real(self, images):
            R = rodrigues_np(np.asarray(m["rvec"], np.float64))
            outs.append(dict(m, rvec=log_rotation(R.T),
                             tvec=(-R.T @ np.asarray(m["tvec"], np.float64)
                                   ).astype(np.float32)))
        return outs
    monkeypatch.setattr(SfMEngine, "add_frames", inverted)
    r = run()
    assert r["correct"] is False
    assert values(r)["kf_ate_pct"] > 5 * values(sound)["kf_ate_pct"]


def test_kept_global_ba_calls_are_not_written_in_place(monkeypatch):
    """Each call's input and output, as the driver keeps them by reference,
    still equal copies taken at the call once the session has run on."""
    drv = importlib.import_module("portbench.drivers.longscan")
    real_keep, copies = drv._keep_global_ba, []

    def keep(eng, st):
        real_keep(eng, st)
        kept = eng.global_ba

        def global_ba():
            before = {k: v.clone() for k, v in drv.inputs(eng.state).items()}
            out = kept()
            after = {k: v.clone() for k, v in drv.outputs(eng.state).items()}
            copies.append((st["gba"][-1], before, after))
            return out
        eng.global_ba = global_ba
    monkeypatch.setattr(drv, "_keep_global_ba", keep)
    run()
    assert len(copies) >= 3
    for call, before, after in copies:
        for k, v in before.items():
            assert torch.equal(call["before"][k], v), k
        for k, v in after.items():
            assert torch.equal(call["after"][k], v), k


def test_the_frozen_scene_and_path_are_the_ports():
    from sfm_tpu_torch import synthetic
    from portbench.reference import longscan
    scene, rv, tv = longscan.longscan_scene(96)
    want, wrv, wtv = synthetic.longscan_scene(96)
    for k in ("centers", "textures", "tints", "size"):
        assert np.array_equal(getattr(scene, k), getattr(want, k)), k
    assert np.array_equal(rv, wrv) and np.array_equal(tv, wtv)
    K = np.array(SMALL["config"]["K"], np.float32)
    frame = longscan.render(96, 40, 41, K, (240, 320))[0]
    assert np.array_equal(frame, np.clip(want.render(
        K, wrv[40], wtv[40], 240, 320), 0, 255).astype(np.uint8))
    traj = np.concatenate([rv[::8], tv[::8]], 1).astype(np.float64)
    assert longscan.keyframe_ate(traj, np.arange(0, 96, 8), rv, tv) \
        == synthetic.keyframe_ate(traj, np.arange(0, 96, 8), rv, tv)


def test_frames_are_rendered_once_and_loaded_after(monkeypatch, tmp_path):
    """The first call renders and keeps the frames; the next loads the same
    bits; another size is another file."""
    drv = importlib.import_module("portbench.drivers.longscan")
    monkeypatch.setattr(drv, "FRAME_CACHE", tmp_path)
    K = np.array(SMALL["config"]["K"], np.float32)
    path = drv._cache_path(8, K, (240, 320))
    frames, ready, close = drv._frames(path, 8, K, (240, 320))
    ready(8)
    close()
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    monkeypatch.setattr(drv, "_rendered", None)     # no second render
    loaded, ready, close = drv._frames(path, 8, K, (240, 320))
    ready(8)
    close()
    assert np.array_equal(loaded, frames)
    assert np.array_equal(frames[3], longscan_frame(8, 3, K))
    assert drv._cache_path(8, K, (120, 160)) != path
    assert drv._cache_path(16, K, (240, 320)) != path


def longscan_frame(n, i, K):
    from portbench.reference import longscan
    return longscan.render(n, i, i + 1, K, (240, 320))[0]


def test_the_control_hands_the_solvers_back():
    """After a control run, a run in the same process has the program's
    BA in the mapping pass and in global BA again."""
    from sfm_tpu_torch.ba import large
    from portbench.drivers import scanlib
    drv = importlib.import_module("portbench.drivers.longscan")
    gba = importlib.import_module("sfm_tpu_torch.engine.global_ba")
    mapping = importlib.import_module("sfm_tpu_torch.engine.mapping")
    for bf16 in (True, False, True, False):
        scanlib._use_solvers(bf16)      # as scanlib.new_engine does
        drv._use_solvers(bf16)
        want = drv._ba_in_bf16 if bf16 else large.run_large_ba
        assert gba.run_large_ba is want and mapping.run_large_ba is want
