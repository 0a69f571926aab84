"""The ring phase's pieces that need no card: the ``RING`` preset, the
orbit, its scene and the end-of-loop drift measure against
benchmarks/bench_loop_closure.py (its configuration and ``loop_drift``
are taken out of its ``main``), and chip_smoke.py's "ring" phase rehearsed
on the CPU at TEST_CFG size (on the CPU the kernels' plain versions run,
so wrappers count their calls where the kernels count launches)."""

import ast
import dataclasses
import importlib
import importlib.util
import inspect
import json
import os
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu_torch import native
from sfm_tpu_torch.ba import large
from sfm_tpu_torch.config import RING, SfMConfig
from sfm_tpu_torch.features import match_pallas as mp
from sfm_tpu_torch.synthetic import (loop_drift, ring_loop_trajectory,
                                     ring_scene)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# RING at TEST_CFG's image size and detector, with the long scan
# rehearsal's capacities (tests/test_torch_longscan.py), and a probe every
# 2 insertions against landmarks 2 keyframes old
REHEARSAL_KW = dict(
    RING, **{k: TEST_CFG_KW[k] for k in (
        "max_keypoints", "image_height", "image_width", "pyramid_levels",
        "ransac_hypotheses", "pnp_hypotheses", "min_init_matches")},
    max_keyframes=16, max_landmarks=2048, ba_landmark_capacity=512,
    mapping_reobs_capacity=512, ba_local_window=4, global_ba_every=3,
    global_ba_iterations=4, global_ba_cg_iterations=10, loop_detect_every=2,
    loop_min_age=2)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import bench_loop_closure
    finally:
        sys.path.pop(0)
    return bench_loop_closure


def _from_main(bench, keep, names):
    """Statements of bench_loop_closure.main chosen by ``keep`` (an AST
    node -> bool), run in a namespace holding ``names``; returns it."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(bench.main))).body[0]
    body = [n for n in fn.body if keep(n)]
    ns = dict(names)
    exec(compile(ast.Module(body=body, type_ignores=[]), bench.__file__,
                 "exec"), ns)
    return ns


def test_ring_preset_is_bench_loop_closures(bench):
    """RING against the configuration bench_loop_closure.main builds (with
    covisibility and scale on, its default), field for field."""
    ns = _from_main(bench, lambda n: "cfg_kw" in ast.unparse(n)
                    and "SfMConfig" not in ast.unparse(n),
                    dict(LARGE=bench.LARGE, covis=True, scale=True))
    assert RING == ns["cfg_kw"]
    assert dataclasses.asdict(SfMConfig(**RING)) \
        == dataclasses.asdict(JaxConfig(**ns["cfg_kw"]))
    cfg = SfMConfig(**RING)
    assert (cfg.max_keyframes, cfg.max_landmarks, cfg.loop_detect_every,
            cfg.loop_min_age, cfg.global_ba_every) == (512, 65536, 8, 60, 32)


def test_ring_orbit_and_scene_are_the_benchs(bench):
    for n in (1280, 97):
        rv, tv = ring_loop_trajectory(n)
        rv_j, tv_j = bench.ring_loop_trajectory(n)
        np.testing.assert_array_equal(rv, rv_j)
        np.testing.assert_array_equal(tv, tv_j)
    scene, scene_j = ring_scene(), bench.make_ring_scene()
    for name in ("centers", "textures", "tints", "size", "tex_res"):
        np.testing.assert_array_equal(getattr(scene, name),
                                      getattr(scene_j, name))
    K = np.array([[131.25, 0, 80.0], [0, 131.25, 60.0], [0, 0, 1]],
                 np.float32)
    rv, tv = ring_loop_trajectory(1280)
    for i in (0, 1100):
        np.testing.assert_array_equal(
            scene.render(K, rv[i], tv[i], 120, 160),
            scene_j.render(K, rv[i], tv[i], 120, 160))


def test_loop_drift_is_the_benchs(bench):
    """loop_drift against the measure nested in bench_loop_closure.main, on
    keyframe poses drifting along the orbit (the engine's state stood in
    by its arrays, keyframe slots out of frame order, one invalid)."""
    rvecs, tvecs = ring_loop_trajectory(1280)
    rng = np.random.default_rng(4)
    fns = np.sort(rng.choice(1280, 40, replace=False)).astype(np.int32)
    rv, tv = rvecs[fns].copy(), tvecs[fns].copy()
    tv += (np.linspace(0, 1.5, 40)[:, None] * rng.normal(0, 1, 3)).astype(
        np.float32) * 1.3
    rv += rng.normal(0, 0.01, rv.shape).astype(np.float32)
    perm = rng.permutation(41)
    valid = np.ones(41, bool)
    valid[np.argmax(perm == 40)] = False      # the padding row
    pad = lambda a: np.concatenate([a, a[:1] * 7])[perm]  # noqa: E731
    frames = SimpleNamespace(frame_no=pad(fns), rvec=pad(rv), tvec=pad(tv))
    eng = SimpleNamespace(state=SimpleNamespace(kfs=SimpleNamespace(
        frames=frames, valid=valid)))
    ns = _from_main(bench, lambda n: isinstance(n, ast.FunctionDef)
                    and n.name == "loop_drift",
                    dict(np=np, centers_of=bench.centers_of, eng=eng,
                         rvecs=rvecs, tvecs=tvecs))
    end, worst, n_kf, fns_j = ns["loop_drift"]()
    np.testing.assert_array_equal(fns_j, fns)
    got = loop_drift(np.concatenate([rv, tv], 1), fns, rvecs, tvecs)
    assert got == (end, worst, n_kf) and n_kf == 40 and end > 0.5


@pytest.fixture
def counted(monkeypatch):
    """K1's and K2's dispatches count their calls on the CPU; the counts
    are zeroed afterwards (other files' tests read them)."""
    real_k1, real_k2 = mp.hamming_match, large.ba_linearize

    def k1(*a):
        native.LAUNCHES["hamming_match"] += 1
        return real_k1(*a)

    def k2(*a, **kw):
        native.LAUNCHES["ba_linearize"] += 1
        return real_k2(*a, **kw)
    monkeypatch.setattr(mp, "hamming_match", k1)
    monkeypatch.setattr(large, "ba_linearize", k2)
    yield
    native.reset_launch_counts()


def test_ring_phase(smoke, counted, monkeypatch):
    """run_ring at TEST size over the first 64 frames of the 1280-frame
    orbit: the second loop probe is made to report a loop at the
    keyframe's own pose (no correction, no links), so the phase's closure
    path runs (close_loop, its two global BA calls, the schedule that a
    closure restarts); the checks hold (closures past 0 degrees), K1's
    calls at the probe's site are the only ones recorded, two a probe,
    each with the whole landmark axis as windowless sources."""
    step = importlib.import_module("sfm_tpu_torch.engine.step")
    real_build = step.build_loop_probe

    def build(cfg, cam, generator):
        probe, n = real_build(cfg, cam, generator), [0]

        def forced(state, slot, pnp_samples=None):
            out = probe(state, slot, pnp_samples)
            n[0] += 1
            if n[0] != 2:
                return out
            fr = state.kfs.frames
            return out._replace(
                ok=torch.tensor(True), rvec=fr.rvec[slot],
                tvec=fr.tvec[slot], drift=torch.tensor(1.0),
                links=torch.full_like(out.links, -1),
                min_lm_birth=torch.tensor(0), scale=torch.tensor(1.0))
        return forced
    monkeypatch.setattr(step, "build_loop_probe", build)
    cfg = SfMConfig(**REHEARSAL_KW)
    k1_calls = []
    out = smoke.run_ring(torch, "cpu", cfg, ("hamming_match",),
                         gba_kernels=("ba_linearize",), K=TEST_K,
                         n_frames=64, workers=0, k1_calls=k1_calls,
                         closure_deg=0.0, min_keyframes=8)
    assert len(out["closures"]) == 1 and out["probes"] >= 3
    (c,) = out["closures"]
    assert c["global_ba_calls"] == 2 and c["closure_ms"] > c["close_ms"] > 0
    in_closure = [g for g in out["global_ba_calls"] if g["closure"] == 0]
    assert len(in_closure) == 2
    assert out["k1_sites"]["loop.match"] == 2 * out["probes"] == len(k1_calls)
    assert {s for s, _ in k1_calls} == {"loop.match"}
    assert smoke.loop_k1_launches(out["k1_sites"]) == len(k1_calls)
    for _, a in k1_calls:
        assert a[0].shape == (1, cfg.max_landmarks, cfg.desc_words)
        assert not a[1].any() and a[7] == float(np.float32(1e18))
    assert {"loop probes", "loop closures"} <= set(out["split_s"])
    assert out["split_s"]["loop closures"] > 0
    assert out["drift_after_m"] < smoke.RING_MAX_DRIFT
    assert out["running"] >= 0.95 and out["ate_pct"] < 5.0
    assert "keep" not in out
    assert all(out["checks"].values()) and len(out["checks"]) == 13
    assert 0 <= out["max_kf_step_rotation_err_deg"] < 5.0
    json.dumps(out)       # chip_smoke prints it as a JSON line


def test_periodic_schedule(smoke):
    """The schedule chip_smoke holds the periodic global BA calls to: a
    closure restarts the count before its chunk's insertions add to it."""
    f = smoke.periodic_schedule
    ins = [1, 1, 1, 0, 1, 1, 1]
    assert f(ins, [False] * 7, 3) == [2, 6]
    assert f(ins, [False, True] + [False] * 5, 3) == [4]
    assert f(ins, [False] * 6 + [True], 1) == [0, 1, 2, 4, 5, 6]
    assert f(ins, [False] * 7, 0) == []
