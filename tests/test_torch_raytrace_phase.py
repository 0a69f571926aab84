"""chip_smoke.py's "raytrace" phase rehearsed on the CPU at a cut size:
benchmarks/bench_independent_accuracy.py's workload (the 24-box ray-traced
scene of seed 11, 60 frames of its orbit arc, the lens's distortion,
sensor noise 2.5) under FLAGSHIP, at 240x320 with K halved (fx 262.5,
centre (160, 120): the same field of view), through ``run_raytrace`` with
its gates (RUNNING >= 90%, >= 6 keyframes, extent > 1 m, sim(3) keyframe
ATE <= 2% of it, Kopt != K) and without the acceptance step
(tests/test_torch_acceptance.py runs that one).  The frames come from the
phase's render processes and equal the renderer's own, frame by frame."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread, as every port test)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 60, 240, 320
K = np.array([[262.5, 0, 160.0], [0, 262.5, 120.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def smoke():
    # the render processes find chip_smoke's functions by module name
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("chip_smoke")


@pytest.fixture(scope="module")
def frames(smoke):
    return smoke.raytrace_frames(K, H, W, N, workers=3)[0]


def test_the_render_processes_draw_the_renderers_frames(smoke, frames):
    scene, rv, tv = smoke.scan_scene("raytrace", N)
    assert frames.shape == (N, H, W) and frames.dtype == np.float32
    for i in (0, 31, N - 1):
        np.testing.assert_array_equal(frames[i], scene.render(
            K, rv[i], tv[i], H, W, d=smoke.RAYTRACE_DIST,
            noise_std=smoke.RAYTRACE_NOISE, frame_no=i))


def test_raytrace_phase_rehearsed(smoke, frames):
    from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
    cfg = SfMConfig(**dict(FLAGSHIP, image_height=H, image_width=W))
    out = smoke.run_raytrace(torch, "cpu", cfg, kernels=(), K=K, n_frames=N,
                             frames=frames, acceptance=False)
    assert "acceptance" not in out
    assert out["running"] >= 0.9 and out["keyframes"] >= 6
    assert out["extent"] > 1.0 and out["ate_pct"] <= 2.0
    assert out["landmarks"] > 100
