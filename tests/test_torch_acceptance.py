"""benchmarks/bench_acceptance.py's reference-shaped acceptance run on both
packages at a cut size: a ray-traced scan (``sfm_tpu_torch/raytrace.py``:
the 24-box scene of seed 11, lens distortion and sensor noise) written as
a y4m video, then ``python -m sfm_tpu_torch.cli scan`` (``--device cpu``)
and ``python -m sfm_tpu.cli scan`` as subprocesses at once, each with the
benchmark's command line (``--chunk 10``, ``--feature-dtype bfloat16``,
``--dist``, ``--checkpoint``, ``--metrics``).

Cut: 240x320 frames (K halved with them: fx 262.5, centre (160, 120), the
same field of view), the benchmark's 60 frames of its orbit arc.  The
port's side runs through chip_smoke.py's acceptance step
(``run_acceptance``), rehearsed here.  Each CLI must pass the benchmark's
three gates (RUNNING on >= 90% of the metrics
lines and >= 5 keyframes; sim(3) ATE of the checkpointed keyframes <= 2%
of the extent, the extent > 1 m; >= 85% of the live landmarks within
0.15 m of a scene surface, and the PLY holding exactly the live
landmarks, with colours), and the two outputs agree: keyframes within 1,
landmarks within 5% (the engine scan parity's limits)."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread, as every port test)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 60, 240, 320
K = np.array([[262.5, 0, 160.0], [0, 262.5, 120.0], [0, 0, 1]], np.float32)
RENDER_WORKERS = 3


@pytest.fixture(scope="module")
def smoke():
    # the render processes find chip_smoke's functions by module name
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("chip_smoke")


@pytest.fixture(scope="module")
def runs(smoke, tmp_path_factory):
    """Both runs: (the port's phase output, JAX's gate numbers)."""
    from sfm_tpu.config import SfMConfig as JaxConfig
    from sfm_tpu.io import load_state, read_ply
    from sfm_tpu.raytrace import sim3_align

    d = tmp_path_factory.mktemp("acceptance")
    frames, _ = smoke.raytrace_frames(K, H, W, N, RENDER_WORKERS)
    smoke.write_y4m(str(d / "scan.y4m"), frames)
    pp = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT + (os.pathsep + pp if pp else ""))
    jax_cli = subprocess.Popen(
        [sys.executable, "-m", "sfm_tpu.cli", "scan", "--input",
         str(d / "scan.y4m"), "--output", str(d / "jax.ply"),
         "--fx", "262.5", "--fy", "262.5", "--cx", "160.0", "--cy", "120.0",
         "--dist", *map(str, smoke.RAYTRACE_DIST), "--chunk", "10",
         "--feature-dtype", "bfloat16", "--checkpoint", str(d / "jax.npz"),
         "--metrics", str(d / "jax.jsonl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    scene, rvecs, tvecs = smoke.scan_scene("raytrace", N)
    try:
        ours, checks = smoke.run_acceptance(
            torch, "cpu", frames, scene, rvecs, tvecs, K,
            cli_args=("--device", "cpu"))
    finally:
        _, err = jax_cli.communicate(timeout=600)
    assert jax_cli.returncode == 0, err[-2000:]

    # bench_acceptance.py's step 3 on the JAX run's outputs
    lines = [json.loads(ln) for ln in open(d / "jax.jsonl")]
    state = load_state(str(d / "jax.npz"), JaxConfig(
        image_height=H, image_width=W, max_keypoints=512, max_keyframes=32,
        max_landmarks=8192, feature_dtype="bfloat16"))
    valid = np.asarray(state.kfs.valid)
    fns = np.asarray(state.kfs.frames.frame_no)[valid]
    order = np.argsort(fns)
    rv = np.asarray(state.kfs.frames.rvec)[valid][order]
    tv = np.asarray(state.kfs.frames.tvec)[valid][order]
    from sfm_tpu_torch.raytrace import _rot
    est_c = np.stack([-_rot(rv[i]).T @ tv[i] for i in range(len(rv))])
    gt_c = np.stack([-_rot(rvecs[f]).T @ tvecs[f] for f in fns[order]])
    s, R, t = sim3_align(est_c, gt_c)
    resid = gt_c - ((s * (R @ est_c.T)).T + t)
    ate = float(np.sqrt((resid ** 2).sum(1).mean()))
    extent = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    lms_valid = np.asarray(state.lms.valid)
    lm_gt = (s * (R @ np.asarray(state.lms.xyz)[lms_valid].T)).T + t
    xyz_ply, rgb_ply = read_ply(str(d / "jax.ply"))
    theirs = dict(
        running=float(np.mean([m["status"] == 1 for m in lines])),
        keyframes=len(est_c), landmarks=int(lms_valid.sum()),
        ate_pct=100 * ate / extent, extent=extent,
        on_surface=float((smoke.surface_distance(scene, lm_gt)
                          < smoke.SURFACE_EPS).mean()),
        ply_points=len(xyz_ply), coloured=rgb_ply is not None)
    return ours, checks, theirs


def test_port_passes_chip_smokes_acceptance_checks(runs):
    _, checks, _ = runs
    assert len(checks) == 6
    assert [n for n, ok in checks.items() if not ok] == []


@pytest.mark.parametrize("which", [0, 1], ids=["port", "jax"])
def test_cli_scan_passes_the_acceptance_gates(runs, which):
    ours, _, theirs = runs
    out = ours if which == 0 else theirs
    assert out["running"] >= 0.9, out
    assert out["keyframes"] >= 5, out
    assert out["extent"] > 1.0 and out["ate_pct"] <= 2.0, out
    assert out["on_surface"] >= 0.85, out
    assert out["ply_points"] == out["landmarks"] > 0, out
    assert out.get("coloured", True)


def test_cli_scans_agree(runs):
    a, _, theirs = runs
    assert abs(a["keyframes"] - theirs["keyframes"]) <= 1, (a, theirs)
    assert abs(a["landmarks"] - theirs["landmarks"]) \
        <= 0.05 * theirs["landmarks"], (a, theirs)
