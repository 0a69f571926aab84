"""``python -m sfm_tpu_torch.cli tum`` end to end against
``python -m sfm_tpu.cli tum``, both as subprocesses on one TUM layout
written in ``tmp_path`` the way ``benchmarks/bench_tum_format.py`` writes
one: rgb/<ts>.png frames rendered with the fr3 intrinsics, an rgb.txt
index, and groundtruth.txt with camera-to-world quaternion poses at
timestamps offset by 5 ms (so association and interpolation really run).

At the test's size, 40 SpriteScene strafe frames of 240x320 (the fr3
principal point sits in the corner of such an image, which is still a
pinhole camera).  ``cli tum`` writes no file: its one output is the JSON
line on stdout (frames, status, keyframes, landmarks, sim(3) ATE of the
keyframe centres against the interpolated ground truth).  Both lines
must have the same keys; the frame count and the status must be equal,
the keyframes within 1 and the landmarks within 5% (the engine scan
parity's limits, tests/test_torch_engine.py), and each must pass the
benchmark's gate: RUNNING at the end, at least 5 keyframes, ATE at most
2% of the trajectory's extent."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sfm_tpu_torch.io.tum import TUM_INTRINSICS
from sfm_tpu_torch.np_geometry import rodrigues_np
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 40, 240, 320
T0 = 1700000000.0
CAPS = ["--max-keypoints", "512", "--max-keyframes", "8",
        "--max-landmarks", "2048"]
ATE_GATE_PCT = 2.0       # benchmarks/bench_tum_format.py's gate
MIN_KEYFRAMES = 5        # ... and its keyframe count


def _quat(R):
    """Rotation matrix -> (qx, qy, qz, qw) (bench_tum_format.py's
    Shepperd's method, for a rotation near the identity)."""
    s = np.sqrt(np.trace(R) + 1.0) * 2
    return ((R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s, 0.25 * s)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("tum_seq")
    (root / "rgb").mkdir()
    intr = TUM_INTRINSICS["fr3"]
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]],
                  [0, 0, 1]], np.float32)
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(N, step=0.06, yaw_rate=0.001)
    with open(root / "rgb.txt", "w") as idx, \
            open(root / "groundtruth.txt", "w") as gt:
        idx.write("# color images\n# timestamp filename\n")
        gt.write("# ground truth trajectory\n"
                 "# timestamp tx ty tz qx qy qz qw\n")
        for i in range(N):
            ts = T0 + i / 30.0
            img = scene.render(K, rv[i], tv[i], H, W, rgb=True)
            name = f"rgb/{ts:.6f}.png"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                root / name)
            idx.write(f"{ts:.6f} {name}\n")
            R = rodrigues_np(rv[i])
            c = -R.T @ tv[i]
            gt.write(f"{ts + 0.005:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                     + " ".join(f"{v:.6f}" for v in _quat(R.T)) + "\n")
    centres = np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in range(N)])
    return str(root), float(np.linalg.norm(centres[-1] - centres[0]))


@pytest.fixture(scope="module")
def outputs(sequence):
    """Both CLIs at once, each a subprocess: (port's line, JAX's line)."""
    seq, _ = sequence
    pp = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT + (os.pathsep + pp if pp else ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", pkg, "tum", "--seq", seq, "--camera", "fr3",
         *CAPS, *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for pkg, extra in (("sfm_tpu_torch.cli", ["--device", "cpu"]),
                           ("sfm_tpu.cli", []))]
    lines = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        lines.append(json.loads(out.strip().splitlines()[-1]))
    return lines


def test_cli_tum_matches_jax(outputs):
    ours, ref = outputs
    assert list(ours) == list(ref) == ["frames", "status", "n_keyframes",
                                       "n_landmarks", "ate_m"]
    assert ours["frames"] == ref["frames"] == N
    assert ours["status"] == ref["status"]
    assert abs(ours["n_keyframes"] - ref["n_keyframes"]) <= 1
    assert abs(ours["n_landmarks"] - ref["n_landmarks"]) \
        <= 0.05 * ref["n_landmarks"]


@pytest.mark.parametrize("which", [0, 1], ids=["port", "jax"])
def test_cli_tum_passes_the_benchmark_gate(outputs, sequence, which):
    out = outputs[which]
    _, extent = sequence
    assert out["status"] == 1
    assert out["n_keyframes"] >= MIN_KEYFRAMES
    assert 100.0 * out["ate_m"] / extent <= ATE_GATE_PCT, (out, extent)


def test_cli_tum_without_a_card_refuses_the_default_device(sequence):
    """The port's default ``--device cuda`` raises without a card; nothing
    falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from sfm_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["tum", "--seq", sequence[0], *CAPS])
