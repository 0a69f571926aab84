"""The port's TUM RGB-D support (``sfm_tpu_torch.io.tum``) against the JAX
package's, on a TUM layout written in ``tmp_path`` the way
``benchmarks/bench_tum_format.py`` writes one: rgb/<ts>.png frames, an
rgb.txt index with comments, and groundtruth.txt with camera-to-world
quaternion poses at timestamps offset by 5 ms (so association and
interpolation really run)."""

import numpy as np
import pytest

from torch_port_util import TEST_K

from sfm_tpu.io import tum as jtum
from sfm_tpu_torch.io import tum
from sfm_tpu_torch.np_geometry import rodrigues_np
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory

N = 6
T0 = 1700000000.0


def _quat(R):
    """Rotation matrix -> (qx, qy, qz, qw) (bench_tum_format.py's
    Shepperd's method, for a rotation near the identity)."""
    s = np.sqrt(np.trace(R) + 1.0) * 2
    return ((R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s, 0.25 * s)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(N)
    with open(root / "rgb.txt", "w") as idx, \
            open(root / "groundtruth.txt", "w") as gt:
        idx.write("# color images\n# timestamp filename\n")
        gt.write("# ground truth trajectory\n"
                 "# timestamp tx ty tz qx qy qz qw\n")
        for i in range(N):
            ts = T0 + i / 30.0
            img = scene.render(TEST_K, rv[i], tv[i], 48, 64, rgb=True)
            name = f"rgb/{ts:.6f}.png"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                root / name)
            idx.write(f"{ts:.6f} {name}\n")
            R = rodrigues_np(rv[i])
            c = -R.T @ tv[i]
            q = _quat(R.T)
            gt.write(f"{ts + 0.005:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                     + " ".join(f"{v:.6f}" for v in q) + "\n")
    return str(root)


def test_sequence_layout(layout):
    a, b = tum.TUMSequence(layout), jtum.TUMSequence(layout)
    assert len(a) == len(b) == N
    assert a.rgb == b.rgb
    np.testing.assert_array_equal(a.gt_ts, b.gt_ts)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    assert a.gt_poses.shape == (N, 7)
    fa, fb = list(a.frames()), list(b.frames())
    assert len(fa) == len(fb) == N
    for (ta, ga, ca), (tb, gb, cb) in zip(fa, fb):
        assert ta == tb
        assert ga.dtype == gb.dtype == np.float32 and ga.shape == (48, 64)
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(ca, cb)
    # the frames' timestamps fall between ground-truth samples
    ts = np.array([t for t, _ in a.rgb]) + 0.01
    pa, pb = a.gt_positions_at(ts), b.gt_positions_at(ts)
    np.testing.assert_array_equal(pa, pb)
    assert np.isfinite(pa).all() and np.ptp(pa[:, 0]) > 0


def test_layout_without_groundtruth(layout, tmp_path):
    import shutil
    shutil.copytree(layout, tmp_path / "seq")
    (tmp_path / "seq" / "groundtruth.txt").unlink()
    a = tum.TUMSequence(str(tmp_path / "seq"))
    b = jtum.TUMSequence(str(tmp_path / "seq"))
    assert a.gt_ts is None and b.gt_ts is None and len(a) == len(b) == N


def test_associate(layout):
    rng = np.random.default_rng(0)
    seq = tum.TUMSequence(layout)
    frame_ts = np.array([t for t, _ in seq.rgb])
    for ts_a, ts_b, dt in (
            (frame_ts, seq.gt_ts, 0.02),
            (frame_ts, seq.gt_ts, 0.004),
            (np.sort(rng.uniform(0, 1, 40)), np.sort(rng.uniform(0, 1, 25)),
             0.02),
            (np.array([0.0, 0.1, 0.2]), np.array([0.005, 0.11, 0.5]), 0.02)):
        pairs = tum.associate(ts_a, ts_b, max_dt=dt)
        assert pairs == jtum.associate(ts_a, ts_b, max_dt=dt)
    assert len(tum.associate(frame_ts, seq.gt_ts)) == N
    assert tum.associate(frame_ts, seq.gt_ts, max_dt=0.004) == []


def test_intrinsics():
    assert tum.TUM_INTRINSICS == jtum.TUM_INTRINSICS
    assert set(tum.TUM_INTRINSICS) == {"fr1", "fr2", "fr3"}


def test_ate_sim3(rng):
    gt = rng.normal(0, 1, (30, 3))
    est = gt + rng.normal(0, 0.1, (30, 3))
    assert tum.ate_sim3(est, gt) == jtum.ate_sim3(est, gt)
    assert 0.01 < tum.ate_sim3(est, gt) < 0.3
    R = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    moved = 2.5 * gt @ R.T + np.array([4.0, -1.0, 2.0])
    assert tum.ate_sim3(moved, gt) < 1e-6
    np.testing.assert_allclose(tum.ate_sim3(moved, gt),
                               jtum.ate_sim3(moved, gt), atol=1e-12)
