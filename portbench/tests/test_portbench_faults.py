"""The comparison that decides ``correct`` must fail the controls and the
faults a cell can have.  Each run here skips the look for a card and
drives the rest of a run on the CPU at a small size (``small.py``), with
the timed path broken underneath, and sees ``correct`` come out false and
the number that should catch it move well above a sound run's.

The controls put the plain reference in bfloat16 in the program's place:
in ``run_large_ba``'s for ``ba1k.solve``; in the tracker's pose
refinement's and the mapping BA's for the scan cell.  The faults: a BA
step that returns its state unchanged, frames skipped, and an answer
altered where it is produced (a landmark of the solve; a frame answered
with the pose of the frame before; every pose answered inverted)."""

import importlib

import numpy as np
import pytest
import torch

from portbench.run import run_cell
from portbench.tests import small

SEED = 2 ** 31 + 99


def run(cell, control=0, seconds=1.0):
    return run_cell(cell, SEED, seconds, 0, device="cpu", control=control,
                    overrides=small.overrides(cell))


def values(r):
    return {k: c["value"] for k, c in r["compared"].items()}


@pytest.fixture(scope="module")
def sound_ba():
    return run("ba1k.solve")


@pytest.fixture(scope="module")
def sound_scan():
    return run("flagship.scan", seconds=3.0)


def test_sound_solve_is_correct(sound_ba):
    assert sound_ba["correct"] is True


def test_solve_control_in_bfloat16_fails(sound_ba):
    r = run("ba1k.solve", control=1)
    assert r["correct"] is False
    assert values(r)["step_gap_X"] > 10 * values(sound_ba)["step_gap_X"]


def test_solve_returning_its_state_unchanged_fails(monkeypatch):
    large = importlib.import_module("sfm_tpu_torch.ba.large")
    from sfm_tpu_torch.ba.core import BAStats

    def unchanged(K, rvec, tvec, xyz, tables, **kw):
        c = torch.tensor(1.0)
        return rvec, tvec, xyz, BAStats(c, c, c, c)
    monkeypatch.setattr(large, "run_large_ba", unchanged)
    r = run("ba1k.solve")
    assert r["correct"] is False
    assert values(r)["step_gap_X"] == pytest.approx(1.0)


def test_solve_answer_altered_fails(monkeypatch, sound_ba):
    large = importlib.import_module("sfm_tpu_torch.ba.large")
    real = large.run_large_ba

    def altered(*a, **kw):
        rv, tv, X, st = real(*a, **kw)
        X = X.clone()
        X[0, 2] += 1.0          # one landmark's depth
        return rv, tv, X, st
    monkeypatch.setattr(large, "run_large_ba", altered)
    r = run("ba1k.solve")
    assert r["correct"] is False
    assert values(r)["step_gap_X"] > 10 * values(sound_ba)["step_gap_X"]


def test_scan_control_in_bfloat16_fails(sound_scan):
    r = run("flagship.scan", control=1, seconds=3.0)
    assert r["correct"] is False
    assert values(r)["map_cost_px2"] > 3 * values(sound_scan)["map_cost_px2"]


def test_pose_reference_in_float32_is_the_programs_refinement():
    """The control's pose reference, run in float32, gives the program's
    pose: what the control changes is the precision alone."""
    from sfm_tpu_torch.geometry.pnp import refine_pose
    from portbench.reference import ba_lm, pose_refine
    g = torch.Generator().manual_seed(5)
    K = torch.tensor([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]])
    xyz = torch.rand(300, 3, generator=g) * torch.tensor([4.0, 3, 3]) \
        + torch.tensor([-2.0, -1.5, 4])
    rv, tv = torch.tensor([0.01, -0.02, 0.005]), torch.tensor([0.3, -0.1, 0.2])
    p = xyz @ ba_lm.exp_so3(rv).T + tv
    uv = 525 * p[:, :2] / p[:, 2:] + torch.tensor([320.0, 240]) \
        + 0.3 * torch.randn(300, 2, generator=g)
    w = (torch.rand(300, generator=g) > 0.1).float()
    start = (rv + 0.003, tv + torch.tensor([0.02, -0.01, 0.05]))
    want = refine_pose(K, *start, xyz, uv, w, iters=4)
    got = pose_refine.refine(K, *start, xyz, uv, w, 4, dtype=torch.float32)
    low = pose_refine.refine(K, *start, xyz, uv, w, 4, dtype=torch.bfloat16)
    for a, b, c in zip(got, want, low):
        assert torch.allclose(a, b, rtol=0, atol=2e-6)
        assert (c - b).abs().max() > 100 * (a - b).abs().max()


def test_scan_skipping_frames_fails(monkeypatch, sound_scan):
    from sfm_tpu_torch.engine import SfMEngine
    real = SfMEngine.add_frames

    def skipping(self, images):
        """Every other frame skipped, answered with the frame before's."""
        outs = real(self, images[::2])
        return [outs[i // 2] if i % 2 == 0 else
                dict(outs[i // 2], keyframe_added=False)
                for i in range(len(images))]
    monkeypatch.setattr(SfMEngine, "add_frames", skipping)
    r = run("flagship.scan", seconds=3.0)
    assert r["correct"] is False
    assert values(r)["repeat_pct"] >= 40.0


def test_scan_poses_inverted_fail(monkeypatch, sound_scan):
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
    r = run("flagship.scan", seconds=3.0)
    assert r["correct"] is False
    assert values(r)["track_p50_m"] > 5 * values(sound_scan)["track_p50_m"]


def test_scan_pose_altered_fails(monkeypatch, sound_scan):
    from sfm_tpu_torch.engine import SfMEngine
    real = SfMEngine.add_frames

    def altered(self, images):
        """Frame 3 of each chunk answered with frame 2's pose."""
        outs = real(self, images)
        outs[3] = dict(outs[3], rvec=outs[2]["rvec"], tvec=outs[2]["tvec"])
        return outs
    monkeypatch.setattr(SfMEngine, "add_frames", altered)
    r = run("flagship.scan", seconds=3.0)
    assert r["correct"] is False
    assert values(sound_scan)["repeat_pct"] == 0.0
    assert values(r)["repeat_pct"] >= 10.0
