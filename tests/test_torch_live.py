"""chip_smoke.py's live-path phases rehearsed on the CPU at TEST_CFG size.

The same functions that run on the card at the flagship size: "live"
(RGB frames through per-frame add_frame with guidance, blank frames until
LOST, relocalization, tracking again; every check of the phase), "flow"
timing, and "cli" (scan with metrics, checkpoint and video, a resumed
scan, the PLY files read back).  On the CPU the matcher runs its plain
version, so a wrapper counts its calls where the kernel counts launches."""

import importlib.util
import os

import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K

from sfm_tpu_torch import native
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.features import match_pallas as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted_k1(monkeypatch):
    real = mp.hamming_match

    def count(*args):
        native.LAUNCHES["hamming_match"] += 1
        return real(*args)

    monkeypatch.setattr(mp, "hamming_match", count)


def test_live_phase(smoke, counted_k1):
    out = smoke.run_live(torch, "cpu", SfMConfig(**TEST_CFG_KW),
                         ("hamming_match",), K=TEST_K, before=12, after=8)
    cfg = SfMConfig(**TEST_CFG_KW)
    end = 12 + cfg.max_lost_frames + 2
    assert out["lost_frames"][0] == 12 + cfg.max_lost_frames
    assert end <= out["reloc_frame"] < end + 3
    assert out["reloc_k1_launches"] == 1
    assert out["reloc_inliers"] >= cfg.reloc_min_inliers


def test_flow_timing(smoke):
    cfg = SfMConfig(**TEST_CFG_KW, track_with_flow=True)
    assert smoke.time_flow(torch, "cpu", cfg, K=TEST_K) > 0


def test_cli_phase(smoke):
    out = smoke.run_cli(torch, "cpu", H=240, W=320, K=TEST_K, n=14,
                        resume_frames=4,
                        caps=dict(max_keypoints=192, max_keyframes=8,
                                  max_landmarks=1024))
    assert out["points"] > 30 and out["resume_points"] >= out["points"] - 5
