"""chip_smoke.py's phases rehearsed on the CPU at TEST_CFG size.

The same functions that run on the card at the flagship size: the offline
scan with K1's calls recorded by call site (the inputs of the replay),
"live"
(RGB frames through per-frame add_frame with guidance, blank frames until
LOST, relocalization, tracking again; every check of the phase), "flow"
timing, "cli" (scan with metrics, checkpoint and video, a resumed
scan, the PLY files read back), "pipeline" (the pipelined engine twice
and inline) and "serve" (two clients at once against in-process
engines).  On the CPU the matcher runs its plain
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


def test_offline_phase_records_k1_calls(smoke, counted_k1):
    """The offline scan's K1 calls, recorded for the replay by call site:
    one record a launch, the engine's sites, expanded operands kept at
    batch stride 0 (triangulation's targets, re-observation's sources),
    each call's plain result unchanged on the recorded copy; the
    route-forcing context moves the rule and puts it back."""
    calls = []
    out = smoke.run_slice(torch, "cpu", SfMConfig(**TEST_CFG_KW), "offline",
                          ("hamming_match",), K=TEST_K, n_frames=24,
                          k1_calls=calls)
    assert len(calls) == out["launches"]["hamming_match"] \
        == sum(out["k1_sites"].values()) > 0
    by_site = {}
    for site, args in calls:
        by_site.setdefault(site, []).append(args)
    assert set(by_site) == set(out["k1_sites"]) == {
        "bootstrap.bootstrap_step", "tracking.tracking_step",
        "tracking.widen_tracks", "mapping._triangulate_all_pairs",
        "mapping._reobserve_all"}
    assert all(a[3].stride(0) == 0
               for a in by_site["mapping._triangulate_all_pairs"])
    assert all(a[0].stride(0) == 0 for a in by_site["mapping._reobserve_all"])
    args = by_site["mapping._reobserve_all"][-1]
    res = mp.match_result_plain(*args)
    dense = mp.match_result_plain(*[a.contiguous() if torch.is_tensor(a)
                                    else a for a in args])
    assert all(torch.equal(x, y) for x, y in zip(res, dense))
    assert int(res[2].sum()) > 0
    track = by_site["tracking.tracking_step"][0]
    shape = (track[7], *track[0].shape[:2], track[3].shape[1])
    assert mp.k1_route(*shape) == "dense_int"
    with smoke.k1_route_forced(mp, "cells"):
        assert mp.k1_route(*shape) == "cells"
    assert mp.k1_route(*shape) == "dense_int"


def test_pipeline_phase(smoke, counted_k1):
    out = smoke.run_pipeline(torch, "cpu", SfMConfig(**TEST_CFG_KW),
                             ("hamming_match",), K=TEST_K, n_frames=30)
    assert out["mapping_passes"] >= 2 and out["keyframes"] >= 4
    assert out["launches"]["hamming_match"] > 0
    assert out["inline_fps"] > 0 and 0 <= out["hidden_share"] <= 1


def test_serve_phase(smoke, counted_k1):
    out = smoke.run_serve(torch, "cpu", TEST_CFG_KW, ("hamming_match",),
                          K=TEST_K, n_frames=14, n_single=6)
    assert out["launches"]["hamming_match"] > 0
    assert out["aggregate_fps"] > 0 and out["rtt_median_ms"] > 0
