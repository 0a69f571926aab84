"""chip_smoke.py's phases rehearsed on the CPU at TEST_CFG size.

The same functions that run on the card at the flagship size: the offline
scan with K1's calls recorded by call site (the inputs of the replay),
"live"
(RGB frames through per-frame add_frame with guidance, blank frames until
LOST, relocalization, tracking again; every check of the phase), "flow"
timing, "cli" (scan with metrics, checkpoint and video, a resumed
scan, the PLY files read back), "pipeline" (the pipelined engine twice
and inline, then tracking and mapping on two devices), "serve" (two
clients at once against in-process engines) and "helpers" (the public
helpers no engine path calls, on the offline scan's final engine).  On
the CPU the matcher runs its plain version, so a wrapper counts its
calls where the kernel counts launches."""

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
    """K1's dispatch counts its calls on the CPU; the counts are zeroed
    afterwards (other files' tests read them)."""
    real = mp.hamming_match

    def count(*args):
        native.LAUNCHES["hamming_match"] += 1
        return real(*args)

    monkeypatch.setattr(mp, "hamming_match", count)
    yield
    native.reset_launch_counts()


def test_live_phase(smoke, counted_k1):
    out = smoke.run_live(torch, "cpu", SfMConfig(**TEST_CFG_KW),
                         ("hamming_match",), K=TEST_K, before=12, after=8)
    cfg = SfMConfig(**TEST_CFG_KW)
    end = 12 + cfg.max_lost_frames + 2
    assert out["lost_frames"][0] == 12 + cfg.max_lost_frames
    assert end <= out["reloc_frame"] < end + 3
    assert out["reloc_k1_launches"] == 1
    assert out["reloc_inliers"] >= cfg.reloc_min_inliers


def test_live_phase_counts_pose_sites(smoke, counted_k1, monkeypatch):
    """The live phase's pose refinements by call site and shape
    (``count_pose_sites``, as the full run counts them for the pose
    kernel's rows): the tracking PnP and refinement at the keypoints,
    relocalisation at every landmark slot.  On the CPU a wrapper counts
    the calls where the kernel counts launches."""
    from sfm_tpu_torch import ransac
    from sfm_tpu_torch.engine import tracking

    def counted(real):
        def call(*a, **kw):
            native.LAUNCHES["pose_refine"] += 1
            return real(*a, **kw)
        return call
    monkeypatch.setattr(ransac, "refined", counted(ransac.refined))
    monkeypatch.setattr(tracking, "refine_pose",
                        counted(tracking.refine_pose))
    cfg = SfMConfig(**TEST_CFG_KW)
    sites, restore = smoke.count_pose_sites(native)
    try:
        smoke.run_live(torch, "cpu", cfg, ("hamming_match",), K=TEST_K,
                       before=12, after=8)
    finally:
        restore()
        native.reset_launch_counts()
    N, L = cfg.max_keypoints, cfg.max_landmarks
    assert set(sites) == {("tracking._pnp", 1, N),
                          ("tracking._refine", 1, N),
                          ("reloc.reloc_step", 1, L)}
    assert sites[("tracking._refine", 1, N)] <= sites[("tracking._pnp", 1, N)]
    assert sites[("reloc.reloc_step", 1, L)] > 0


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
    # the split run: tracking on the CPU, the mapping device another
    # torch.device (the card on the card), its first 24 frames
    split = out["split"]
    assert split["frames"] == 24 and split["keyframes"] >= 4
    assert split["mapping_passes"] >= 2 and split["running"] >= 0.9


def test_helpers_phase(smoke, counted_k1, tmp_path):
    """The helpers phase on a TEST-size offline scan's final engine."""
    cfg = SfMConfig(**TEST_CFG_KW)
    out = smoke.run_slice(torch, "cpu", cfg, "offline", ("hamming_match",),
                          K=TEST_K, n_frames=24, keep=True)
    eng = out.pop("keep")
    got = smoke.run_helpers(torch, "cpu", eng, str(tmp_path / "trace"),
                            K=TEST_K, n_frames=24)
    assert got["matches"] > 20 and got["caps"][1] < got["matches"]
    assert got["launches"]["hamming_match"] > 0
    for mode in ("POSE_ONLY", "STRUCT_ONLY"):
        assert got["ba"][mode]["final_cost"] <= got["ba"][mode][
            "initial_cost"]
    assert got["homography_inliers"] > 250
    assert len(list((tmp_path / "trace").glob("*.json"))) == 1


def test_serve_phase(smoke, counted_k1):
    out = smoke.run_serve(torch, "cpu", TEST_CFG_KW, ("hamming_match",),
                          K=TEST_K, n_frames=14, n_single=6)
    assert out["launches"]["hamming_match"] > 0
    assert out["aggregate_fps"] > 0 and out["rtt_median_ms"] > 0
