"""chip_smoke.py's "dist" phase rehearsed on the CPU at a small size: the
pod problem as a world of one and on 4 gloo ranks, the dense solver on 4
ranks against run_ba, the sharded fleet on 2 ranks against one process,
and dryrun_multichip; every check passes (on the CPU no kernel launches,
so the launch checks expect none)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the ranks are spawned: they find their functions by module name
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)
    monkeypatch.syspath_prepend(ROOT)
    return mod


def test_chip_smoke_dist_phase_rehearsed(smoke):
    size = dict(smoke.DIST_SIZE, C=40, L=4096, kmax=4, lm=3, cg=5,
                dense_c=8, dense_l=64, dense_obs=4, dense_lm=6,
                fleet_scans=4, fleet_frames=6, cfg=TEST_CFG_KW, K=TEST_K)
    out = smoke.run_dist(torch, "cpu", workers=0, size=size)
    assert all(out["checks"].values())
    assert out["pod_world_of_one"]["backend"] == "gloo"
    assert out["pod_world_of_one"]["mesh_shape"] == [1, 1]
    assert [p["map_rank"] for p in out["pod_gloo"]] == [0, 1, 2, 3]
    assert out["pod_gloo"][0]["table_shape"][0] == 4
    # each of the 2 fleet ranks steps 2 scans through 6 frames
    assert [len(f["steps"]) for f in out["fleet"]] == [6, 6]
    assert np.array(out["fleet"][0]["statuses"]).shape == (6, 2)
    rows_in = out["keep"]
    assert rows_in["size"] is size and rows_in["pr"]["nmax"][4] > 0
    # what the kernel rows take: rank 0's K1 calls at the tracking step's
    # two sites, the last frame of its block of 2 scans
    assert {site for site, _ in rows_in["fleet_k1_calls"]} == {
        "tracking.fleet_tracking_step", "tracking.widen_tracks"}
    assert rows_in["fleet_images"].shape[0] == 2
    assert rows_in["fleet_k5_launches"] == 0    # no kernel on the CPU
