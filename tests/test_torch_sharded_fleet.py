"""The fleet split over ranks: ``build_sharded_step`` on 2 gloo ranks
spawned on the CPU against ``build_batched_step`` over the whole fleet in
one process, bit for bit (tests/test_torch_fleet.py's small fleet)."""

import dataclasses

import numpy as np
import torch

from test_torch_fleet import CFG, K, cam, chunks
from torch_port_util import (fleet_trace, load_ranks, sharded_fleet_worker,
                             spawn_ranks)

from sfm_tpu_torch.engine.state import init_batched_state
from sfm_tpu_torch.parallel import build_batched_step

N_SCANS, N_FRAMES = 4, 6


def _frames():
    """[N_FRAMES, N_SCANS, 120, 160] float32 strafe frames."""
    return np.concatenate(chunks(8, n=N_SCANS))[:N_FRAMES]


def test_sharded_fleet_equals_one_process(tmp_path):
    frames = _frames()
    spawn_ranks(sharded_fleet_worker, 2,
                (tmp_path, dataclasses.asdict(CFG), K, frames), tmp_path)
    ref = fleet_trace(build_batched_step(CFG, cam()),
                      init_batched_state(CFG, N_SCANS, "cpu"),
                      [torch.from_numpy(f) for f in frames])
    status = ref[f"m{N_FRAMES - 1}.status"]
    assert (status == 1).sum() >= 2      # the scans track
    half = N_SCANS // 2
    for r, out in enumerate(load_ranks(tmp_path, "fleet", 2)):
        assert bool(out.pop("odd_batch_raised"))
        assert set(out) == set(ref)
        for k, v in out.items():
            np.testing.assert_array_equal(
                v, ref[k][r * half:(r + 1) * half], err_msg=k)
