"""``sfm_tpu_torch.entry``: the FLAGSHIP step with its example arguments,
and ``dryrun_multichip`` on 4 gloo ranks spawned on the CPU."""

import numpy as np

from torch_port_util import dryrun_worker, load_ranks, spawn_ranks

from sfm_tpu_torch.config import FLAGSHIP
from sfm_tpu_torch.engine.state import METRIC_FIELDS
from sfm_tpu_torch.entry import entry


def test_entry_step_runs_on_its_example():
    fn, (state, image) = entry(device="cpu")
    assert tuple(image.shape) == (FLAGSHIP["image_height"],
                                  FLAGSHIP["image_width"])
    state, m = fn(state, image)
    assert set(m) == {name for name, _, _ in METRIC_FIELDS}
    assert int(state.frame_count) == 1
    assert int(m["status"]) == 0        # a blank frame cannot bootstrap


def test_dryrun_multichip_on_four_ranks(tmp_path):
    spawn_ranks(dryrun_worker, 4, (tmp_path,), tmp_path)
    outs = load_ranks(tmp_path, "dryrun", 4)
    for out in outs:
        # a (2, 2) mesh: each rank steps its 2 of the 4 scans
        assert out["status"].shape == (2,)
        for name in ("dense", "large"):
            c0, c1 = out[name]
            assert np.isfinite(c1) and c1 <= c0, (name, c0, c1)
        np.testing.assert_array_equal(out["rv"], outs[0]["rv"])
