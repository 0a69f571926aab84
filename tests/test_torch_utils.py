"""``sfm_tpu_torch.utils.PhaseTimer`` against the JAX package's on the same
phases and the same clock readings (the JAX timer reads
``time.perf_counter``, the port's, a view over its span recorder,
``time.time_ns``)."""

import itertools
import time

from sfm_tpu.utils import PhaseTimer as JPhaseTimer
from sfm_tpu_torch.utils import PhaseTimer


def _drive(timer_cls, monkeypatch):
    # a clock that advances 0.25 s per reading: each phase lasts 0.25 s
    clock = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: 0.25 * next(clock))
    monkeypatch.setattr(time, "time_ns",
                        lambda: 250_000_000 * next(clock))
    timer = timer_cls()
    for name in ("tracking", "mapping pass", "tracking", "global BA",
                 "tracking"):
        with timer.phase(name):
            pass
    try:
        with timer.phase("mapping pass"):
            raise RuntimeError
    except RuntimeError:
        pass
    return timer


def test_phase_timer_matches_jax(monkeypatch):
    ours = _drive(PhaseTimer, monkeypatch)
    ref = _drive(JPhaseTimer, monkeypatch)
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()
    assert dict(ours.counts) == {"tracking": 3, "mapping pass": 2,
                                 "global BA": 1}
    assert ours.summary()["tracking"] == {"total_s": 0.75, "count": 3,
                                          "mean_ms": 250.0}


def _scan_metrics():
    """The metric dicts of a short port scan at tests/test_engine.py's TEST
    size, and a hand-made log with LOST frames and frames without a
    reprojection error."""
    import numpy as np

    from torch_port_util import TEST_CFG_KW, TEST_K
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine import SfMEngine
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(10)
    eng = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**TEST_CFG_KW),
                    device="cpu")
    scan = [eng.add_frame(scene.render(TEST_K, rv[i], tv[i], 240, 320))
            for i in range(10)]
    made = [dict(status=np.int32(s), n_tracked=np.int32(40 + i),
                 n_keyframes=np.int32(3), n_landmarks=np.int32(100 - i),
                 keyframe_added=np.bool_(i == 2),
                 mean_reproj_err=np.float32(0.0 if s != 1 else 0.5 + i),
                 rvec=np.full(3, 0.1 * i, np.float32))
            for i, s in enumerate((0, 1, 1, 2, 2, 1))]
    return scan, made


def test_metrics_summary_and_jsonl_match_jax(tmp_path):
    from sfm_tpu.utils import summarize_metrics as jsummarize
    from sfm_tpu.utils import write_metrics_jsonl as jwrite
    from sfm_tpu_torch.utils import summarize_metrics, write_metrics_jsonl
    scan, made = _scan_metrics()
    assert int(scan[-1]["status"]) == 1
    for log in (scan, made, []):
        ours = summarize_metrics(log)
        assert ours == jsummarize(log)
        assert all(type(v) is type(jsummarize(log)[k])
                   for k, v in ours.items())
        write_metrics_jsonl(str(tmp_path / "ours.jsonl"), log)
        jwrite(str(tmp_path / "ref.jsonl"), log)
        assert ((tmp_path / "ours.jsonl").read_bytes()
                == (tmp_path / "ref.jsonl").read_bytes())
    assert summarize_metrics(made)["n_lost"] == 2
    assert len((tmp_path / "ours.jsonl").read_text()) == 0


def test_device_trace_writes_a_trace(tmp_path):
    import json

    import torch

    from sfm_tpu_torch.utils import device_trace
    logdir = tmp_path / "trace"
    a = torch.randn(64, 64)
    with device_trace(str(logdir)):
        (a @ a).sum()
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
