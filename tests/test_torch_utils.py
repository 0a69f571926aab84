"""``sfm_tpu_torch.utils.PhaseTimer`` against the JAX package's on the same
phases and the same clock readings."""

import itertools
import time

from sfm_tpu.utils import PhaseTimer as JPhaseTimer
from sfm_tpu_torch.utils import PhaseTimer


def _drive(timer_cls, monkeypatch):
    # a clock that advances 0.25 s per reading: each phase lasts 0.25 s
    clock = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: 0.25 * next(clock))
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
