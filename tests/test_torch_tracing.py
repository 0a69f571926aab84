"""The port's recorder (``sfm_tpu_torch.utils.profiling``) on the CPU: span
trees and self time, per-thread stacks, nothing recorded or synchronised
with tracing off, the profiler's clock, one window per profiler session,
repeatable read counts, ``device_trace``'s span track, and the benchmark's
per-layer metrics that read the recorder, at the CPU tests' small sizes
(``portbench/tests/small.py``)."""

import json
import math
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K, to_t

from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import SfMEngine
from sfm_tpu_torch.engine.state import CameraParams
from sfm_tpu_torch.parallel.pipeline import AsyncMappingEngine
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.utils import profiling
from sfm_tpu_torch.utils.profiling import (RECORDER, PhaseTimer, count,
                                           device_trace, idle_by_span, span,
                                           to_host)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the benchmark's per-layer metrics that read the recorder, by cell
NEW_METRICS = {
    "flagship.scan": ("tracking_pct.scan", "mapping_pct.scan",
                      "host_reads_per_frame.scan", "read_wait_pct.scan"),
    "ba1k.solve": ("read_wait_pct.ba", "pcg_pct.ba",
                   "host_reads_per_iter.ba"),
}
N_FRAMES, CHUNK = 24, 6


@pytest.fixture(scope="module")
def frames():
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(N_FRAMES)
    return np.stack([scene.render(TEST_K, rv[i], tv[i], 240, 320)
                     for i in range(N_FRAMES)])


def _scan(frames, seed=0):
    """A chunked scan of ``frames`` on a new engine, traced; its trace."""
    eng = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**TEST_CFG_KW),
                    device="cpu", seed=seed)
    with RECORDER.enabled() as trace:
        for c in range(0, len(frames), CHUNK):
            out = eng.add_frames(frames[c:c + CHUNK])
    assert int(out[-1]["status"]) == 1
    return trace


def _busy(ms):
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


def test_nested_spans_link_parents_and_keep_self_time():
    with RECORDER.enabled() as trace:
        with span("a"):
            _busy(2)
            with span("b"):
                _busy(3)
                with span("c"):
                    _busy(2)
                    count("things", 2)
            with span("b"):
                _busy(1)
            count("things")
    by = {}
    for s in trace.spans:
        by.setdefault(s.name, []).append(s)
    (a,), (c,) = by["a"], by["c"]
    assert [s.parent for s in by["b"]] == [a, a] and c.parent is by["b"][0]
    assert a.parent is None and trace.roots() == [a]
    for s in trace.spans:
        if s.parent is not None:
            assert s.parent.start <= s.start <= s.end <= s.parent.end
    kids = sum(s.end - s.start for s in by["b"])
    assert a.child_ns == kids
    assert a.self_seconds == pytest.approx((a.end - a.start - kids) / 1e9)
    assert trace.calls("b") == 2
    assert trace.total_s("b") == pytest.approx(kids / 1e9)
    assert trace.self_s("b") == pytest.approx(
        (kids - (c.end - c.start)) / 1e9)
    assert trace.root_s() == pytest.approx(a.seconds)
    assert trace.nested_s("c", "a") == pytest.approx(c.seconds)
    assert trace.nested_s("a", "c") == 0
    # each counter lands in the innermost span open where it was counted
    assert trace.counter("things", "c") == 2
    assert trace.counter("things", "a") == 1
    assert trace.counter("things") == 3


def test_each_thread_keeps_its_own_stack(frames):
    """AsyncMappingEngine maps on a worker thread while the caller tracks:
    every span's parent is on its own thread, and the worker's mapping
    passes hang under the worker's "mapping" phase, never under the
    caller's tracking."""
    K = to_t(TEST_K)
    eng = AsyncMappingEngine(SfMConfig(**TEST_CFG_KW),
                             CameraParams(K=K, d=torch.zeros(5), Kopt=K),
                             merge_lag=2, device="cpu")
    with RECORDER.enabled() as trace:
        for f in frames:
            eng.step(f)
        eng.flush()
    main = threading.get_native_id()
    for s in trace.spans:
        if s.parent is not None:
            assert s.parent.thread == s.thread
            assert s.parent.start <= s.start <= s.end <= s.parent.end
    maps = [s for s in trace.spans if s.name == "engine.mapping"]
    assert len(maps) == eng.timer.counts["mapping"] >= 2
    for s in maps:
        assert s.thread != main
        assert s.parent is not None and s.parent.name == "mapping"
        assert s.parent.parent is None
    tracks = [s for s in trace.spans if s.name == "engine.track"]
    assert tracks and all(s.thread == main for s in tracks)
    assert all(s.parent.name == "tracking" for s in tracks)


def test_tracing_off_records_nothing_and_never_synchronises(frames,
                                                            monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    assert not RECORDER.on()
    trace = RECORDER.trace()
    spans, counters = list(trace.spans), dict(trace.counters)
    eng = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**TEST_CFG_KW),
                    device="cpu")
    for c in range(0, 12, CHUNK):
        eng.add_frames(frames[c:c + CHUNK])
    with span("x") as s:
        count("things")
        assert to_host(int, torch.tensor(3)) == 3
    assert s is None
    assert RECORDER.trace() is trace
    assert trace.spans == spans and trace.counters == counters
    # on, the recorder still never synchronises (on a card or not)
    _scan(frames[:12])
    assert calls == []


def test_spans_share_the_profilers_clock():
    """A span opened under an active torch.profiler holds the profiler's
    own aten:: op intervals, on the same clock, within 0.1 ms, and leaves
    no annotation of its own in the profiler's results."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert RECORDER.on()
        with span("outer") as s:
            for _ in range(5):
                a = torch.tanh(a @ a)
    assert RECORDER.trace().spans == [s]
    ops = [(e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 5
    for start, end in ops:
        assert s.start - 100_000 <= start <= end <= s.end + 100_000
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.is_user_annotation()]


def test_a_second_traced_window_reads_only_its_own_spans():
    from portbench.run import run_cell
    from portbench.tests import small
    run_cell("ba1k.solve", 2 ** 31 + 11, 0.3, 1, device="cpu",
             overrides=small.BA)
    first = RECORDER.trace()
    assert first.calls("ba.solve") >= 1
    t0 = time.time_ns()
    run_cell("ba1k.solve", 2 ** 31 + 12, 0.3, 1, device="cpu",
             overrides=small.BA)
    second = RECORDER.trace()
    assert second is not first and second.spans
    assert all(s.start >= t0 for s in second.spans)


def test_the_same_scan_counts_the_same_reads(frames):
    # the first frame described in a process copies the descriptor's
    # tables to the device once
    _scan(frames[:CHUNK])
    one, two = _scan(frames, seed=5), _scan(frames, seed=5)
    for name in ("host_reads", "implicit_sync"):
        assert one.counter(name) == two.counter(name) > 0, name
    # the frames are already on the engine's device: nothing is uploaded
    assert one.counter("uploads") == 0
    assert {k: v[1] for k, v in one.totals.items()} \
        == {k: v[1] for k, v in two.totals.items()}
    # the root spans are the chunks, and the children cover the stages
    assert [s.name for s in one.roots()] == ["engine.add_frames"] * (
        N_FRAMES // CHUNK)
    for name in ("engine.upload", "engine.make_frame", "engine.bootstrap",
                 "engine.track", "track.match", "track.pnp", "track.widen",
                 "track.refine", "track.keyframe", "engine.mapping",
                 "mapping.triangulate", "mapping.reobserve", "mapping.cull",
                 "mapping.tables", "ba.solve", "engine.fetch"):
        assert one.calls(name) > 0, name


def test_phase_timer_phases_are_spans():
    timer = PhaseTimer()
    with RECORDER.enabled() as trace:
        with timer.phase("outer"):
            with span("inner"):
                _busy(1)
    assert timer.counts["outer"] == 1
    (inner, outer) = trace.spans
    assert inner.parent is outer and outer.name == "outer"
    assert timer.totals["outer"] == pytest.approx(outer.seconds)
    # off, the timer still times its phases, and nothing is recorded
    with timer.phase("outer"):
        pass
    assert timer.counts["outer"] == 2 and len(trace.spans) == 2


def test_device_trace_writes_the_spans_on_their_own_track(tmp_path):
    a = torch.randn(96, 96)
    with device_trace(str(tmp_path)) as tr:
        with span("work"):
            for _ in range(3):
                a = torch.tanh(a @ a)
    doc = json.loads(Path(tr.path).read_text())
    events = doc["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["work"]
    assert all(e["pid"] == profiling.SPAN_PID for e in mine)
    names = [e for e in events if e.get("ph") == "M"
             and e.get("pid") == profiling.SPAN_PID]
    assert names[0]["args"]["name"] == "program spans"
    (w,) = mine
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mm) == 3
    for e in mm:
        assert w["ts"] - 0.1e3 <= e["ts"] <= e["ts"] + e["dur"] \
            <= w["ts"] + w["dur"] + 0.1e3
    assert tr.trace.calls("work") == 1


def _s(name, start, end, parent=None):
    s = profiling.Span(RECORDER, name, None, None)
    s.start, s.end, s.parent = start, end, parent
    return s


def test_idle_gaps_are_summed_by_the_innermost_program_span():
    outer = _s("engine.add_frames", 0, 100)
    spans = [outer, _s("engine.track", 10, 40, outer),
             _s("track.match", 10, 20)]
    device = [(12, 18), (30, 35), (95, 120)]
    # the gaps and the innermost span at their middles: [0, 12) at 6 and
    # [35, 95) at 65 add_frames, [18, 30) at 24 engine.track (past
    # track.match's end), [120, 130) outside every span
    got = dict(idle_by_span(device, spans, 0, 130))
    ns = 1e-9
    assert got == pytest.approx({"engine.add_frames": (12 + 60) * ns,
                                 "engine.track": 12 * ns,
                                 "outside": 10 * ns})


@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_a_traced_cpu_run_reports_every_new_metric(cell):
    from portbench.run import run_cell
    from portbench.tests import small
    r = run_cell(cell, 2 ** 31 + 21, 3.0, 1, device="cpu",
                 overrides=small.overrides(cell))
    for name in NEW_METRICS[cell]:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
    if cell == "ba1k.solve":
        # one read an LM iteration, and the two stats' copies each solve
        iters = 8
        assert r["metrics"]["host_reads_per_iter.ba"]["value"] \
            == pytest.approx(1 + 2 / iters)
        assert 0 < r["metrics"]["pcg_pct.ba"]["value"] < 100
    else:
        tr = RECORDER.trace()
        assert tr.self_s("engine.add_frames") <= 0.05 * tr.root_s()


def test_the_readers_report_nothing_without_the_recorder(monkeypatch):
    """Laid over a port that records no span (no ``RECORDER``), each new
    reader returns None and raises nothing."""
    from portbench import core
    monkeypatch.setitem(sys.modules, "sfm_tpu_torch.utils.profiling",
                        types.ModuleType("sfm_tpu_torch.utils.profiling"))
    record = {"frames": [{}] * 4, "lm_iterations": 8, "window_s": 1.0}
    for cell, names in NEW_METRICS.items():
        c = core.Cell(cell, ROOT)
        for name in names:
            assert c.reader(name).read(record) is None, name
