"""Tracing and profiling hooks: a phase timer that sums host wall time per
named phase (``PhaseTimer``, a copy of the JAX package's), a context
manager around ``torch.profiler`` that writes a trace (``device_trace``),
and the aggregation of the engine's per-frame metric dicts into a scan
report and a JSON-lines file (``summarize_metrics``,
``write_metrics_jsonl``, copies of the JAX package's)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class PhaseTimer:
    """Accumulates wall time per named phase.  Use as
    ``with timer.phase("tracking"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000.0 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def report(self) -> str:
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        return "\n".join(
            f"{k:24s} {v['count']:6d} calls  {v['mean_ms']:8.2f} ms/call  "
            f"{v['total_s']:8.2f} s total" for k, v in rows)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` around a region: the host's operators and, where
    a card is present, its kernels and copies, written on exit as a Chrome
    trace ``trace_<pid>_<ns>.json`` into ``logdir`` (open it in Perfetto
    or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def summarize_metrics(metrics_log: List[dict]) -> dict:
    """Aggregate the engine's per-frame metric dicts into a scan report."""
    if not metrics_log:
        return {}
    arr = {k: np.asarray([m[k] for m in metrics_log])
           for k in metrics_log[0]}
    status = arr["status"]
    running = status == 1
    out = {
        "n_frames": len(metrics_log),
        "n_running": int(running.sum()),
        "n_lost": int((status == 2).sum()),
        "n_keyframes_final": int(arr["n_keyframes"][-1]),
        "n_landmarks_final": int(arr["n_landmarks"][-1]),
        "keyframes_added": int(arr["keyframe_added"].sum()),
        "mean_tracked": float(arr["n_tracked"][running].mean())
        if running.any() else 0.0,
        "mean_reproj_err": float(
            arr["mean_reproj_err"][arr["mean_reproj_err"] > 0].mean())
        if (arr["mean_reproj_err"] > 0).any() else 0.0,
    }
    return out


def write_metrics_jsonl(path: str, metrics_log: List[dict]) -> None:
    """One JSON line per frame's metric dict (arrays as lists)."""
    with open(path, "w") as f:
        for m in metrics_log:
            f.write(json.dumps(
                {k: (v.tolist() if hasattr(v, "tolist") else v)
                 for k, v in m.items()}) + "\n")
