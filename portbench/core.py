"""The harness's own machinery, shared by every cell: finding a cell's
files by name, the host spans, the reduction of a profiler trace to the
record the metric readers read, and the result line.

Nothing here knows a cell, a traffic mix or a metric by name: those are
files under ``configs/``, ``traffic/``, ``drivers/``, ``metrics/`` and
``limits/``, found from ``BENCHMARK.json``."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sfm_tpu")

# the harness's host spans, outermost first; an idle gap of the card is
# labelled by the innermost one open at the time
SPANS = ("window", "new_scan", "add_frames", "run_large_ba")

def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything found by its names:
    the configuration, the traffic mix, its driver, the limits of the
    comparison, and the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(work)})")
        self.bench, self.entry, self.name = bench, work[name], name
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(root / cfg["file"])
        base = root / "portbench"
        self.traffic = load_json(base / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.limits = load_json(base / "limits" / f"{name}.json")
        self.metrics_dir = base / "metrics"
        self.chips = int(self.entry["chips"])

    def metrics(self, traced: bool) -> list:
        """The cell's metric entries: end-to-end untraced, per-layer
        traced; an entry with ``workloads`` only where it lists the cell."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")

    def reader(self, metric: str):
        """``metrics/<metric>.py``, or where a quantity is split by the
        end-to-end metric it moves (``device_idle_pct.scan``,
        ``device_idle_pct.ba``) and read alike, ``metrics/<quantity>.py``."""
        path = self.metrics_dir / f"{metric}.py"
        if not path.exists():
            path = self.metrics_dir / f"{metric.split('.')[0]}.py"
        return load_module(path, "portbench_metric_" + metric.replace(".", "_"))


class Spans:
    """``span(name)``: a ``record_function`` range in a traced run, nothing
    otherwise."""

    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def forbidden_loaded(modules=None) -> list:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name, compared whole, is one of ``FORBIDDEN_MODULES``."""
    return sorted({m for m in (sys.modules if modules is None else modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def power_limit_w():
    """The card's power limit in W by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split("\n")[0]
        return float(out)
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------------ trace

def _plain(name: str) -> str:
    """A demangled kernel name without its return type and the anonymous
    namespace."""
    n = name.replace("(anonymous namespace)::", "").strip()
    return n[5:] if n.startswith("void ") else n


def kernel_base(name: str) -> str:
    """The identifier of a demangled kernel name, without namespaces,
    template arguments or parameters."""
    head = _plain(name).split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


def kernel_file(name: str):
    """The ``csrc/`` stem of one of the port's kernels (``match``,
    ``patches``, ``linearize``, ``schur``), or None for any other kernel.
    schur.cu's landmark_phase is a template and its camera_phase takes
    (q, slots, offsets, y); linearize.cu's are neither."""
    base, n = kernel_base(name), _plain(name)
    if base in ("dense_kernel", "cells_kernel", "init_keys",
                "epilogue_kernel"):
        return "match"
    if base == "patch_kernel":
        return "patches"
    if base == "landmark_phase":
        return "schur" if "<" in n.split("(", 1)[0] else "linearize"
    if base == "camera_phase":
        args = n[n.find("("):].replace(" ", "")
        return "schur" if args.startswith("(floatconst*,intconst*") \
            else "linearize"
    return None


def union_length(intervals) -> float:
    """The length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def label_of(t: float, spans: list) -> str:
    """The innermost harness span (start, end, name) open at time t."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "outside"


def reduce_events(device_events, span_events) -> dict:
    """The traced record from the profiler's events: ``device_events``
    [(start_s, end_s, name)] of the card's kernels, copies and fills,
    ``span_events`` [(start_s, end_s, name)] of the harness's spans, one
    of them "window".  Times are in seconds on one clock.  ``idle_gaps``:
    the card's idle seconds summed by what the host was doing (the
    innermost span open at each gap's middle), most first."""
    win = [(s, e) for s, e, n in span_events if n == "window"]
    if len(win) != 1:
        raise RuntimeError(f"expected one window span, found {len(win)}")
    lo, hi = win[0]
    dev = [(s, e, n) for s, e, n in device_events if e > lo and s < hi]
    busy_iv = clip([(s, e) for s, e, _ in dev], lo, hi)
    by_name, calls = {}, {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo))
        calls[n] = calls.get(n, 0) + 1
    by_label = {}
    for s, e in idle_gaps(busy_iv, lo, hi):
        label = label_of(0.5 * (s + e), span_events)
        by_label[label] = by_label.get(label, 0.0) + (e - s)
    return dict(
        window_s=hi - lo, busy_s=union_length(busy_iv), device_time=by_name,
        device_calls=calls,
        idle_gaps=sorted(([k, v] for k, v in by_label.items()),
                         key=lambda kv: -kv[1])[:10])


def start_profiler(on_card: bool):
    """A started ``torch.profiler.profile`` of the host and, on a card,
    the device.  Its results are read from ``kineto_results`` in memory
    (``trace_events``): the per-event Python objects that some versions
    of the profiler build when it stops (millions in a traced window,
    minutes of host time) are not asked for."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    prof.profiler._parse_kineto_results = lambda results: []
    return prof


def trace_events(prof):
    """(device events, harness span events) of a stopped profiler, in
    seconds from the start of its trace."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    for ev in res.events():
        if ev.device_type() == DeviceType.CUDA:
            name = ev.name()
            # the card's kernels, copies and fills (a span's device-side
            # echo is no work)
            if not (name in SPANS and ev.is_user_annotation()):
                dev.append(((ev.start_ns() - t0) * 1e-9,
                            (ev.end_ns() - t0) * 1e-9, name))
        elif ev.is_user_annotation() and ev.name() in SPANS:
            spans.append(((ev.start_ns() - t0) * 1e-9,
                          (ev.end_ns() - t0) * 1e-9, ev.name()))
    return dev, spans


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["device_time"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": trace["idle_gaps"]}


def is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def idle_pct(record):
    """The card's idle share of the traced window, in %."""
    t = record.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def ba_shape(record):
    """(L, kmax, live slots, C) of a BA cell's problem: every landmark is
    seen by ``obs_per_landmark`` cameras, every slot live."""
    p = record["config"]["problem"]
    L, kmax = int(p["landmarks"]), int(p["obs_per_landmark"])
    return L, kmax, L * kmax, int(p["cameras"])


def file_time(record, stem):
    """Device seconds of the kernels of ``csrc/<stem>.cu`` in the traced
    window."""
    t = record.get("trace")
    if not t:
        return 0.0
    return sum(s for n, s in t["device_time"].items()
               if kernel_file(n) == stem)
