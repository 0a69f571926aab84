"""The port's one tracing system, and what reads it.

``RECORDER`` keeps spans and counters in memory.  ``span(name)`` records a
named stretch of host time with its parent (the innermost span open on the
same thread), its thread, and its start and end by ``time.time_ns()``:
the clock on which ``torch.profiler`` stamps its events, so a span lines
up with the card's kernels in a trace without being a profiler range (a
``record_function`` range would come back from the card as a device-side
annotation and count as device work).  ``count(name, n)`` adds to a
counter of the innermost open span.  ``to_host(convert, value)`` is the
one way the engine and the solvers read a device value on the host: it
returns ``convert(value)`` (``int``, ``bool``, a ``.cpu()`` or a
``.tolist()``), counts one ``host_reads`` and adds the seconds the host
was blocked to ``read_wait_s``.  Nothing here synchronises the card:
spans measure host time, and ``read_wait_s`` the host waiting for it.

Tracing is on while a ``torch.profiler`` session is active on the calling
thread, or while ``RECORDER.enabled()`` is open (then on every thread).
Off, a span, a count or a read costs one check and records nothing.  Each
profiler session, and each outermost ``enabled()``, starts a fresh
``Trace``: a reader after a traced window (``RECORDER.trace()``) sees that
window's spans alone.

Also here: ``PhaseTimer`` (per-instance sums of phases, which are spans of
the same recorder), ``device_trace`` (``torch.profiler`` around a region,
the program's spans written into its Chrome trace on a track of their own,
and the card's idle seconds summed by program span), and the aggregation
of the engine's per-frame metric dicts (``summarize_metrics``,
``write_metrics_jsonl``, copies of the JAX package's)."""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_profiler_enabled = torch.autograd._profiler_enabled


class Span:
    """One span: ``name``, ``parent`` (the enclosing Span on its thread, or
    None at a root), ``thread`` (the native thread id), ``start`` and
    ``end`` (ns since the epoch), and ``child_ns``, the time its children
    covered.  It is its own context manager."""

    __slots__ = ("name", "parent", "thread", "start", "end", "child_ns",
                 "_rec", "_trace", "_sink")

    def __init__(self, rec: "Recorder", name: str, trace, sink):
        self.name, self._rec, self._trace, self._sink = name, rec, trace, sink
        self.parent, self.thread, self.child_ns = None, 0, 0
        self.start = self.end = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def self_seconds(self) -> float:
        """Duration minus the time its child spans cover."""
        return (self.end - self.start - self.child_ns) / 1e9

    def __enter__(self):
        if self._trace is not None:
            local = self._rec._thread()
            stack = local.stack
            if stack and stack[-1]._trace is self._trace:
                self.parent = stack[-1]
            stack.append(self)
            self.thread = local.tid
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self._trace is not None:
            self._rec._close(self)
        if self._sink is not None:
            self._sink._add(self.name, self.end - self.start)
        return False


class Trace:
    """One window's closed spans (in the order they closed), the totals of
    each span name ([total ns, calls, self ns]) and the counters, keyed by
    (innermost span name or None, counter name)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.totals: Dict[str, List[int]] = {}
        self.counters: Dict[Tuple[Optional[str], str], float] = {}

    def total_s(self, name: str) -> float:
        return self.totals.get(name, (0, 0, 0))[0] / 1e9

    def self_s(self, name: str) -> float:
        return self.totals.get(name, (0, 0, 0))[2] / 1e9

    def calls(self, name: str) -> int:
        return self.totals.get(name, (0, 0, 0))[1]

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.parent is None]

    def root_s(self) -> float:
        """Seconds in root spans (each thread's outermost)."""
        return sum(s.end - s.start for s in self.roots()) / 1e9

    def nested_s(self, name: str, ancestor: str) -> float:
        """Seconds of the spans called ``name`` that some span called
        ``ancestor`` encloses."""
        ns = 0
        for s in self.spans:
            if s.name != name:
                continue
            p = s.parent
            while p is not None and p.name != ancestor:
                p = p.parent
            if p is not None:
                ns += s.end - s.start
        return ns / 1e9

    def counter(self, name: str, span: Optional[str] = "*") -> float:
        """A counter summed over every span ("*"), or within one innermost
        span name (None: outside any span)."""
        return sum(v for (s, c), v in self.counters.items()
                   if c == name and (span == "*" or s == span))


class Recorder:
    """Spans and counters of the running process (see the module's
    docstring); ``RECORDER`` is the one instance the port records into."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._explicit = 0
        self._session = None    # the thread whose profiler feeds the trace
        self._trace = Trace()

    # ---------------------------------------------------------- state

    def on(self) -> bool:
        """Whether this thread records now.  A profiler session first seen
        on this thread starts a fresh trace."""
        if self._explicit:
            return True
        if _profiler_enabled():
            if self._session is None:
                with self._lock:
                    self._session = threading.get_ident()
                    self._trace = Trace()
            return True
        if self._session is not None and \
                self._session == threading.get_ident():
            self._session = None
        return False

    @contextlib.contextmanager
    def enabled(self):
        """Record on every thread while open; the outermost ``enabled()``
        starts a fresh trace, which it yields."""
        with self._lock:
            if not self._explicit:
                self._trace = Trace()
            self._explicit += 1
            trace = self._trace
        try:
            yield trace
        finally:
            with self._lock:
                self._explicit -= 1

    def trace(self) -> Trace:
        """The current window's trace.  Read after a profiler session has
        stopped, it also ends that session: the next one starts afresh."""
        if not self._explicit and self._session == threading.get_ident() \
                and not _profiler_enabled():
            self._session = None
        return self._trace

    def _thread(self):
        """This thread's open spans (``stack``) and native id (``tid``,
        read once: a system call)."""
        local = self._tls
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
        return local

    # ---------------------------------------------------------- recording

    def span(self, name: str, sink=None):
        """A context manager recording ``name`` while tracing is on;
        ``sink`` (a ``PhaseTimer``) is handed every span's duration, on
        or off."""
        trace = self._trace if self.on() else None
        if trace is None and sink is None:
            return _OFF
        return Span(self, name, trace, sink)

    def _close(self, s: Span) -> None:
        stack = self._thread().stack
        while stack:
            if stack.pop() is s:
                break
        dur = s.end - s.start
        if s.parent is not None:
            s.parent.child_ns += dur
        tr = s._trace
        with self._lock:
            tr.spans.append(s)
            t = tr.totals.get(s.name)
            if t is None:
                t = tr.totals[s.name] = [0, 0, 0]
            t[0] += dur
            t[1] += 1
            t[2] += dur - s.child_ns

    def _add(self, counts) -> None:
        stack = self._thread().stack
        trace = self._trace
        where = stack[-1].name if stack and stack[-1]._trace is trace \
            else None
        with self._lock:
            for name, n in counts:
                key = (where, name)
                trace.counters[key] = trace.counters.get(key, 0) + n

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span."""
        if self.on():
            self._add(((name, n),))

    def to_host(self, convert, value):
        """``convert(value)``: a device-to-host read, counted in
        ``host_reads``, the seconds it blocked in ``read_wait_s``."""
        if not self.on():
            return convert(value)
        t0 = time.time_ns()
        out = convert(value)
        self._add((("host_reads", 1),
                   ("read_wait_s", (time.time_ns() - t0) / 1e9)))
        return out


_OFF = contextlib.nullcontext()
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
to_host = RECORDER.to_host


class PhaseTimer:
    """Accumulates wall time per named phase, whatever the tracing state;
    each phase is a span of ``RECORDER``.  Use as
    ``with timer.phase("tracking"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def phase(self, name: str):
        return RECORDER.span(name, sink=self)

    def _add(self, name: str, ns: int) -> None:
        self.totals[name] += ns / 1e9
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


# ---------------------------------------------------------------- traces

# the Chrome trace's process that holds the program's spans
SPAN_PID = 1 << 30
_BASE = re.compile(rb'"baseTimeNanoseconds":\s*(\d+)')


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_by_span(device, spans, lo: int, hi: int) -> List[Tuple[str, float]]:
    """The card's idle seconds in [lo, hi] (ns) summed by the innermost
    program span open at each idle gap's middle ("outside" where none is),
    most first.  ``device``: (start, end) ns of its kernels, copies and
    fills; ``spans``: closed ``Span``s."""
    busy = _union((max(s, lo), min(e, hi)) for s, e in device
                  if e > lo and s < hi)
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    by: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        best = None
        for sp in spans:
            if sp.start <= mid <= sp.end and (
                    best is None or sp.end - sp.start < best.end - best.start):
                best = sp
        name = best.name if best is not None else "outside"
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return sorted(by.items(), key=lambda kv: -kv[1])


def _device_intervals(prof) -> List[Tuple[int, int]]:
    """(start, end) ns of the card's kernels, copies and fills in a stopped
    profiler's results (a device-side annotation is no work)."""
    from torch.autograd import DeviceType
    return [(ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA
            and not ev.is_user_annotation()]


def add_spans_to_chrome_trace(path: str, spans) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    of process ``SPAN_PID`` ("program spans"), one row per thread, on the
    trace's own clock.  They go in at the end of its event list, which is
    the last list in the file: only the file's head and tail are read,
    however long the trace."""
    with open(path, "rb+") as f:
        head = f.read(1 << 16)
        at = max(0, f.seek(0, os.SEEK_END) - (1 << 16))
        f.seek(at)
        tail = f.read()
        m = _BASE.search(head) or _BASE.search(tail)
        base = int(m.group(1)) if m else 0
        end = tail.rfind(b"]")
        rest = tail[end + 1:].strip()
        if end < 0 or b"[" in rest or b'"traceEvents"' not in head + tail:
            raise ValueError(f"{path}: not a Chrome trace")
        json.loads(b"{" + rest.lstrip(b","))   # the trailer: keys alone
        events = [{"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": "program spans"}}]
        events += [{"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": SPAN_PID, "tid": s.thread,
                    "ts": (s.start - base) / 1e3,
                    "dur": (s.end - s.start) / 1e3,
                    "args": {"parent": s.parent.name if s.parent else None,
                             "self_ms": 1e3 * s.self_seconds}}
                   for s in spans]
        sep = b"" if tail[:end].rstrip().endswith(b"[") else b","
        f.seek(at + end)
        f.write(sep + b",".join(json.dumps(e).encode() for e in events)
                + tail[end:])
        f.truncate()


class DeviceTrace:
    """What ``device_trace`` leaves: the trace file's ``path``, the
    program's spans (``trace``), and on a card the idle seconds by
    innermost program span (``idle_by_span``)."""

    def __init__(self):
        self.path: Optional[str] = None
        self.trace: Optional[Trace] = None
        self.idle_by_span: List[Tuple[str, float]] = []


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` around a region: the host's operators and, where
    a card is present, its kernels and copies, written on exit as a Chrome
    trace ``trace_<pid>_<ns>.json`` into ``logdir`` (open it in Perfetto
    or chrome://tracing), with the program's spans, recorded throughout,
    on a track of their own.  On a card it prints the card's idle seconds
    summed by innermost program span.  Yields a ``DeviceTrace``."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    out = DeviceTrace()
    prof = profile(activities=activities)
    with RECORDER.enabled() as trace:
        out.trace = trace
        prof.start()
        # the results are read from kineto_results: the per-event Python
        # objects the profiler would build on stop are not asked for
        prof.profiler._parse_kineto_results = lambda results: []
        lo = time.time_ns()
        try:
            yield out
        finally:
            if on_card:
                torch.cuda.synchronize()
            hi = time.time_ns()
            prof.stop()
    out.path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)
    add_spans_to_chrome_trace(out.path, trace.spans)
    if on_card:
        out.idle_by_span = idle_by_span(_device_intervals(prof), trace.spans,
                                        lo, hi)
        print(f"device_trace: {(hi - lo) / 1e9:.3f} s; the card idle by "
              "program span: " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in out.idle_by_span),
              file=sys.stderr)


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
