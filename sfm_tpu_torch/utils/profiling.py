"""Host-side phase timing (``PhaseTimer``, a copy of the JAX package's):
wall time and call counts per named phase."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
