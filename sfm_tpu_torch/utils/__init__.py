"""Utilities: host-side phase timing, device traces and scan metrics."""

from .profiling import (PhaseTimer, device_trace, summarize_metrics,
                        write_metrics_jsonl)
