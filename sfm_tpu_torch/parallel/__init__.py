"""Many scans at once: the multi-scan fleet (``multiscan``); and one scan
with its mapping passes overlapping its tracking (``pipeline``)."""

from .multiscan import (MultiScanDriver, build_batched_step,
                        init_batched_state, map_one, scan_generator)
from .pipeline import AsyncMappingEngine, merge_mapping_result

__all__ = ["AsyncMappingEngine", "MultiScanDriver", "build_batched_step",
           "init_batched_state", "map_one", "merge_mapping_result",
           "scan_generator"]
