"""Many scans at once: the multi-scan fleet (``multiscan``)."""

from .multiscan import (MultiScanDriver, build_batched_step,
                        init_batched_state, map_one, scan_generator)

__all__ = ["MultiScanDriver", "build_batched_step", "init_batched_state",
           "map_one", "scan_generator"]
