"""Many scans at once: the multi-scan fleet (``multiscan``), split over
ranks by ``build_sharded_step``; one scan with its mapping passes
overlapping its tracking (``pipeline``); and landmark-sharded distributed
bundle adjustment over ``torch.distributed`` (``dist_ba``,
``dist_large_ba``) on the ranks and mesh of ``hosts``."""

from .multiscan import (MultiScanDriver, build_batched_step,
                        build_sharded_step, init_batched_state, map_one,
                        scan_generator, shard_batched_state)
from .pipeline import AsyncMappingEngine, merge_mapping_result
from .dist_ba import build_dist_ba, partition_observations
from .dist_large_ba import build_dist_large_ba, partition_tables
from .hosts import initialize_hosts, make_scan_map_mesh, rank_device

__all__ = ["AsyncMappingEngine", "MultiScanDriver", "build_batched_step",
           "build_dist_ba", "build_dist_large_ba", "build_sharded_step",
           "init_batched_state", "initialize_hosts", "make_scan_map_mesh",
           "map_one", "merge_mapping_result", "partition_observations",
           "partition_tables", "rank_device", "scan_generator",
           "shard_batched_state"]
