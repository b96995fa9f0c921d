"""The model registry's pieces that the port has (port of
``photon_ml_tpu/registry/``): the per-partition scan/stats cache behind
the GLM driver's ``--scan-cache-dir``. Publishing, warm starts, gates and
the watcher wait for ROADMAP item 15."""

from photon_ml_tpu_torch.registry.stats_cache import (
    STATS_CACHE_SEAM,
    STATS_CACHE_VERSION,
    PartitionStatsCache,
    ScanCacheStats,
    cached_scan_stream,
    cached_scan_stream_with_summary,
)

__all__ = [
    "STATS_CACHE_SEAM",
    "STATS_CACHE_VERSION",
    "PartitionStatsCache",
    "ScanCacheStats",
    "cached_scan_stream",
    "cached_scan_stream_with_summary",
]
