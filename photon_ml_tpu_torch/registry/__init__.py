"""Model registry: validation-gated continuous retraining (port of
``photon_ml_tpu/registry/``, with the same exports).

- :mod:`registry.registry` — generation-numbered lineage store with
  crash-atomic publish (stage -> rename -> commit marker), a
  single-writer lease, refusal records for gate-failed candidates,
  quarantine for rolled-back generations, and retention GC. Its files
  are the reference's: either package reads the other's registry.
- :mod:`registry.stats_cache` — append-only per-partition scan/stats
  cache: incremental retrains re-read only NEW partitions (counted).
- :mod:`registry.warm_start` — drift-safe alignment of a parent
  generation's coefficients to a retrain's feature/entity spaces
  (bitwise pass-through when nothing drifted).
- :mod:`registry.gates` — candidate-vs-parent promotion gates over a
  streamed holdout; one named terminal verdict per publish attempt.
- :mod:`registry.watcher` — serving-side promotion + auto-rollback.

Importing the package does not import torch: the publisher is host code,
and a process that only publishes or reads the registry (a kill-matrix
child, a cron tick) starts in well under a second. The stats cache,
which needs torch, loads on first use of one of its names.
"""

from photon_ml_tpu_torch.registry.gates import (
    GateConfig,
    GateReport,
    coef_norm_gate,
    evaluate_gates,
)
from photon_ml_tpu_torch.registry.registry import (
    PUBLISH_SEAM,
    GenerationInfo,
    ModelRegistry,
    RefusedCandidate,
    RegistryLeaseHeld,
    content_signature,
)
from photon_ml_tpu_torch.registry.warm_start import (
    DriftReport,
    align_coefficients,
    align_re_bank,
    warm_start_game_model,
)
from photon_ml_tpu_torch.registry.watcher import (
    HealthWindow,
    RegistryWatcher,
    RollbackPolicy,
)

_STATS_CACHE_NAMES = (
    "STATS_CACHE_SEAM",
    "STATS_CACHE_VERSION",
    "PartitionStatsCache",
    "ScanCacheStats",
    "cached_scan_stream",
    "cached_scan_stream_with_summary",
)


def __getattr__(name):
    if name in _STATS_CACHE_NAMES:
        from photon_ml_tpu_torch.registry import stats_cache

        return getattr(stats_cache, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PUBLISH_SEAM",
    "GenerationInfo",
    "ModelRegistry",
    "RefusedCandidate",
    "RegistryLeaseHeld",
    "content_signature",
    *_STATS_CACHE_NAMES,
    "DriftReport",
    "align_coefficients",
    "align_re_bank",
    "warm_start_game_model",
    "GateConfig",
    "GateReport",
    "coef_norm_gate",
    "evaluate_gates",
    "HealthWindow",
    "RegistryWatcher",
    "RollbackPolicy",
]
