"""Reliability layer: deterministic fault injection, retrying IO, and
crash-safe resume primitives shared by every driver (port of
``photon_ml_tpu/reliability``, with the same exports, seams and files).

- :mod:`photon_ml_tpu_torch.reliability.faults` — named injection points +
  the seeded fault plan (``--fault-plan`` / ``PHOTON_FAULT_PLAN``).
- :mod:`photon_ml_tpu_torch.reliability.retry` — :func:`io_call` (bounded
  backoff per seam), :class:`SeamFailure`, poisoned-artifact quarantine,
  and the metrics.json accounting block.
- :mod:`photon_ml_tpu_torch.reliability.artifacts` — atomic write-rename for
  every artifact.
- :mod:`photon_ml_tpu_torch.reliability.manifest` — run/store manifests for
  resume compatibility + progress.
- :mod:`photon_ml_tpu_torch.reliability.checkpoint` — per-λ grid snapshots
  (GLM) and per-iteration streaming-CD snapshots (GAME).
"""

from photon_ml_tpu_torch.reliability.artifacts import (  # noqa: F401
    atomic_write_bytes,
    atomic_write_json,
    atomic_write_text,
    atomic_writer,
)
from photon_ml_tpu_torch.reliability.checkpoint import (  # noqa: F401
    GridCheckpointer,
    StreamingCDCheckpointer,
)
from photon_ml_tpu_torch.reliability.faults import (  # noqa: F401
    SEAMS,
    FaultPlan,
    InjectedCorruption,
    InjectedFault,
    fault_stats,
    inject,
    install_plan,
    reset_fault_stats,
)
from photon_ml_tpu_torch.reliability.manifest import (  # noqa: F401
    ensure_run_manifest,
    read_manifest,
    write_manifest,
)
from photon_ml_tpu_torch.reliability.retry import (  # noqa: F401
    RetryPolicy,
    SeamFailure,
    io_call,
    policy_for,
    quarantine_artifact,
    reliability_metrics,
    reset_retry_stats,
    retry_stats,
)
