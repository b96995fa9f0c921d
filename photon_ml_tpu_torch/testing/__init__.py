"""Test-support runtime: the deterministic interleaving harness and the
hash-seed twin-run reproducibility harness (port of
``photon_ml_tpu/testing``, with the same exports).

Importable from test code and the chip script; never imported by the
serving or registry modules themselves.
"""

from photon_ml_tpu_torch.testing.determinism import (
    TwinRunError,
    TwinRunResult,
    byte_diff_trees,
    run_matrix,
    run_target,
    stable_seed,
    twin_run,
)
from photon_ml_tpu_torch.testing.interleave import (
    DeadlockError,
    InterleaveScheduler,
    StepBudgetExceeded,
    explore,
)

__all__ = [
    "DeadlockError",
    "InterleaveScheduler",
    "StepBudgetExceeded",
    "TwinRunError",
    "TwinRunResult",
    "byte_diff_trees",
    "explore",
    "run_matrix",
    "run_target",
    "stable_seed",
    "twin_run",
]
