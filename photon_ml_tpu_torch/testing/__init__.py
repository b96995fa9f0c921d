"""Test-support runtime: the deterministic interleaving harness (port of
``photon_ml_tpu/testing``, its interleaving part).

Importable from test code; never imported by the serving modules
themselves.
"""

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
    "explore",
]
