"""Input data validation (port of ``photon_ml_tpu/data/validators.py``).

Reference: photon-ml .../data/DataValidators.scala:139: per-task row
validators (finite features/offsets/labels, binary labels for
classification, non-negative labels for Poisson) run at
``VALIDATE_FULL`` / ``VALIDATE_SAMPLE`` / ``VALIDATE_DISABLED`` levels
(sanity checks fail the job with a summary of violations).

Each check is a reduction over the batch on its device; the counts come
back in one fetch, and the driver raises with counts instead of per-row
messages.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.task import TaskType


class DataValidationType(enum.Enum):
    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"

    @classmethod
    def parse(cls, s: str) -> "DataValidationType":
        return cls(s.strip().upper())


class DataValidationError(ValueError):
    pass


def _sample(batch: SparseBatch, fraction: float = 0.1) -> SparseBatch:
    """Deterministic head-sample (the reference samples a fraction for
    VALIDATE_SAMPLE; determinism matters more than randomness here)."""
    n = max(8, int(batch.weights.shape[0] * fraction))
    return SparseBatch(
        *(getattr(batch, f.name)[:n] for f in dataclasses.fields(batch))
    )


def validation_failures(batch: SparseBatch, task: TaskType) -> Dict[str, int]:
    """-> {check name: violation count}, empty when clean."""
    real = batch.weights > 0
    checks = {
        "features_finite": (~torch.isfinite(batch.values)).any(dim=-1),
        "offsets_finite": ~torch.isfinite(batch.offsets),
        "labels_finite": ~torch.isfinite(batch.labels),
        "weights_finite": ~torch.isfinite(batch.weights),
    }
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        checks["labels_binary"] = ~((batch.labels == 0.0) | (batch.labels == 1.0))
    if task == TaskType.POISSON_REGRESSION:
        checks["labels_non_negative"] = batch.labels < 0
    # one fetch for every check's count
    counts = torch.stack([(bad & real).sum() for bad in checks.values()]).tolist()
    return {name: int(c) for name, c in zip(checks, counts) if c}


def sanity_check_data(
    batch: SparseBatch,
    task: TaskType,
    level: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    """Raise DataValidationError listing violated checks
    (DataValidators.sanityCheckData)."""
    if level == DataValidationType.VALIDATE_DISABLED:
        return
    if level == DataValidationType.VALIDATE_SAMPLE:
        batch = _sample(batch)
    failures = validation_failures(batch, task)
    if failures:
        desc = ", ".join(f"{k}: {v} rows" for k, v in sorted(failures.items()))
        raise DataValidationError(f"input data failed validation ({desc})")
