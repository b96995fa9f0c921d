"""Training task types (port of ``photon_ml_tpu/task.py``).

Reference: photon-ml .../supervised/TaskType.scala (LINEAR_REGRESSION,
POISSON_REGRESSION, LOGISTIC_REGRESSION, SMOOTHED_HINGE_LOSS_LINEAR_SVM).
"""

import enum


class TaskType(enum.Enum):
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @classmethod
    def parse(cls, s: str) -> "TaskType":
        return cls(s.strip().upper())

    @property
    def is_classification(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )
