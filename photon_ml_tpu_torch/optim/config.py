"""Optimizer / regularization configuration (port of
``photon_ml_tpu/optim/config.py``).

Reference: photon-ml .../optimization/OptimizerType.scala,
GLMOptimizationConfiguration.scala:39-89 (the GAME drivers' per-coordinate
string ``maxIter,tol,regWeight,downSamplingRate,optimizer,regType``),
RegularizationType.scala, RegularizationContext.scala (l1 = alpha*lambda,
l2 = (1-alpha)*lambda) and OptimizerConfig.scala.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    TRON = "TRON"

    @classmethod
    def parse(cls, s: str) -> "OptimizerType":
        return cls(s.strip().upper())


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"

    @classmethod
    def parse(cls, s: str) -> "RegularizationType":
        return cls(s.strip().upper())


@dataclass(frozen=True)
class RegularizationContext:
    """Splits a total regularization weight into (l1, l2) parts."""

    reg_type: RegularizationType = RegularizationType.NONE
    elastic_net_alpha: Optional[float] = None

    def __post_init__(self):
        if self.reg_type == RegularizationType.ELASTIC_NET:
            a = self.elastic_net_alpha
            if a is None or not (0.0 <= a <= 1.0):
                raise ValueError(f"ELASTIC_NET requires alpha in [0,1], got {a}")
        elif self.elastic_net_alpha is not None:
            raise ValueError(
                f"alpha is only valid for ELASTIC_NET, got {self.reg_type}"
            )

    def split(self, reg_weight: float) -> Tuple[float, float]:
        """-> (l1_weight, l2_weight)."""
        t = self.reg_type
        if t == RegularizationType.NONE:
            return 0.0, 0.0
        if t == RegularizationType.L1:
            return reg_weight, 0.0
        if t == RegularizationType.L2:
            return 0.0, reg_weight
        a = self.elastic_net_alpha
        return a * reg_weight, (1.0 - a) * reg_weight

    @property
    def has_l1(self) -> bool:
        return self.reg_type in (
            RegularizationType.L1,
            RegularizationType.ELASTIC_NET,
        )


@dataclass(frozen=True)
class OptimizerConfig:
    """Budget and tolerances (OptimizerConfig.scala defaults: LBFGS
    maxIter=100 tol=1e-7, TRON maxIter=15 tol=1e-5)."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iter: int = 100
    tolerance: float = 1e-7
    lbfgs_history: int = 10
    tron_max_cg: int = 20

    @staticmethod
    def default_for(optimizer_type: OptimizerType) -> "OptimizerConfig":
        if optimizer_type == OptimizerType.TRON:
            return OptimizerConfig(OptimizerType.TRON, max_iter=15, tolerance=1e-5)
        return OptimizerConfig(OptimizerType.LBFGS, max_iter=100, tolerance=1e-7)


@dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """One coordinate's optimization settings; parses the reference's
    CLI string ``maxIter,tol,regWeight,downSamplingRate,optimizer,regType``
    (GLMOptimizationConfiguration.scala:39-89)."""

    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    regularization: RegularizationContext = field(
        default_factory=RegularizationContext
    )
    reg_weight: float = 0.0
    down_sampling_rate: float = 1.0

    @classmethod
    def parse(cls, s: str) -> "GLMOptimizationConfiguration":
        parts = [p.strip() for p in s.split(",")]
        if len(parts) != 6:
            raise ValueError(
                "expected 'maxIter,tol,regWeight,downSamplingRate,"
                f"optimizer,regType', got {s!r}"
            )
        max_iter = int(parts[0])
        tol = float(parts[1])
        reg_weight = float(parts[2])
        rate = float(parts[3])
        opt_type = OptimizerType.parse(parts[4])
        reg_type = RegularizationType.parse(parts[5])
        if max_iter <= 0:
            raise ValueError(f"maxIter must be positive: {max_iter}")
        if tol <= 0:
            raise ValueError(f"tolerance must be positive: {tol}")
        if reg_weight < 0:
            raise ValueError(f"regWeight must be non-negative: {reg_weight}")
        if not (0 < rate <= 1):
            raise ValueError(f"downSamplingRate must be in (0,1]: {rate}")
        base = OptimizerConfig.default_for(opt_type)
        return cls(
            optimizer_config=OptimizerConfig(
                optimizer_type=opt_type, max_iter=max_iter, tolerance=tol,
                lbfgs_history=base.lbfgs_history, tron_max_cg=base.tron_max_cg,
            ),
            regularization=RegularizationContext(reg_type),
            reg_weight=reg_weight,
            down_sampling_rate=rate,
        )

    def render(self) -> str:
        oc = self.optimizer_config
        return (
            f"{oc.max_iter},{oc.tolerance},{self.reg_weight},"
            f"{self.down_sampling_rate},{oc.optimizer_type.value},"
            f"{self.regularization.reg_type.value}"
        )
