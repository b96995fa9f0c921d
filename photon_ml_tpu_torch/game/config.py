"""GAME configuration: feature shards, coordinate data configs, projectors
(a copy of ``photon_ml_tpu/game/config.py``, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package).

Reference: photon-ml .../data/FixedEffectDataConfiguration.scala:50,
RandomEffectDataConfiguration.scala:64-127 (string DSL
``reType,shardId,numPartitions,activeCap,passiveLowerBound,featureRatio,
projector``), projector/ProjectorType.scala:30, and the GAME driver's
feature shard maps (cli/game/training/Params.scala:44-161,
``featureShardIdToFeatureSectionKeysMap``).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Optional, Sequence


class ProjectorType(enum.Enum):
    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"
    IDENTITY = "IDENTITY"

    @classmethod
    def parse(cls, s: str) -> "ProjectorType":
        base = s.strip().upper().split("=")[0]
        return cls(base)


@dataclass(frozen=True)
class FeatureShardConfiguration:
    """One named feature space: the union of one or more Avro feature bags
    (e.g. shard "userShard" = ["userFeatures"]). ``add_intercept`` appends
    the constant-1 feature (featureShardIdToInterceptMap analog)."""

    shard_id: str
    feature_bags: Sequence[str]
    add_intercept: bool = True


@dataclass(frozen=True)
class FixedEffectDataConfiguration:
    feature_shard_id: str = "global"

    @classmethod
    def parse(cls, s: str) -> "FixedEffectDataConfiguration":
        # reference format: "shardId,numPartitions" — partitions meaningless
        # on a mesh; accepted and ignored for CLI compat.
        parts = [p.strip() for p in s.split(",")]
        return cls(feature_shard_id=parts[0])


@dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """Per-coordinate random effect data settings
    (RandomEffectDataConfiguration.scala:64-127)."""

    random_effect_type: str  # id column, e.g. "userId"
    feature_shard_id: str
    active_data_upper_bound: Optional[int] = None  # reservoir cap / entity
    passive_data_lower_bound: Optional[int] = None
    features_to_samples_ratio: Optional[float] = None  # Pearson filter bound
    projector_type: ProjectorType = ProjectorType.INDEX_MAP
    random_projection_dim: Optional[int] = None

    @classmethod
    def parse(cls, s: str) -> "RandomEffectDataConfiguration":
        parts = [p.strip() for p in s.split(",")]
        if len(parts) != 7:
            raise ValueError(
                "expected 'reType,shardId,numPartitions,activeCap,"
                f"passiveLowerBound,featureRatio,projector', got {s!r}"
            )
        def opt_int(x):
            return None if x.lower() in ("none", "") else int(float(x))
        def opt_float(x):
            v = None if x.lower() in ("none", "") else float(x)
            return None if v is not None and math.isinf(v) else v
        proj = parts[6]
        ptype = ProjectorType.parse(proj)
        pdim = None
        if "=" in proj:
            pdim = int(proj.split("=")[1])
        if ptype == ProjectorType.RANDOM and pdim is None:
            raise ValueError(f"RANDOM projector requires a dimension: {s!r}")
        return cls(
            random_effect_type=parts[0],
            feature_shard_id=parts[1],
            active_data_upper_bound=opt_int(parts[3]),
            passive_data_lower_bound=opt_int(parts[4]),
            features_to_samples_ratio=opt_float(parts[5]),
            projector_type=ptype,
            random_projection_dim=pdim,
        )


@dataclass(frozen=True)
class MFOptimizationConfiguration:
    """Matrix factorization settings (MFOptimizationConfiguration.scala:50):
    ``maxNumberIterations,numFactors``."""

    max_iterations: int = 20
    num_latent_factors: int = 8

    @classmethod
    def parse(cls, s: str) -> "MFOptimizationConfiguration":
        parts = [p.strip() for p in s.split(",")]
        return cls(max_iterations=int(parts[0]), num_latent_factors=int(parts[1]))


@dataclass(frozen=True)
class FactoredRandomEffectConfiguration:
    """Factored random effect: RE solves in a learned latent projection
    alternating with a distributed projection-matrix fit
    (FactoredRandomEffectOptimizationProblem.scala:42-162)."""

    latent_space_dimension: int = 8
    num_inner_iterations: int = 2
