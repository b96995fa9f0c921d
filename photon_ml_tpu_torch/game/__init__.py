"""GAME (Generalized Additive Mixed Effects): multi-shard data, per-entity
random effects, the factored random effect, matrix factorization, block
coordinate descent, model files (port of ``photon_ml_tpu/game``); the
entity-sharded random effect over a mesh of ranks (``pod.py``, the
routers of ``residual_routing.py``) and the unified (grid × entity) λ-grid
trainer (``unified.py``)."""

from photon_ml_tpu_torch.game.config import (
    FactoredRandomEffectConfiguration,
    FeatureShardConfiguration,
    FixedEffectDataConfiguration,
    MFOptimizationConfiguration,
    ProjectorType,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.game.coordinate import (
    Coordinate,
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    MatrixFactorizationCoordinate,
    PodRandomEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_ml_tpu_torch.game.data import (
    EntityIndex,
    GameDataset,
    ShardData,
    build_game_dataset,
    build_game_dataset_from_files,
    slice_game_dataset,
)
from photon_ml_tpu_torch.game.model import (
    DatumScoringModel,
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.pod import (
    EntityShardSpec,
    PodRandomEffectModel,
    PodRandomEffectProblem,
    ShardedREBank,
)
from photon_ml_tpu_torch.game.model_io import (
    LoadedGameModel,
    load_game_model,
    save_game_model,
    save_loaded_game_model,
)
from photon_ml_tpu_torch.game.random_effect import (
    LazyRandomEffectTracker,
    RandomEffectOptimizationProblem,
    RandomEffectTracker,
    score_random_effect,
)
from photon_ml_tpu_torch.game.random_effect_data import (
    RandomEffectBucket,
    RandomEffectDataset,
    build_random_effect_dataset,
)

__all__ = [
    "FactoredRandomEffectConfiguration",
    "FeatureShardConfiguration",
    "FixedEffectDataConfiguration",
    "MFOptimizationConfiguration",
    "ProjectorType",
    "RandomEffectDataConfiguration",
    "Coordinate",
    "FactoredRandomEffectCoordinate",
    "FixedEffectCoordinate",
    "MatrixFactorizationCoordinate",
    "PodRandomEffectCoordinate",
    "RandomEffectCoordinate",
    "EntityShardSpec",
    "PodRandomEffectModel",
    "PodRandomEffectProblem",
    "ShardedREBank",
    "CoordinateDescent",
    "CoordinateDescentResult",
    "EntityIndex",
    "GameDataset",
    "ShardData",
    "build_game_dataset",
    "build_game_dataset_from_files",
    "slice_game_dataset",
    "DatumScoringModel",
    "FixedEffectModel",
    "GameModel",
    "MatrixFactorizationModel",
    "RandomEffectModel",
    "LoadedGameModel",
    "load_game_model",
    "save_game_model",
    "save_loaded_game_model",
    "LazyRandomEffectTracker",
    "RandomEffectOptimizationProblem",
    "RandomEffectTracker",
    "score_random_effect",
    "RandomEffectBucket",
    "RandomEffectDataset",
    "build_random_effect_dataset",
]
