"""Rank functions of the port's GAME mesh tests
(``tests/test_torch_game_mesh.py``). Imports neither JAX nor the
reference: a spawned rank re-imports this module."""

import numpy as np
import torch

from photon_ml_tpu_torch.game import (
    FeatureShardConfiguration,
    FixedEffectCoordinate,
    build_game_dataset,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.task import TaskType

SHARDS = [("globalShard", ["features"]), ("userShard", ["userFeatures"])]
TOL = 1e-6


def port_dataset(recs, device="cpu"):
    shards = [FeatureShardConfiguration(s, b, add_intercept=True) for s, b in SHARDS]
    return build_game_dataset(recs, shards, ["userId"], device=device)


def fe_coordinate(ds, kernel, optimizer, mesh=None, reg_weight=0.1):
    dim = ds.shards["globalShard"].dim
    return FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, dim,
            config=OptimizerConfig(OptimizerType[optimizer], max_iter=60, tolerance=TOL),
            regularization=RegularizationContext(RegularizationType.L2),
            intercept_index=ds.shards["globalShard"].intercept_index,
            kernel=kernel,
        ),
        feature_shard_id="globalShard", reg_weight=reg_weight, mesh=mesh,
    )


def fe_fits(mesh, recs, kernel, optimizer, residual):
    """Two cold FE fits and one with a residual, on this rank: -> a list of
    (coefficients, iterations, value) as numpy."""
    ds = port_dataset(recs, device=mesh.device if mesh is not None else "cpu")
    fe = fe_coordinate(ds, kernel, optimizer, mesh=mesh)
    out = []
    for r in (None, None, residual):
        res = None if r is None else torch.as_tensor(r, device=ds.device)
        model, result = fe.update_model(None, res)
        out.append((
            model.model.means.cpu().numpy(), int(result.iterations),
            float(result.value),
        ))
    return out
