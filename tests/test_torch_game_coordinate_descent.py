"""The port's coordinates and coordinate descent (``game/coordinate.py``,
``game/coordinate_descent.py``) against the JAX package's on the same
records, and the in-memory tier of ``ensure_tiled`` across sweeps.

Tolerances: objective histories within 1e-5 relative (the solves stop at a
gradient test near float32 rounding, so both packages reach the same
optima); coefficients, all with intercepts, within 5e-4 of their max-abs
(see test_cd_matches_reference).
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import CoordinateDescent as RefCD
from photon_ml_tpu.game import FixedEffectCoordinate as RefFE
from photon_ml_tpu.game import RandomEffectCoordinate as RefRE
from photon_ml_tpu.game import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game import RandomEffectOptimizationProblem as RefREProblem
from photon_ml_tpu.game import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.problem import create_glm_problem as ref_create_problem
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FactoredRandomEffectConfiguration,
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    MatrixFactorizationCoordinate,
    PodRandomEffectCoordinate,
    ProjectorType,
    RandomEffectCoordinate,
    RandomEffectDataConfiguration,
    RandomEffectOptimizationProblem,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.ops import tiled_sparse
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer
from photon_ml_tpu_torch.utils.preemption import PreemptionGuard
from torch_game_cases import both_datasets, make_records
from torch_parity import assert_close, assert_close_to_scale

TOL = 1e-9  # stop tests at float32 rounding: both packages reach the optima
RE_TYPES = ("userId", "itemId")


def _ref_coords(ds):
    fe = RefFE(
        name="global", dataset=ds,
        problem=ref_create_problem(
            RefTask.LOGISTIC_REGRESSION, ds.shards["globalShard"].dim,
            config=RefOptConfig(max_iter=60, tolerance=TOL),
            regularization=RefReg(RefRegType.L2),
            intercept_index=ds.shards["globalShard"].intercept_index,
        ),
        feature_shard_id="globalShard", reg_weight=0.1,
    )
    coords = {"global": fe}
    for t in RE_TYPES:
        red = ref_build_re(ds, RefREConfig(t, "userShard"))
        coords[f"per-{t}"] = RefRE(
            name=f"per-{t}", dataset=ds, re_dataset=red,
            problem=RefREProblem(
                REF_LOGISTIC, RefOptConfig(max_iter=60, tolerance=TOL),
                RefReg(RefRegType.L2), reg_weight=1.0,
            ),
        )
    return coords


def _port_coords(ds, kernel="scatter", down_sampling_rate=1.0, reg_weight=0.1):
    fe = FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, ds.shards["globalShard"].dim,
            config=OptimizerConfig(max_iter=60, tolerance=TOL),
            regularization=RegularizationContext(RegularizationType.L2),
            intercept_index=ds.shards["globalShard"].intercept_index, kernel=kernel,
        ),
        feature_shard_id="globalShard", reg_weight=reg_weight,
        down_sampling_rate=down_sampling_rate, sampler_seed=3,
    )
    coords = {"global": fe}
    for t in RE_TYPES:
        red = build_random_effect_dataset(ds, RandomEffectDataConfiguration(t, "userShard"))
        coords[f"per-{t}"] = RandomEffectCoordinate(
            name=f"per-{t}", dataset=ds, re_dataset=red,
            problem=RandomEffectOptimizationProblem(
                LOGISTIC, OptimizerConfig(max_iter=60, tolerance=TOL),
                RegularizationContext(RegularizationType.L2), reg_weight=1.0,
            ),
        )
    return coords


def _datasets(seed=7):
    return both_datasets(make_records(seed, n=240, n_users=8, n_items=6), RE_TYPES)


def test_cd_matches_reference():
    """FE + user RE + item RE, three sweeps, in both packages."""
    ref_ds, port_ds = _datasets()
    ref = RefCD(_ref_coords(ref_ds), ref_ds, RefTask.LOGISTIC_REGRESSION).run(3)
    port = CoordinateDescent(_port_coords(port_ds), port_ds, TaskType.LOGISTIC_REGRESSION).run(3)
    assert_close(port.objective_history, ref.objective_history, rtol=1e-5)
    assert port.objective_history[-1] <= port.objective_history[0]
    # every coordinate has an intercept, and the fixed intercept and the
    # entities' intercepts share a flat direction: in float32 coefficients
    # part along it by up to 3.8e-4 of their max-abs at the same objective
    # (ROADMAP Queue 3, witnessed in test_torch_intercept_parity)
    assert_close_to_scale(
        port.model.models["global"].model.means,
        np.asarray(ref.model.models["global"].model.means), rtol=5e-4,
    )
    for t in RE_TYPES:
        assert_close_to_scale(
            port.model.models[f"per-{t}"].bank,
            np.asarray(ref.model.models[f"per-{t}"].bank), rtol=5e-4,
        )
    tracker = port.trackers["per-userId"][-1]
    assert tracker.num_entities == 8


def test_tiled_fixed_effect_matches_scatter_and_tiles_once():
    """The port's FE on the tiled objective against its FE on the scatter
    objective, per iteration; the in-memory tier of ``ensure_tiled`` builds
    the schedules once over the three sweeps."""
    _, ds = _datasets()
    scatter = CoordinateDescent(_port_coords(ds), ds, TaskType.LOGISTIC_REGRESSION).run(3)
    tiled_sparse.tilings = 0
    tiled = CoordinateDescent(
        _port_coords(ds, kernel="tiled"), ds, TaskType.LOGISTIC_REGRESSION
    ).run(3)
    assert tiled_sparse.tilings == 1
    assert_close(tiled.objective_history, scatter.objective_history, rtol=1e-5)


def test_ensure_tiled_tier_invalidates_on_an_in_place_edit():
    _, ds = _datasets()
    tiled_sparse.tilings = 0
    batch = ds.batch_for_shard("globalShard")
    dim = ds.shards["globalShard"].dim
    first = tiled_sparse.ensure_tiled(batch, dim, device="cpu")
    shifted = ds.batch_for_shard("globalShard", offsets=np.full(ds.num_rows, 0.5, np.float32))
    again = tiled_sparse.ensure_tiled(shifted, dim, device="cpu")
    assert tiled_sparse.tilings == 1
    assert again.z_sched is first.z_sched and again.g_sched is first.g_sched
    assert torch.all(again.offsets[: ds.num_rows] == 0.5)
    assert torch.all(again.offsets[ds.num_rows:] == 0.0)
    batch.values[0, 0] += 1.0  # an in-place edit of the cached tensor
    edited = tiled_sparse.ensure_tiled(batch, dim, device="cpu")
    assert tiled_sparse.tilings == 2 and edited.z_sched is not first.z_sched
    batch.values[0, 0] -= 1.0


def test_warm_start_from_initial_model():
    ref_ds, port_ds = _datasets(8)
    cd = CoordinateDescent(_port_coords(port_ds), port_ds, TaskType.LOGISTIC_REGRESSION)
    r1 = cd.run(2)
    r2 = cd.run(1, initial_model=r1.model)
    assert r2.objective_history[-1] <= r1.objective_history[-1] * (1 + 1e-6)
    ref_cd = RefCD(_ref_coords(ref_ds), ref_ds, RefTask.LOGISTIC_REGRESSION)
    ref_r2 = ref_cd.run(1, initial_model=ref_cd.run(2).model)
    assert_close(r2.objective_history, ref_r2.objective_history, rtol=1e-5)


def test_update_model_grid_matches_sequential_solves():
    _, ds = _datasets(9)
    coord = _port_coords(ds)["global"]
    lambdas = [1.0, 0.1, 0.01]
    grid = coord.update_model_grid(lambdas)
    for lam, (model, result) in zip(lambdas, grid):
        single = _port_coords(ds, reg_weight=lam)["global"]
        seq_model, _ = single.update_model(single.initialize_model())
        assert_close_to_scale(model.model.means, seq_model.model.means, rtol=1e-4)
        assert result.iterations > 0


def test_down_sampling_runs():
    _, ds = _datasets(10)
    coords = _port_coords(ds, down_sampling_rate=0.5)
    result = CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION).run(2)
    assert all(np.isfinite(result.objective_history))
    again = CoordinateDescent(
        _port_coords(ds, down_sampling_rate=0.5), ds, TaskType.LOGISTIC_REGRESSION
    ).run(2)
    # the draw comes from the coordinate's seed: the same run again
    assert again.objective_history == result.objective_history
    full = CoordinateDescent(_port_coords(ds), ds, TaskType.LOGISTIC_REGRESSION).run(2)
    assert result.objective_history != full.objective_history


def test_update_sequence_and_unported_seams(tmp_path):
    _, ds = _datasets()
    coords = _port_coords(ds)
    with pytest.raises(ValueError, match="unknown"):
        CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION, update_sequence=["global", "x"])
    # checkpoints and the preemption guard (ported): the run takes them
    guard = PreemptionGuard()
    guard.request()
    result = CoordinateDescent(
        coords, ds, TaskType.LOGISTIC_REGRESSION,
        checkpointer=TrainingCheckpointer(str(tmp_path / "ck")), preemption_guard=guard,
    ).run(2)
    assert result.preempted and len(result.objective_history) == 1
    # the factored random effect and MF (ported) take an update
    opt = OptimizerConfig(max_iter=10)
    l2 = RegularizationContext(RegularizationType.L2)
    red = build_random_effect_dataset(
        ds, RandomEffectDataConfiguration("userId", "userShard", projector_type=ProjectorType.IDENTITY),
    )
    factored = FactoredRandomEffectCoordinate(
        name="x", dataset=ds, re_dataset=red,
        problem=RandomEffectOptimizationProblem(LOGISTIC, opt, l2, reg_weight=1.0),
        projection_problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, red.local_dim * 2, config=opt, regularization=l2,
        ),
        config=FactoredRandomEffectConfiguration(2, 1), reg_weight_projection=1.0,
    )
    mf = MatrixFactorizationCoordinate(
        name="x", dataset=ds, row_effect_type="userId", col_effect_type="itemId",
        num_latent_factors=2,
        problem=RandomEffectOptimizationProblem(LOGISTIC, opt, l2, reg_weight=1.0),
    )
    for coord in (factored, mf):
        model, _ = coord.update_model(coord.initialize_model())
        assert bool(torch.isfinite(coord.score(model)).all())
    # the pod coordinate is ported (tests/test_torch_pod_game.py); it needs
    # an entity mesh
    with pytest.raises(ValueError, match="requires an entity mesh"):
        PodRandomEffectCoordinate(
            name="x", dataset=ds, re_dataset=red,
            problem=RandomEffectOptimizationProblem(LOGISTIC, opt, l2, reg_weight=1.0),
        )
    # the fixed effect over a mesh is ported (tests/test_torch_game_mesh.py)
    fe = FixedEffectCoordinate(
        name="g", dataset=ds, problem=coords["global"].problem,
        feature_shard_id="globalShard",
    )
    assert not fe._is_feature_sharded()
