"""The data-parallel fit of the PyTorch port against the reference's, on
a 1-D mesh of 4.

The reference runs ``train_generalized_linear_model(mesh=...)`` and
``train_grid_batched(mesh=...)`` on 4 of the 8 virtual CPU devices; the
port the same trainers on a ``gloo`` mesh of 4 spawned CPU processes, each
holding one shard of the rows (``build_sharded_tiled_batch`` for the tiled
kernel, ``data_shard_sparse_batch`` for the scatter one) and summing the
objective's partials over the data group. The coefficients are
replicated. Tolerances as in ``tests/test_torch_feature_sharded.py``: the
same iterations and stop reasons at a convergence tolerance of 1e-4,
values within rtol 1e-4, coefficients within rtol 1e-4 / atol 5e-3,
variances within rtol 1e-3; every rank returns the same bits.

The rank function lives at the top of this module, which imports JAX and
the reference only inside the tests.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.tiled_sparse import TileParams, build_sharded_tiled_batch
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, spawn_mesh
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import (
    train_generalized_linear_model,
    train_grid_batched,
)
from tests.torch_mesh_cases import (
    D,
    planted_problem,
    schedule_entries,
    standardization,
)

SHARDS = 4
PARAMS = dict(s_hi=4, s_lo=8, chunk=16, spill_cap=8)  # window 32: 30 rows a shard

CONFIGS = {
    "lbfgs_tiled": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.1], tolerance=1e-4,
        compute_variances=True, kernel="tiled",
    ),
    "tron_tiled": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[0.5], tolerance=1e-4,
        optimizer_type=OptimizerType.TRON, kernel="tiled",
    ),
    "lbfgs_scatter_normalized": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.1], tolerance=1e-4,
        compute_variances=True, intercept_index=D - 1, kernel="scatter",
        norm=True,
    ),
    "owlqn_scatter": dict(
        regularization_type=RegularizationType.ELASTIC_NET,
        elastic_net_alpha=0.5, regularization_weights=[0.3], tolerance=1e-4,
        intercept_index=D - 1, kernel="scatter",
    ),
    "grid_tiled": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.3, 0.1], tolerance=1e-4,
        compute_variances=True, kernel="tiled", grid=True,
    ),
}


def _data_parallel_rank(mesh, problem, configs):
    rows, labels, weights = problem
    batch = make_sparse_batch(rows, labels, weights=weights, device="cpu")
    shard = build_sharded_tiled_batch(
        batch, D, SHARDS, mesh.index(DATA_AXIS), params=TileParams(**PARAMS),
        device="cpu",
    )
    shift, factor = standardization(rows)
    out = []
    for cfg in configs:
        cfg = dict(cfg)
        trainer = train_grid_batched if cfg.pop("grid", False) else train_generalized_linear_model
        if cfg.pop("norm", False):
            cfg["normalization"] = NormalizationContext(
                factor=torch.as_tensor(factor), shift=torch.as_tensor(shift)
            )
        models, results = trainer(
            shard if cfg["kernel"] == "tiled" else batch,
            TaskType.LOGISTIC_REGRESSION, D, mesh=mesh, **cfg,
        )
        out.append({
            lam: dict(
                means=models[lam].coefficients.means,
                variances=models[lam].coefficients.variances,
                value=float(results[lam].value),
                iterations=int(results[lam].iterations),
                reason=int(results[lam].reason),
            )
            for lam in models
        })
    return out


def _reference(problem):
    """The reference's trainers on a 4-device data mesh, per config."""
    import jax

    from photon_ml_tpu import training as ref_training
    from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
    from photon_ml_tpu.ops.normalization import NormalizationContext as RefNorm
    from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
    from photon_ml_tpu.ops.tiled_sparse import ensure_tiled_sharded
    from photon_ml_tpu.optim import config as ref_config
    from photon_ml_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from photon_ml_tpu.task import TaskType as RefTaskType

    rows, labels, weights = problem
    mesh = ref_make_mesh((SHARDS,), devices=jax.devices()[:SHARDS])
    batch = ref_make_sparse_batch(rows, labels, weights=weights)
    tiled = ensure_tiled_sharded(batch, D, mesh, params=RefTileParams(**PARAMS))
    shift, factor = standardization(rows)
    out = {}
    for name, cfg in CONFIGS.items():
        cfg = dict(cfg)
        trainer = (
            ref_training.train_grid_batched if cfg.pop("grid", False)
            else ref_training.train_generalized_linear_model
        )
        if cfg.pop("norm", False):
            cfg["normalization"] = RefNorm(factor=factor, shift=shift)
        cfg["regularization_type"] = ref_config.RegularizationType[cfg["regularization_type"].name]
        if "optimizer_type" in cfg:
            cfg["optimizer_type"] = ref_config.OptimizerType[cfg["optimizer_type"].name]
        models, results = trainer(
            tiled if cfg["kernel"] == "tiled" else batch,
            RefTaskType.LOGISTIC_REGRESSION, D, mesh=mesh, **cfg,
        )
        out[name] = {
            lam: dict(
                means=np.asarray(models[lam].coefficients.means),
                variances=(
                    None if models[lam].coefficients.variances is None
                    else np.asarray(models[lam].coefficients.variances)
                ),
                value=float(results[lam].value),
                iterations=int(results[lam].iterations),
                reason=int(results[lam].reason),
            )
            for lam in models
        }
    return out, tiled


@pytest.fixture(scope="module")
def runs():
    problem = planted_problem(3)
    ranks = spawn_mesh(
        _data_parallel_rank, (SHARDS,), (DATA_AXIS,), device="cpu",
        timeout_s=180.0, args=(problem, list(CONFIGS.values())),
    )
    ref, ref_tiled = _reference(problem)
    return problem, ranks, ref, ref_tiled


@pytest.mark.parametrize("shard_index", range(SHARDS))
def test_shards_match_reference(runs, shard_index):
    """Each rank's tiled shard computes what the reference's shard does:
    the same resolved parameters, row arrays and entries."""
    problem, _, _, ref_tiled = runs
    port = build_sharded_tiled_batch(
        make_sparse_batch(problem[0], problem[1], weights=problem[2], device="cpu"),
        D, SHARDS, shard_index, params=TileParams(**PARAMS), device="cpu",
    )
    meta = ref_tiled.meta
    assert (port.meta.num_rows, port.meta.dim, port.meta.data_shards) == (
        meta.num_rows, meta.dim, meta.data_shards,
    )
    assert port.params.chunk == meta.params.chunk
    R = meta.num_rows
    rows = slice(shard_index * R, (shard_index + 1) * R)
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref_tiled, name))[rows]
        )
    window = port.params.window
    for name in ("z_sched", "g_sched"):
        sched = getattr(ref_tiled, name)
        per = [np.asarray(a) for a in sched]
        own = [a[shard_index * (len(a) // SHARDS):(shard_index + 1) * (len(a) // SHARDS)] for a in per]
        ref_shard = type(sched)(*own)
        for got, want in zip(
            schedule_entries(getattr(port, name), window),
            schedule_entries(ref_shard, window),
        ):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_data_parallel_fit_matches_reference(runs, name):
    _, ranks, ref, _ = runs
    got = ranks[0][list(CONFIGS).index(name)]
    assert list(got) == list(ref[name])
    for lam, want in ref[name].items():
        g = got[lam]
        assert (g["iterations"], g["reason"]) == (want["iterations"], want["reason"])
        np.testing.assert_allclose(g["value"], want["value"], rtol=1e-4)
        np.testing.assert_allclose(g["means"], want["means"], rtol=1e-4, atol=5e-3)
        if want["variances"] is None:
            assert g["variances"] is None
        else:
            np.testing.assert_allclose(g["variances"], want["variances"], rtol=1e-3)
    for other in ranks[1:]:
        mine = other[list(CONFIGS).index(name)]
        for lam, g in got.items():
            assert mine[lam]["means"].tobytes() == g["means"].tobytes()
            assert (mine[lam]["iterations"], mine[lam]["reason"]) == (
                g["iterations"], g["reason"],
            )
