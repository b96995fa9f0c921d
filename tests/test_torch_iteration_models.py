"""Per-iteration models (``track_models``, ``training.iteration_models``) of
the port's four trainers against the JAX package's, and the schedule cache
on the mesh trainers (``tile_cache_dir``).

The problem is ``tests/torch_mesh_cases.py``'s planted logistic rows with
an intercept, made with numpy from a seed. Each trainer runs with
``track_models=True`` in both packages at a convergence tolerance of 1e-4
(at tighter ones the function-change test compares differences of a few
f32 ulps and the two packages part on rounding), and its per-iteration
models are held slot for slot: the same count, coefficients within 1e-4 of
their largest magnitude. Single-card trainers on the CPU (scatter and
tiled); the mesh trainers on a 2 x 2 gloo mesh of spawned CPU ranks
against the reference under ``shard_map`` on 4 virtual devices.

Also: tracking adds no host fetch (``optim.common.host_fetches`` equal with
and without it), a frozen bank member's slots stop changing, a mesh rerun
with ``tile_cache_dir`` loads every rank's cell from the cache, and the
cell artifacts the JAX package writes load in the port.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.tiled_sparse import feature_shard_tiled_batch
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import (
    iteration_models,
    train_feature_sharded,
    train_generalized_linear_model,
    train_grid_batched,
    train_grid_batched_feature_sharded,
)
from tests.torch_mesh_cases import D, close_to_scale, planted_problem

SHAPE = (2, 2)
AXES = (DATA_AXIS, MODEL_AXIS)
TIMEOUT_S = 180.0

CONFIGS = {
    "lbfgs": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.1], tolerance=1e-4, intercept_index=D - 1,
    ),
    "tron": dict(
        regularization_type=RegularizationType.L2, regularization_weights=[0.5],
        tolerance=1e-4, optimizer_type=OptimizerType.TRON,
    ),
    "owlqn": dict(
        regularization_type=RegularizationType.ELASTIC_NET, elastic_net_alpha=0.5,
        regularization_weights=[0.3], tolerance=1e-4, intercept_index=D - 1,
    ),
}


def _port_batch(problem):
    rows, labels, weights = problem
    return make_sparse_batch(rows, labels, weights=weights, device="cpu")


def _iterates(results, task=TaskType.LOGISTIC_REGRESSION, intercept_index=None):
    """{lambda: [means of iteration 0, 1, ...]} as numpy."""
    return {
        lam: np.stack([
            np.asarray(m.means.cpu() if torch.is_tensor(m.means) else m.means)
            for m in iteration_models(res, task, intercept_index=intercept_index)
        ])
        for lam, res in results.items()
    }


def _ref_iterates(problem, trainer, cfg, mesh=None, kernel="scatter"):
    from photon_ml_tpu import training as ref_training
    from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
    from photon_ml_tpu.optim import config as ref_config
    from photon_ml_tpu.task import TaskType as RefTaskType

    cfg = dict(cfg)
    cfg["regularization_type"] = ref_config.RegularizationType[cfg["regularization_type"].name]
    if "optimizer_type" in cfg:
        cfg["optimizer_type"] = ref_config.OptimizerType[cfg["optimizer_type"].name]
    rows, labels, weights = problem
    kw = {} if mesh is None else {"mesh": mesh}
    _, results = getattr(ref_training, trainer)(
        ref_make_sparse_batch(rows, labels, weights=weights),
        RefTaskType.LOGISTIC_REGRESSION, D, kernel=kernel, track_models=True,
        **kw, **cfg,
    )
    out = {}
    for lam, res in results.items():
        models = ref_training.iteration_models(res, RefTaskType.LOGISTIC_REGRESSION)
        out[lam] = np.stack([np.asarray(m.means) for m in models])
    return out


def _assert_same_iterates(got, want):
    assert sorted(got) == sorted(want)
    for lam, w in want.items():
        g = got[lam]
        assert g.shape == w.shape, (lam, g.shape, w.shape)
        for i in range(len(w)):
            close_to_scale(g[i], w[i], 1e-4)


# ---------------------------------------------------------------------------
# single card
# ---------------------------------------------------------------------------

# The tiled cases are L-BFGS only: the reference's tiled training path
# computes its passes in bf16x2w (~1e-5 per pass), which TRON's CG
# compounds past 1e-4 within a few trips (see test_torch_training.py).
SINGLE = [
    (trainer, name, kernel)
    for trainer in ("train_generalized_linear_model", "train_grid_batched")
    for name, kernel in [(n, "scatter") for n in CONFIGS] + [("lbfgs", "tiled")]
]


@pytest.mark.parametrize(
    "trainer,name,kernel", SINGLE, ids=[f"{t[6:]}-{n}-{k}" for t, n, k in SINGLE]
)
def test_single_card_iteration_models_match_reference(trainer, name, kernel):
    problem = planted_problem(3)
    fn = {"train_generalized_linear_model": train_generalized_linear_model,
          "train_grid_batched": train_grid_batched}[trainer]
    _, results = fn(
        _port_batch(problem), TaskType.LOGISTIC_REGRESSION, D, kernel=kernel,
        device="cpu", track_models=True, **CONFIGS[name],
    )
    _assert_same_iterates(
        _iterates(results), _ref_iterates(problem, trainer, CONFIGS[name], kernel=kernel)
    )


@pytest.mark.parametrize("trainer", [train_generalized_linear_model, train_grid_batched])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tracking_adds_no_host_fetch(trainer, name):
    batch = _port_batch(planted_problem(4))
    counts, values = [], []
    for track in (False, True):
        common.host_fetches = 0
        _, results = trainer(
            batch, TaskType.LOGISTIC_REGRESSION, D, device="cpu", track_models=track,
            **CONFIGS[name],
        )
        counts.append(common.host_fetches)
        values.append({lam: float(r.value) for lam, r in results.items()})
        assert (results[next(iter(results))].tracker.coefs is not None) == track
    assert counts[0] == counts[1] > 0
    assert values[0] == values[1]  # tracking changes nothing it computes


def test_frozen_member_slots_stop_changing():
    """In a bank, a member that stops keeps its slots past its count
    untouched (zeros) while the others run on, and its last filled slot
    is its final coefficients."""
    _, results = train_grid_batched(
        _port_batch(planted_problem(5)), TaskType.LOGISTIC_REGRESSION, D,
        regularization_type=RegularizationType.L2,
        regularization_weights=[10.0, 1.0, 0.01], tolerance=1e-5,
        device="cpu", track_models=True,
    )
    counts = [r.tracker.count for r in results.values()]
    assert len(set(counts)) > 1  # the members stop at different trips
    for res in results.values():
        coefs, n = res.tracker.coefs, res.tracker.count
        assert coefs.shape[0] == 101
        assert torch.count_nonzero(coefs[n:]) == 0
        torch.testing.assert_close(coefs[n - 1], res.coefficients, rtol=0, atol=0)


def test_iteration_models_need_tracking():
    _, results = train_generalized_linear_model(
        _port_batch(planted_problem(6)), TaskType.LOGISTIC_REGRESSION, D,
        regularization_weights=[1.0], device="cpu",
    )
    with pytest.raises(ValueError, match="track_models"):
        iteration_models(results[1.0], TaskType.LOGISTIC_REGRESSION)


# ---------------------------------------------------------------------------
# the mesh trainers (spawned ranks; no JAX in them)
# ---------------------------------------------------------------------------

MESH_CASES = {
    "sharded_lbfgs": ("train_feature_sharded", "lbfgs"),
    "sharded_tron": ("train_feature_sharded", "tron"),
    "grid_lbfgs": ("train_grid_batched_feature_sharded", "lbfgs"),
    "grid_owlqn": ("train_grid_batched_feature_sharded", "owlqn"),
}


def _mesh_rank(mesh, problem, cache_dir, ref_cache_dir):
    """Every case tracked on the tiled cells, through the schedule cache;
    then the first case again (warm), and this rank's cell built over the
    JAX package's artifacts."""
    batch = _port_batch(problem)
    trainers = {
        "train_feature_sharded": train_feature_sharded,
        "train_grid_batched_feature_sharded": train_grid_batched_feature_sharded,
    }
    out = {}
    for case, (trainer, name) in MESH_CASES.items():
        _, results = trainers[trainer](
            batch, TaskType.LOGISTIC_REGRESSION, D, mesh=mesh, kernel="tiled",
            track_models=True, tile_cache_dir=cache_dir, **CONFIGS[name],
        )
        out[case] = _iterates(results)
    schedule_cache.reset_stats()
    _, results = train_feature_sharded(
        batch, TaskType.LOGISTIC_REGRESSION, D, mesh=mesh, kernel="tiled",
        track_models=True, tile_cache_dir=cache_dir, **CONFIGS["lbfgs"],
    )
    warm = schedule_cache.stats()
    out["rerun"] = (_iterates(results), warm.hits, warm.builds)
    schedule_cache.reset_stats()
    with schedule_cache.cache_scope(ref_cache_dir):
        cell, _ = feature_shard_tiled_batch(
            batch, D, *SHAPE, mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS), device="cpu",
        )
    s = schedule_cache.stats()
    out["reference_artifacts"] = (cell.cell.builder, s.hits, s.builds)
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import jax

    from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
    from photon_ml_tpu.ops import schedule_cache as ref_cache
    from photon_ml_tpu.ops.tiled_sparse import feature_shard_tiled_batch as ref_fstb
    from photon_ml_tpu.parallel.mesh import make_mesh as ref_make_mesh

    problem = planted_problem(7)
    ref_cache_dir = str(tmp_path_factory.mktemp("ref_cells"))
    rows, labels, weights = problem
    with ref_cache.cache_scope(ref_cache_dir):
        ref_fstb(ref_make_sparse_batch(rows, labels, weights=weights), D, *SHAPE)
    ranks = spawn_mesh(
        _mesh_rank, SHAPE, AXES, device="cpu", timeout_s=TIMEOUT_S,
        args=(problem, str(tmp_path_factory.mktemp("cells")), ref_cache_dir),
    )
    ref_mesh = ref_make_mesh(SHAPE, AXES, devices=jax.devices()[:4])
    ref = {
        case: _ref_iterates(problem, trainer, CONFIGS[name], mesh=ref_mesh, kernel="tiled")
        for case, (trainer, name) in MESH_CASES.items()
    }
    return ranks, ref


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_iteration_models_match_reference(mesh_runs, case):
    ranks, ref = mesh_runs
    _assert_same_iterates(ranks[0][case], ref[case])
    for other in ranks[1:]:  # every rank holds the same whole iterates
        for lam, got in ranks[0][case].items():
            assert other[case][lam].tobytes() == got.tobytes()


def test_mesh_rerun_hits_the_cache_on_every_rank(mesh_runs):
    ranks, _ = mesh_runs
    for rank in ranks:
        iterates, hits, builds = rank["rerun"]
        assert (hits, builds) == (2, 0)  # the cell's z and g schedules
        for lam, got in iterates.items():
            assert got.tobytes() == rank["sharded_lbfgs"][lam].tobytes()


def test_reference_cell_artifacts_load_in_the_port(mesh_runs):
    ranks, _ = mesh_runs
    for rank in ranks:
        assert rank["reference_artifacts"] == ("cache", 2, 0)
