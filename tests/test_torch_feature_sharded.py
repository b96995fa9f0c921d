"""The feature-sharded (data x model) path of the PyTorch port against the
reference, on a 2 x 2 mesh.

The reference runs on 4 of the 8 virtual CPU devices under ``shard_map``;
the port on a 2 x 2 ``gloo`` mesh of 4 spawned CPU processes
(``parallel.mesh.spawn_mesh``). Inputs are made with numpy from a seed and
cross between the packages as numpy arrays.

- The port's cells against the reference's, cut per cell by
  ``convert.feature_sharded_cell_from_reference``: the same block width,
  rows per shard, resolved tile parameters, row arrays and entries.
- The three block-local closures (value and gradient, the Hv factory,
  the Hessian diagonal), for one vector and a bank of 3, with and without
  a shift and factor, on the reference's own schedule, against the
  reference's ``tiled_block_local_*`` at ``mxu="highest"`` in interpret
  mode: within 1e-5 of each output's largest magnitude.
- Whole fits and trainers against the reference's, stopping at a
  convergence tolerance of 1e-4 (see ``test_torch_grid.py`` for why not
  1e-7): the same iterations and stop reasons, values within rtol 1e-4,
  coefficients within rtol 1e-4 / atol 5e-3 (as ``test_tiled_mesh.py``
  holds the reference's own mesh fits to its replicated fit), variances
  within rtol 1e-3.
- Every rank returns the same coefficient bits, iterations and reasons; a
  1 x 1 mesh gives the single-card fit (the same iterations and reasons,
  the value within rtol 1e-6, coefficients and variances within 1e-4 of
  their largest magnitude); the reference's guard messages.

The rank functions live at the top of this module, which imports JAX and
the reference only inside the tests: a spawned rank re-imports the module
and must not load JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.convert import (
    feature_sharded_block,
    feature_sharded_cell_from_reference,
    feature_sharded_vector,
)
from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.tiled_sparse import TileParams, feature_shard_tiled_batch
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.parallel.distributed import (
    block_local_hdiag,
    block_local_hvp_factory,
    block_local_vg,
    feature_sharded_glm_fit,
)
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ProcessMesh,
    spawn_mesh,
)
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import (
    train_feature_sharded,
    train_generalized_linear_model,
    train_grid_batched_feature_sharded,
)
from tests.torch_mesh_cases import (
    D,
    close_to_scale,
    planted_problem,
    schedule_entries,
    standardization,
)

SHAPE = (2, 2)
AXES = (DATA_AXIS, MODEL_AXIS)
PARAMS = dict(s_hi=4, s_lo=8, chunk=16, spill_cap=8)  # window 32: 2 x 2 tiles a cell
TIMEOUT_S = 180.0


def _port_batch(rows, labels, weights):
    return make_sparse_batch(rows, labels, weights=weights, device="cpu")


def _pad(v, d_pad, fill):
    return np.concatenate([v, np.full(d_pad - len(v), fill, np.float32)])


# ---------------------------------------------------------------------------
# Rank functions (run in the spawned ranks; no JAX)
# ---------------------------------------------------------------------------


def _closures_rank(mesh, ref_layout, cases, fits):
    """Each case's closures, and each fit, on this rank's cell of the
    reference's schedule."""
    dg, mg = mesh.groups[DATA_AXIS], mesh.groups[MODEL_AXIS]
    cell = feature_sharded_cell_from_reference(
        *ref_layout, data_index=mesh.index(DATA_AXIS),
        model_index=mesh.index(MODEL_AXIS), device="cpu",
    )
    b, m = cell.block_dim, mesh.index(MODEL_AXIS)

    def block(v):
        return None if v is None else torch.as_tensor(feature_sharded_block(v, b, m))

    out = []
    for w, d, l2, shift, factor in cases:
        l2 = torch.as_tensor(l2)
        norm = NormalizationContext(factor=block(factor), shift=block(shift))
        args = (LOGISTIC, cell, dg, mg, l2, norm)
        value, grad = block_local_vg(*args)(block(w))
        hv = block_local_hvp_factory(*args)(block(w))(block(d))
        hd = block_local_hdiag(*args)(block(w))
        out.append((value, grad, hv, hd))
    fit_out = []
    for optimizer, w0, l2, extras in fits:
        fit = feature_sharded_glm_fit(
            GLMObjective(LOGISTIC, D), mesh, optimizer=optimizer, max_iter=30,
            tol=1e-4,
        )
        res = fit(
            torch.as_tensor(w0), cell, torch.as_tensor(l2),
            *(torch.as_tensor(e) for e in extras),
        )
        fit_out.append(
            (res.coefficients, res.value, res.iterations, res.reason)
        )
    return out, fit_out


def _trainers_rank(mesh, problem, configs):
    batch = _port_batch(*problem)
    out = []
    for cfg in configs:
        cfg = dict(cfg)
        trainer = (
            train_grid_batched_feature_sharded if cfg.pop("grid", False)
            else train_feature_sharded
        )
        norm = cfg.pop("norm", None)
        if norm is not None:
            shift, factor = norm
            cfg["normalization"] = NormalizationContext(
                factor=torch.as_tensor(factor), shift=torch.as_tensor(shift)
            )
        models, results = trainer(
            batch, TaskType.LOGISTIC_REGRESSION, D, mesh=mesh, **cfg
        )
        out.append({
            lam: dict(
                means=models[lam].coefficients.means,
                variances=models[lam].coefficients.variances,
                value=float(results[lam].value),
                iterations=results[lam].iterations,
                reason=results[lam].reason,
            )
            for lam in models
        })
    return out


def _one_by_one_rank(mesh, problem):
    return _trainers_rank(mesh, problem, [TRAINER_CONFIGS["lbfgs_tiled"]])[0]


# ---------------------------------------------------------------------------
# (a) cells
# ---------------------------------------------------------------------------


def _ref_layout(problem, *, mesh=None):
    """The reference's feature-sharded tiled layout of ``problem`` (window
    32) -> (its batch, the numpy layout ``feature_sharded_cell_from_reference``
    takes)."""
    from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
    from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
    from photon_ml_tpu.ops.tiled_sparse import feature_shard_tiled_batch as ref_fstb

    rows, labels, weights = problem
    ref_batch = ref_make_sparse_batch(rows, labels, weights=weights)
    sharded, _ = ref_fstb(
        ref_batch, D, *SHAPE, params=RefTileParams(**PARAMS), mesh=mesh,
    )
    layout = (
        dataclasses.asdict(sharded.meta),
        [np.asarray(a) for a in sharded.z_sched],
        [np.asarray(a) for a in sharded.g_sched],
        np.asarray(sharded.labels), np.asarray(sharded.offsets),
        np.asarray(sharded.weights),
    )
    return sharded, layout


@pytest.mark.parametrize("cell_index", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_cells_match_reference(cell_index):
    problem = planted_problem()
    _, layout = _ref_layout(problem)
    ref = feature_sharded_cell_from_reference(
        *layout, data_index=cell_index[0], model_index=cell_index[1],
        device="cpu",
    )
    port, block_dim = feature_shard_tiled_batch(
        _port_batch(*problem), D, *SHAPE, *cell_index,
        params=TileParams(**PARAMS), device="cpu",
    )
    assert block_dim == ref.block_dim == layout[0]["block_dim"]
    assert port.meta == ref.meta
    assert port.cell.meta == ref.cell.meta
    assert port.meta.params.chunk == 16
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    window = port.meta.params.window
    spills = 0
    for pass_name in ("z_sched", "g_sched"):
        got = schedule_entries(getattr(port.cell, pass_name), window)
        want = schedule_entries(getattr(ref.cell, pass_name), window)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        spills += int(np.count_nonzero(getattr(port.cell, pass_name).spill_vals))
    assert len(got[0]) > 0 and spills > 0


# ---------------------------------------------------------------------------
# (b) closures and fits on the reference's schedule
# ---------------------------------------------------------------------------


def _closure_cases(d_pad, rows):
    """(w, direction, l2, shift, factor) per case, full [d_pad] (or [3,
    d_pad]) numpy; padded slots carry shift 0, factor 1."""
    rng = np.random.default_rng(7)
    shift, factor = standardization(rows)
    shift, factor = _pad(shift, d_pad, 0.0), _pad(factor, d_pad, 1.0)
    cases = {}
    for bank in (False, True):
        shape = (3, d_pad) if bank else (d_pad,)
        w = (0.3 * rng.normal(size=shape)).astype(np.float32)
        d = rng.normal(size=shape).astype(np.float32)
        w[..., D:] = 0.0
        d[..., D:] = 0.0
        l2 = np.array([0.5, 0.1, 0.0] if bank else 0.3, np.float32)
        kind = "bank" if bank else "vector"
        cases[kind] = (w, d, l2, None, None)
        cases[f"{kind}-norm"] = (w, d, l2, shift, factor)
    return cases


def _ref_closures(sharded, mesh, case):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from photon_ml_tpu.ops import losses as ref_losses
    from photon_ml_tpu.ops.tiled_sparse import FeatureShardedTiledBatch as RefCell
    from photon_ml_tpu.ops.tiled_sparse import (
        tiled_block_local_hdiag,
        tiled_block_local_hvp_factory,
        tiled_block_local_vg,
    )
    from photon_ml_tpu.parallel.mesh import DATA_AXIS as RD
    from photon_ml_tpu.parallel.mesh import MODEL_AXIS as RM

    w, d, l2, shift, factor = case
    bank = w.ndim == 2
    vec = P(None, RM) if bank else P(RM)
    with_norm = shift is not None
    kw = dict(interpret=True, mxu="highest")

    def body(w, d, z, g, lab, off, wgt, l2, *norm):
        shift_b, factor_b = norm if with_norm else (None, None)
        cell = RefCell(sharded.meta, z, g, lab, off, wgt)

        def one(w1, d1, l2_1):
            args = (ref_losses.LOGISTIC, cell, RD, RM, l2_1)
            nk = dict(shift=shift_b, factor=factor_b, **kw)
            v, gr = tiled_block_local_vg(*args, **nk)(w1)
            hv = tiled_block_local_hvp_factory(*args, **nk)(w1)(d1)
            hd = tiled_block_local_hdiag(*args, **nk)(w1)
            return v, gr, hv, hd

        return jax.vmap(one)(w, d, l2) if bank else one(w, d, l2)

    sched = P((RD, RM))
    f = shard_map(
        body, mesh=mesh,
        in_specs=(vec, vec, sched, sched, P(RD), P(RD), P(RD), P())
        + ((P(RM), P(RM)) if with_norm else ()),
        out_specs=(P(), vec, vec, vec), check_vma=False,
    )
    out = jax.jit(f)(
        w, d, sharded.z_sched, sharded.g_sched, sharded.labels,
        sharded.offsets, sharded.weights, l2,
        *((shift, factor) if with_norm else ()),
    )
    return [np.asarray(o) for o in out]


def _fit_cases(d_pad):
    l1_mask = np.ones(d_pad, np.float32)
    l1_mask[D - 1] = 0.0
    return {
        "lbfgs": ("lbfgs", np.zeros(d_pad, np.float32), np.float32(0.5), []),
        "tron": ("tron", np.zeros(d_pad, np.float32), np.float32(0.5), []),
        "owlqn": (
            "owlqn", np.zeros(d_pad, np.float32), np.float32(0.15),
            [np.float32(0.15), l1_mask],
        ),
        "grid": (
            "lbfgs", np.zeros((3, d_pad), np.float32),
            np.array([1.0, 0.3, 0.1], np.float32), [],
        ),
    }


def _ref_fit(sharded, mesh, case):
    import jax.numpy as jnp

    from photon_ml_tpu.ops import losses as ref_losses
    from photon_ml_tpu.ops.objective import GLMObjective as RefObjective
    from photon_ml_tpu.parallel.distributed import (
        feature_sharded_glm_fit as ref_feature_sharded_glm_fit,
    )

    optimizer, w0, l2, extras = case
    fit = ref_feature_sharded_glm_fit(
        RefObjective(ref_losses.LOGISTIC, D), mesh, sharded.meta,
        layout="tiled", optimizer=optimizer, max_iter=30, tol=1e-4,
        interpret=True, grid=w0.ndim == 2,
    )
    res = fit(jnp.asarray(w0), sharded, jnp.asarray(l2), *map(jnp.asarray, extras))
    return (
        np.asarray(res.coefficients), np.asarray(res.value),
        np.asarray(res.iterations).tolist(), np.asarray(res.reason).tolist(),
    )


@pytest.fixture(scope="module")
def closure_runs():
    import jax

    from photon_ml_tpu.parallel.mesh import make_mesh as ref_make_mesh

    problem = planted_problem()
    ref_mesh = ref_make_mesh(SHAPE, AXES, devices=jax.devices()[:4])
    sharded, layout = _ref_layout(problem, mesh=ref_mesh)
    d_pad = SHAPE[1] * layout[0]["block_dim"]
    cases = _closure_cases(d_pad, problem[0])
    fits = _fit_cases(d_pad)
    ranks = spawn_mesh(
        _closures_rank, SHAPE, AXES, device="cpu", timeout_s=TIMEOUT_S,
        args=(layout, list(cases.values()), list(fits.values())),
    )
    ref = {k: _ref_closures(sharded, ref_mesh, c) for k, c in cases.items()}
    ref_fits = {k: _ref_fit(sharded, ref_mesh, c) for k, c in fits.items()}
    return cases, ref, fits, ref_fits, ranks


def _assemble(ranks, i, j, part):
    """Output ``j`` of case ``i``, from the ranks of data row ``row`` (a
    block per model rank), as the full vector."""
    return [
        feature_sharded_vector([ranks[r * SHAPE[1] + m][part][i][j] for m in range(SHAPE[1])])
        for r in range(SHAPE[0])
    ]


@pytest.mark.parametrize("case", ["vector", "vector-norm", "bank", "bank-norm"])
def test_closures_match_reference(closure_runs, case):
    cases, ref, _, _, ranks = closure_runs
    i = list(cases).index(case)
    value, grad, hv, hd = ref[case]
    for r in range(len(ranks)):
        close_to_scale(ranks[r][0][i][0], value, 1e-5)
    for j, want in ((1, grad), (2, hv), (3, hd)):
        row0, row1 = _assemble(ranks, i, j, 0)
        close_to_scale(row0, want, 1e-5)
        np.testing.assert_array_equal(row0, row1)


@pytest.mark.parametrize("case", ["lbfgs", "tron", "owlqn", "grid"])
def test_fit_matches_reference(closure_runs, case):
    _, _, fits, ref_fits, ranks = closure_runs
    i = list(fits).index(case)
    coefs, value, iterations, reason = ref_fits[case]
    for r in ranks:
        got_coefs, got_value, got_iterations, got_reason = r[1][i]
        assert got_iterations == iterations
        assert got_reason == reason
        np.testing.assert_allclose(got_value, value, rtol=1e-4)
        np.testing.assert_allclose(got_coefs, coefs, rtol=1e-4, atol=5e-3)
        np.testing.assert_array_equal(got_coefs, ranks[0][1][i][0])


# ---------------------------------------------------------------------------
# (c, d) the trainers; every rank agrees
# ---------------------------------------------------------------------------

TRAINER_CONFIGS = {
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
    "owlqn_tiled": dict(
        regularization_type=RegularizationType.ELASTIC_NET,
        elastic_net_alpha=0.5, regularization_weights=[0.3], tolerance=1e-4,
        intercept_index=D - 1, kernel="tiled",
    ),
    "lbfgs_sparse_normalized": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.1], tolerance=1e-4,
        compute_variances=True, intercept_index=D - 1, kernel="scatter",
    ),
    "grid_tiled": dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.3, 0.1], tolerance=1e-4,
        compute_variances=True, kernel="tiled", grid=True,
    ),
}


def _ref_trainer(problem, mesh, cfg):
    from photon_ml_tpu import training as ref_training
    from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
    from photon_ml_tpu.ops.normalization import NormalizationContext as RefNorm
    from photon_ml_tpu.optim import config as ref_config
    from photon_ml_tpu.task import TaskType as RefTaskType

    cfg = dict(cfg)
    trainer = (
        ref_training.train_grid_batched_feature_sharded if cfg.pop("grid", False)
        else ref_training.train_feature_sharded
    )
    norm = cfg.pop("norm", None)
    if norm is not None:
        cfg["normalization"] = RefNorm(factor=norm[1], shift=norm[0])
    cfg["regularization_type"] = ref_config.RegularizationType[cfg["regularization_type"].name]
    if "optimizer_type" in cfg:
        cfg["optimizer_type"] = ref_config.OptimizerType[cfg["optimizer_type"].name]
    rows, labels, weights = problem
    models, results = trainer(
        ref_make_sparse_batch(rows, labels, weights=weights),
        RefTaskType.LOGISTIC_REGRESSION, D, mesh=mesh, **cfg,
    )
    return {
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


@pytest.fixture(scope="module")
def trainer_runs():
    import jax

    from photon_ml_tpu.parallel.mesh import make_mesh as ref_make_mesh

    problem = planted_problem(1)
    configs = dict(TRAINER_CONFIGS)
    configs["lbfgs_sparse_normalized"] = dict(
        configs["lbfgs_sparse_normalized"], norm=standardization(problem[0])
    )
    ranks = spawn_mesh(
        _trainers_rank, SHAPE, AXES, device="cpu", timeout_s=TIMEOUT_S,
        args=(problem, list(configs.values())),
    )
    ref_mesh = ref_make_mesh(SHAPE, AXES, devices=jax.devices()[:4])
    ref = {k: _ref_trainer(problem, ref_mesh, c) for k, c in configs.items()}
    return list(configs), ref, ranks


@pytest.mark.parametrize("name", list(TRAINER_CONFIGS))
def test_trainer_matches_reference(trainer_runs, name):
    names, ref, ranks = trainer_runs
    got = ranks[0][names.index(name)]
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


@pytest.mark.parametrize("name", list(TRAINER_CONFIGS))
def test_ranks_agree_bitwise(trainer_runs, name):
    names, _, ranks = trainer_runs
    first = ranks[0][names.index(name)]
    for other in ranks[1:]:
        mine = other[names.index(name)]
        for lam, g in first.items():
            assert (mine[lam]["iterations"], mine[lam]["reason"]) == (
                g["iterations"], g["reason"],
            )
            assert mine[lam]["means"].tobytes() == g["means"].tobytes()
            if g["variances"] is not None:
                assert mine[lam]["variances"].tobytes() == g["variances"].tobytes()


# ---------------------------------------------------------------------------
# (e) a 1 x 1 mesh is the single-card fit; (f) the guards
# ---------------------------------------------------------------------------


def test_one_by_one_mesh_equals_single_card():
    problem = planted_problem(2)
    (got,) = spawn_mesh(
        _one_by_one_rank, (1, 1), AXES, device="cpu", timeout_s=TIMEOUT_S,
        args=(problem,),
    )
    cfg = dict(TRAINER_CONFIGS["lbfgs_tiled"])
    models, results = train_generalized_linear_model(
        _port_batch(*problem), TaskType.LOGISTIC_REGRESSION, D,
        device="cpu", **cfg,
    )
    for lam in models:
        g = got[lam]
        assert (g["iterations"], g["reason"]) == (
            results[lam].iterations, results[lam].reason,
        )
        # the mesh sums its norms and inner products over the padded block
        # in another order: f32 rounding, grown over the iterations
        np.testing.assert_allclose(g["value"], float(results[lam].value), rtol=1e-6)
        close_to_scale(g["means"], models[lam].coefficients.means.numpy(), 1e-4)
        close_to_scale(
            g["variances"], models[lam].coefficients.variances.numpy(), 1e-4
        )


def _unconnected_mesh(axis_names=AXES):
    """A mesh that validation can read; it has no process groups, so
    anything past validation would fail."""
    return ProcessMesh(
        shape=(1,) * len(axis_names), axis_names=axis_names, rank=0,
        coords=(0,) * len(axis_names), groups={}, world=None,
        device=torch.device("cpu"),
    )


def test_guards():
    """The reference's guard messages (``test_feature_sharded_tron_guards``)
    and the port's own refusals, raised before any collective."""
    batch = _port_batch(*planted_problem())
    mesh = _unconnected_mesh()
    with pytest.raises(ValueError, match="twice-differentiable"):
        train_feature_sharded(
            batch, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM, D, mesh=mesh,
            optimizer_type=OptimizerType.TRON,
        )
    with pytest.raises(ValueError, match="L1/ELASTIC_NET"):
        train_feature_sharded(
            batch, TaskType.LOGISTIC_REGRESSION, D, mesh=mesh,
            optimizer_type=OptimizerType.TRON,
            regularization_type=RegularizationType.L1,
        )
    with pytest.raises(ValueError, match=r"\(data, model\) mesh"):
        train_grid_batched_feature_sharded(
            batch, TaskType.LOGISTIC_REGRESSION, D,
            mesh=_unconnected_mesh((DATA_AXIS,)),
        )
    with pytest.raises(TypeError, match="SparseBatch"):
        train_feature_sharded(object(), TaskType.LOGISTIC_REGRESSION, D, mesh=mesh)
    # track_models and tile_cache_dir are ported: they pass the guards, and
    # the next refusal is the batch's (test_torch_iteration_models.py runs them)
    for kw in (dict(track_models=True), dict(tile_cache_dir="cache")):
        with pytest.raises(TypeError, match="SparseBatch"):
            train_feature_sharded(
                object(), TaskType.LOGISTIC_REGRESSION, D, mesh=mesh, **kw
            )
    other_cell, block_dim = feature_shard_tiled_batch(
        batch, D, *SHAPE, 1, 0, params=TileParams(**PARAMS), device="cpu"
    )
    fit = feature_sharded_glm_fit(
        GLMObjective(LOGISTIC, D),
        dataclasses.replace(mesh, groups={DATA_AXIS: None, MODEL_AXIS: None}),
    )
    with pytest.raises(ValueError, match=r"cell \(1, 0\) given to the rank at \(0, 0\)"):
        fit(torch.zeros(SHAPE[1] * block_dim), other_cell, 0.5)
