"""The port's factored random effect (``game/coordinate.py``
``FactoredRandomEffectCoordinate``, ``_latent_view``, the factored save path
of ``game/model_io.py`` and the training driver's
``--factored-random-effect-optimization-configurations``) against the JAX
package's, on the reference's ``TestFactoredRandomEffect`` fixture
(IDENTITY-projected user shard).

Tolerances. Float64 is the binding case: each half of an inner iteration
in both packages on the same inputs, within 1e-9 of each output's
max-abs: the latent rows, the latent bank solve over the latent view (its
values cast to float64: the reference's view is float32 by construction
and its dual Newton solver then forms the Gram matrix in float32, the
port's in the bank's dtype, which alone parts them by ~1e-7), the
projection fit (an L-BFGS GLM over vec(B)) and the scores. The inputs are
float32-exact, since the reference rounds residual offsets to float32 in
``update_bank``. Float32: one whole ``update_model`` within 5e-4 of each
output's max-abs. Both packages' solves there stop on the function change
at float32 rounding, whichever the tolerance (1e-5..1e-9 give 1.2e-4 to
3.8e-4 here), as ``test_torch_game_random_effect.py`` found for the bank
solvers, so 1e-4 does not hold. Builds and files are held bit for bit.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import game_example_schema
from photon_ml_tpu.cli import game_training_driver as ref_training
from photon_ml_tpu.game import FactoredRandomEffectConfiguration as RefFConfig
from photon_ml_tpu.game import FactoredRandomEffectCoordinate as RefFactored
from photon_ml_tpu.game import ProjectorType as RefPT
from photon_ml_tpu.game import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game import RandomEffectOptimizationProblem as RefREProblem
from photon_ml_tpu.game import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.game.coordinate import FactoredRandomEffectModel as RefFModel
from photon_ml_tpu.game.coordinate import _latent_view as ref_latent_view
from photon_ml_tpu.game.model import GameModel as RefGameModel
from photon_ml_tpu.game.model_io import save_game_model as ref_save
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.problem import create_glm_problem as ref_create_problem
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.cli import game_scoring_driver as port_scoring
from photon_ml_tpu_torch.cli import game_training_driver as port_training
from photon_ml_tpu_torch.convert import game_model_from_reference
from photon_ml_tpu_torch.game import (
    FactoredRandomEffectConfiguration,
    FactoredRandomEffectCoordinate,
    ProjectorType,
    RandomEffectDataConfiguration,
    RandomEffectOptimizationProblem,
    build_random_effect_dataset,
    save_game_model,
)
from photon_ml_tpu_torch.game.coordinate import (
    FactoredRandomEffectModel,
    _latent_rows,
    _latent_view,
)
from photon_ml_tpu_torch.game.random_effect import device_row_view
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.task import TaskType
from torch_game_cases import both_datasets, make_records
from torch_parity import assert_close_to_scale

L = 2
TOL = 1e-9
# exactly representable in float32, so both packages regularize alike
# whatever the precision of the scalar they carry
REG_RE, REG_PROJECTION = 1.0, 0.5


@pytest.fixture(scope="module")
def data():
    ref_ds, port_ds = both_datasets(make_records(0, n=200, n_users=6))
    ref_red = ref_build_re(ref_ds, RefREConfig("userId", "userShard", projector_type=RefPT.IDENTITY))
    port_red = build_random_effect_dataset(
        port_ds, RandomEffectDataConfiguration("userId", "userShard", projector_type=ProjectorType.IDENTITY),
    )
    return ref_ds, port_ds, ref_red, port_red


def _coords(data, max_iter=15, tol=TOL):
    ref_ds, port_ds, ref_red, port_red = data
    ref = RefFactored(
        name="factored", dataset=ref_ds, re_dataset=ref_red,
        problem=RefREProblem(
            REF_LOGISTIC, RefOptConfig(max_iter=max_iter, tolerance=tol),
            RefReg(RefRegType.L2), reg_weight=REG_RE,
        ),
        projection_problem=ref_create_problem(
            RefTask.LOGISTIC_REGRESSION, ref_red.local_dim * L,
            config=RefOptConfig(max_iter=max_iter, tolerance=tol),
            regularization=RefReg(RefRegType.L2),
        ),
        config=RefFConfig(latent_space_dimension=L, num_inner_iterations=1),
        reg_weight_projection=REG_PROJECTION,
    )
    port = FactoredRandomEffectCoordinate(
        name="factored", dataset=port_ds, re_dataset=port_red,
        problem=RandomEffectOptimizationProblem(
            LOGISTIC, OptimizerConfig(max_iter=max_iter, tolerance=tol),
            RegularizationContext(RegularizationType.L2), reg_weight=REG_RE,
        ),
        projection_problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, port_red.local_dim * L,
            config=OptimizerConfig(max_iter=max_iter, tolerance=tol),
            regularization=RegularizationContext(RegularizationType.L2),
        ),
        config=FactoredRandomEffectConfiguration(latent_space_dimension=L, num_inner_iterations=1),
        reg_weight_projection=REG_PROJECTION,
    )
    return ref, port


def test_initial_projection_is_the_reference_draw(data):
    for seed in (0, 5):
        ref, port = _coords(data)
        ref.seed = port.seed = seed
        r, p = ref.initialize_model(), port.initialize_model()
        np.testing.assert_array_equal(p.projection.numpy(), np.asarray(r.projection))
        np.testing.assert_array_equal(p.bank.numpy(), np.asarray(r.bank))
        assert p.projection.shape == (data[3].local_dim, L)


def test_latent_view_builds_are_bit_equal(data):
    _, _, ref_red, port_red = data
    x_lat = np.random.default_rng(3).normal(size=(ref_red.row_local_indices.shape[0], L)).astype(np.float32)
    ref_view, port_view = ref_latent_view(ref_red, x_lat), _latent_view(port_red, x_lat)
    assert port_view.local_dim == ref_view.local_dim == L
    for name in ("projection", "row_local_indices", "row_local_values", "row_entity_codes"):
        a, b = getattr(port_view, name), getattr(ref_view, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port_view.random_projection is None and ref_view.random_projection is None
    assert len(port_view.buckets) == len(ref_view.buckets) > 0
    for pb, rb in zip(port_view.buckets, ref_view.buckets):
        assert pb.identity_indices and rb.identity_indices
        for name in ("entity_codes", "row_index", "indices", "values", "labels", "offsets", "weights"):
            a, b = getattr(pb, name), getattr(rb, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_one_update_matches_the_reference_in_float32(data):
    ref, port = _coords(data, max_iter=100)
    r0, p0 = ref.initialize_model(), port.initialize_model()
    resid = np.random.default_rng(4).normal(size=data[0].num_rows).astype(np.float32) * 0.2
    for residual in (None, resid):
        r1, _ = ref.update_model(r0, None if residual is None else jnp.asarray(residual))
        p1, tracker = port.update_model(p0, None if residual is None else torch.as_tensor(residual))
        assert tracker.num_entities == data[3].num_entities
        for name in ("bank", "projection"):
            assert_close_to_scale(getattr(p1, name), np.asarray(getattr(r1, name)), rtol=5e-4)
        assert_close_to_scale(port.score(p1), np.asarray(ref.score(r1)), rtol=5e-4)
        assert_close_to_scale(p1.score(data[1]), np.asarray(ref.score(r1)), rtol=5e-4)
        assert abs(float(port.regularization_term_device(p1)) - ref.regularization_term(r1)) <= (
            1e-4 * ref.regularization_term(r1)
        )


@pytest.fixture
def x64():
    """float64 in JAX for the test, set globally: the reference compiles
    its bucket programs on worker threads, which a context manager would
    not reach."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64_view(view):
    return replace(view, buckets=[
        replace(b, **{k: getattr(b, k).astype(np.float64)
                      for k in ("values", "labels", "offsets", "weights")})
        for b in view.buckets
    ])


def test_each_half_of_an_update_matches_in_float64(data, x64):
    ref, port = _coords(data, max_iter=100)
    # the reference's program cache is keyed by shape, not by dtype
    ref.problem._aot_cache.clear()
    try:
        _halves_in_float64(data, ref, port)
    finally:
        ref.problem._aot_cache.clear()


def _halves_in_float64(data, ref, port):
    ref_ds, port_ds, ref_red, port_red = data
    rng = np.random.default_rng(1)
    proj = rng.normal(size=(ref_red.local_dim, L))
    resid = (rng.normal(size=ref_ds.num_rows) * 0.2).astype(np.float32).astype(np.float64)
    off_ref = jnp.asarray(ref_ds.offsets, jnp.float64) + jnp.asarray(resid)
    off_port = port_ds.row_tensors()[1].double() + torch.as_tensor(resid)
    # the latent rows
    x_ref = np.asarray(ref._latent_rows(jnp.asarray(proj)))
    _, _, ix, v = device_row_view(port_red)
    x_port = _latent_rows(torch.as_tensor(proj), ix, v)
    assert x_ref.dtype == np.float64 and x_port.dtype == torch.float64
    assert_close_to_scale(x_port, x_ref, rtol=1e-12)
    # (1) the latent bank solve
    E = ref_red.num_entities
    ref_bank, ref_tr = ref.problem.update_bank(
        jnp.zeros((E, L), jnp.float64), _f64_view(ref_latent_view(ref_red, x_ref)),
        residual_offsets=off_ref,
    )
    port_bank, port_tr = port.problem.update_bank(
        torch.zeros(E, L, dtype=torch.float64), _f64_view(_latent_view(port_red, x_ref)),
        residual_offsets=off_port,
    )
    assert port_tr.reason_counts == ref_tr.reason_counts
    assert port_tr.iterations_max == ref_tr.iterations_max
    assert_close_to_scale(port_bank, np.asarray(ref_bank), rtol=1e-9)
    # (2) the projection fit, from the same bank
    bank = np.asarray(ref_bank)
    got = port._update_projection(torch.as_tensor(bank), torch.as_tensor(proj), off_port)
    want = np.asarray(ref._update_projection(jnp.asarray(bank), jnp.asarray(proj), off_ref))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    assert_close_to_scale(got, want, rtol=1e-9)
    # the scores of the updated model
    ref_model = RefFModel(jnp.asarray(bank), jnp.asarray(want), ref_red, "userId", "userShard")
    port_model = FactoredRandomEffectModel(
        torch.as_tensor(bank), torch.as_tensor(want), port_red, "userId", "userShard"
    )
    assert_close_to_scale(port.score(port_model), np.asarray(ref.score(ref_model)), rtol=1e-12)


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_saved_files_are_byte_identical(data, tmp_path):
    """The factored model goes to disk as a plain random effect in the
    original space (bank @ B^T); the same model gives the same bytes."""
    ref_ds, port_ds, ref_red, port_red = data
    rng = np.random.default_rng(2)
    bank = rng.normal(size=(ref_red.num_entities, L)).astype(np.float32)
    proj = rng.normal(size=(ref_red.local_dim, L)).astype(np.float32)
    bank[0] = 0.0  # an entity whose coefficients all vanish
    ref_model = RefGameModel(
        {"factored": RefFModel(jnp.asarray(bank), jnp.asarray(proj), ref_red, "userId", "userShard")},
        RefTask.LOGISTIC_REGRESSION,
    )
    port_model = game_model_from_reference(
        TaskType.LOGISTIC_REGRESSION, {}, {}, {"factored": port_red},
        factored={"factored": ("userId", "userShard", bank, proj)}, device="cpu",
    )
    assert isinstance(port_model.models["factored"], FactoredRandomEffectModel)
    ref_save(ref_model, ref_ds, str(tmp_path / "ref"), model_spec="factored -> x")
    save_game_model(port_model, port_ds, str(tmp_path / "port"), model_spec="factored -> x")
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files)
    assert any(f.startswith("random-effect/factored/coefficients") for f in port_files)
    for name, blob in ref_files.items():
        assert port_files[name] == blob, name


SHARD_MAP = "globalShard:features|userShard:userFeatures"


@pytest.fixture(scope="module")
def avro_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("factored_avro")
    for d, seed, n in (("train", 8, 240), ("val", 9, 120)):
        (root / d).mkdir()
        recs = make_records(seed, n=n, n_users=8)
        for r in recs:
            r["metadataMap"] = {"userId": r.pop("userId")}
        write_container(str(root / d / "p0.avro"), game_example_schema(), recs)
    return root


def _train_argv(root, out):
    return [
        "--train-input-dirs", str(root / "train"), "--validate-input-dirs", str(root / "val"),
        "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:40,1e-7,0.5,1,LBFGS,L2",
        "--random-effect-data-configurations", "per-user:userId,userShard,1,none,none,none,identity",
        "--random-effect-optimization-configurations", "per-user:40,1e-9,1,1,LBFGS,L2",
        "--factored-random-effect-optimization-configurations", "per-user:2,1",
        "--num-iterations", "2", "--evaluator-types", "AUC",
        "--compute-variance", "true", "--model-output-mode", "BEST",
    ]


def test_training_driver_runs_the_factored_option(avro_dirs, tmp_path):
    """The option parses as the reference's (latentDim,numInnerIterations),
    the driver builds the factored coordinate with variances off, its CD
    objectives agree with the JAX driver's (1e-4: two float32 CD sweeps)
    and its validation AUC within two swapped pairs, and the saved best model, a plain random effect
    on disk, scores through the scoring driver to the training driver's
    own validation AUC."""
    ref = ref_training.GameTrainingDriver(
        ref_training.params_from_args(_train_argv(avro_dirs, tmp_path / "ref"))
    )
    ref.run()
    port = port_training.main(_train_argv(avro_dirs, tmp_path / "port") + ["--device", "cpu"])
    cfg = port.params.factored_re_configs["per-user"]
    assert (cfg.latent_space_dimension, cfg.num_inner_iterations) == (2, 1)
    best = port.best_result[0]
    assert isinstance(best.model.models["per-user"], FactoredRandomEffectModel)
    np.testing.assert_allclose(
        best.objective_history, ref.best_result[0].objective_history, rtol=1e-4
    )
    # the AUC of 120 rows is a count of ordered pairs: the scores' 1e-4
    # moves it by one pair at most (~1/(60*60) = 2.8e-4)
    assert abs(port.best_result[1] - ref.best_result[1]) <= 6e-4
    model_dir = tmp_path / "port" / "best-model"
    assert (model_dir / "random-effect" / "per-user" / "coefficients" / "part-00000.avro").exists()
    scored = port_scoring.main([
        "--input-data-dirs", str(avro_dirs / "val"), "--game-model-input-dir", str(model_dir),
        "--output-dir", str(tmp_path / "scores"),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--evaluator-types", "AUC", "--device", "cpu",
    ])
    np.testing.assert_allclose(scored.metrics["AUC"], port.best_result[1], rtol=1e-6)
