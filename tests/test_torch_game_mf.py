"""The port's matrix factorization (``game/coordinate.py``
``MatrixFactorizationCoordinate`` over ``update_bank``'s
``values_override``, and MF model files) against the JAX package's, on the
reference's ``TestMatrixFactorization`` fixtures.

Tolerances: the side structures (buckets and gather plans) bit for bit;
one and two ALS steps within 1e-9 of the factors' max-abs in float64 (the
binding case: the reference's update path lowers the override values at
float32, so its side is run from its own parts, see ``_ref_als_f64``), and
within 1e-4 in float32, where LINEAR loss makes every bucket solve a ridge
regression that both packages' dual Newton solvers finish in one or two
steps; model files byte for byte;
scores of a loaded model within 1e-6 of their max-abs.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import game_example_schema
from photon_ml_tpu.cli import game_scoring_driver as ref_scoring
from photon_ml_tpu.game import FeatureShardConfiguration as RefShard
from photon_ml_tpu.game import MatrixFactorizationCoordinate as RefMF
from photon_ml_tpu.game import RandomEffectOptimizationProblem as RefREProblem
from photon_ml_tpu.game import build_game_dataset as ref_build
from photon_ml_tpu.game.model import GameModel as RefGameModel
from photon_ml_tpu.game.model import MatrixFactorizationModel as RefMFModel
from photon_ml_tpu.game.model_io import load_game_model as ref_load
from photon_ml_tpu.game.model_io import save_game_model as ref_save
from photon_ml_tpu.game.random_effect import _bucket_solver
from photon_ml_tpu.io.avro_codec import read_avro_records, write_container
from photon_ml_tpu.ops.losses import LINEAR as REF_LINEAR
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.cli import game_scoring_driver as port_scoring
from photon_ml_tpu_torch.convert import game_model_from_reference
from photon_ml_tpu_torch.game import (
    FeatureShardConfiguration,
    MatrixFactorizationCoordinate,
    MatrixFactorizationModel,
    RandomEffectOptimizationProblem,
    build_game_dataset,
    load_game_model,
    save_game_model,
)
from photon_ml_tpu_torch.ops.losses import LINEAR
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.task import TaskType
from torch_parity import assert_close_to_scale

K = 3


def _ratings(seed, n=400, n_users=12, n_items=15):
    """rating ~ user . item latent (the reference's fixture)."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, K))
    V = rng.normal(size=(n_items, K))
    recs = []
    for i in range(n):
        u, it = int(rng.integers(0, n_users)), int(rng.integers(0, n_items))
        recs.append({
            "uid": f"r{i}",
            "response": float(np.float32(U[u] @ V[it] + 0.1 * rng.normal())),
            "userId": f"u{u}", "itemId": f"i{it}", "features": [],
        })
    return recs


def _heavy_tailed(seed):
    """entity i gets 2^(i mod 10) ratings: every cap class ~10% of the
    entities, so the merge's 4x padding bound decides the classes."""
    rng = np.random.default_rng(seed)
    counts = [2 ** (i % 10) for i in range(40)]
    rows = np.repeat(np.arange(40), counts)
    cols = rng.integers(0, 5, size=len(rows))
    return [
        {"uid": f"r{i}", "response": float(np.float32(rng.normal())),
         "userId": f"u{rows[i]}", "itemId": f"i{cols[i]}", "features": []}
        for i in range(len(rows))
    ]


def _datasets(recs):
    ref = ref_build(recs, [RefShard("g", ["features"])], ["userId", "itemId"])
    port = build_game_dataset(
        recs, [FeatureShardConfiguration("g", ["features"])], ["userId", "itemId"], device="cpu",
    )
    return ref, port


def _coords(ref_ds, port_ds, k=K, max_iter=20, reg=0.5, inner=1):
    ref = RefMF(
        name="mf", dataset=ref_ds, row_effect_type="userId", col_effect_type="itemId",
        num_latent_factors=k,
        problem=RefREProblem(
            REF_LINEAR, RefOptConfig(max_iter=max_iter), RefReg(RefRegType.L2), reg_weight=reg,
        ),
        num_inner_iterations=inner,
    )
    port = MatrixFactorizationCoordinate(
        name="mf", dataset=port_ds, row_effect_type="userId", col_effect_type="itemId",
        num_latent_factors=k,
        problem=RandomEffectOptimizationProblem(
            LINEAR, OptimizerConfig(max_iter=max_iter), RegularizationContext(RegularizationType.L2),
            reg_weight=reg,
        ),
        num_inner_iterations=inner,
    )
    return ref, port


@pytest.mark.parametrize("case", ["ratings", "heavy_tailed"])
def test_side_structures_are_bit_equal(case):
    recs = _ratings(0) if case == "ratings" else _heavy_tailed(1)
    ref_ds, port_ds = _datasets(recs)
    ref, port = _coords(ref_ds, port_ds)
    rows, cols = ref_ds.entity_codes["userId"], ref_ds.entity_codes["itemId"]
    assert np.array_equal(port_ds.entity_codes["userId"], rows)
    R = ref_ds.entity_indexes["userId"].num_entities
    C = ref_ds.entity_indexes["itemId"].num_entities
    for side, solve, fixed, count in (("row", rows, cols, R), ("col", cols, rows, C)):
        ref_view, ref_plans = ref._side_structure(side, solve, fixed, count)
        port_view, port_plans = port._side_structure(side, solve, fixed, count)
        assert port._side_structure(side, solve, fixed, count)[0] is port_view  # cached
        for name in ("projection", "row_local_indices", "row_local_values", "row_entity_codes"):
            a, b = getattr(port_view, name), getattr(ref_view, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (side, name)
        assert (port_view.num_entities, port_view.local_dim) == (ref_view.num_entities, K)
        assert port_view.num_active_rows == ref_view.num_active_rows
        assert len(port_view.buckets) == len(ref_view.buckets) > 0
        for pb, rb, (pc, po), (rc, ro) in zip(port_view.buckets, ref_view.buckets, port_plans, ref_plans):
            for name in ("entity_codes", "row_index", "indices", "values", "labels", "offsets", "weights"):
                a, b = getattr(pb, name), getattr(rb, name)
                assert a.dtype == b.dtype and np.array_equal(a, b), (side, name)
            assert pb.values.shape[-1] == 0 and pb.identity_indices
            assert np.array_equal(pc.numpy(), np.asarray(rc))
            assert np.array_equal(po.numpy(), np.asarray(ro))
    if case == "heavy_tailed":
        # the 4x bound: with no class at 25%, the merge keeps enough
        # classes that no entity pads past 4x its own power-of-two cap
        view, _ = port._side_structure("row", rows, cols, R)
        per_entity = np.bincount(rows[rows >= 0], minlength=R)
        assert len(view.buckets) > 2
        for b in view.buckets:
            S = b.row_index.shape[1]
            for code in b.entity_codes:
                cap = 1 << int(np.ceil(np.log2(max(per_entity[code], 1))))
                assert S <= 4 * cap


def test_initial_factors_are_the_reference_draws():
    ref_ds, port_ds = _datasets(_ratings(0))
    ref, port = _coords(ref_ds, port_ds)
    for seed in (0, 3):
        ref.seed = port.seed = seed
        r, p = ref.initialize_model(), port.initialize_model()
        np.testing.assert_array_equal(p.row_latent.numpy(), np.asarray(r.row_latent))
        np.testing.assert_array_equal(p.col_latent.numpy(), np.asarray(r.col_latent))


def _als(ref, port, steps, residual):
    """``steps`` float32 ALS steps in both packages from their initial
    factors."""
    r, p = ref.initialize_model(), port.initialize_model()
    for _ in range(steps):
        r, _ = ref.update_model(r, None if residual is None else jnp.asarray(residual))
        p, tracker = port.update_model(p, None if residual is None else torch.as_tensor(residual))
        assert tracker is None
    return r, p


def _ref_als_f64(ref, rows_f, cols_f, steps, residual):
    """The reference's ALS half-steps in float64, from its own parts: its
    side structures and gather plans, and its per-bucket solve programs
    (``_bucket_solver``) run on the float64 partner gathers. Its
    ``update_bank`` cannot run them: it lowers the override values at
    float32."""
    ds = ref.dataset
    rows, cols = ds.entity_codes["userId"], ds.entity_codes["itemId"]
    R, C = (ds.entity_indexes[t].num_entities for t in ("userId", "itemId"))
    solvers = _bucket_solver(REF_LINEAR, ref.problem.config, ref.problem.regularization)
    l1, l2 = ref.problem.regularization.split(ref.problem.reg_weight)
    offsets = None if residual is None else jnp.asarray(ds.offsets, jnp.float64) + residual
    bank = {"row": jnp.asarray(rows_f), "col": jnp.asarray(cols_f)}
    for _ in range(steps):
        for side, solve, fixed, count, other in (
            ("row", rows, cols, R, "col"), ("col", cols, rows, C, "row"),
        ):
            view, plans = ref._side_structure(side, solve, fixed, count)
            b_new = bank[side]
            for bucket, (codes, ok) in zip(view.buckets, plans):
                X = jnp.where(ok[..., None], jnp.take(bank[other], codes, axis=0), 0.0)
                off = jnp.asarray(bucket.offsets, jnp.float64)
                if offsets is not None:
                    off = jnp.where(bucket.row_index >= 0, offsets[np.maximum(bucket.row_index, 0)], 0.0)
                kind = ref.problem._bucket_kind(bucket, K)
                c, _, _ = getattr(solvers, kind)(
                    jnp.take(b_new, bucket.entity_codes, axis=0), jnp.asarray(bucket.indices), X,
                    jnp.asarray(bucket.labels, jnp.float64), off,
                    jnp.asarray(bucket.weights, jnp.float64), jnp.float64(l1), jnp.float64(l2),
                )
                b_new = b_new.at[bucket.entity_codes].set(c)
            bank[side] = b_new
    return np.asarray(bank["row"]), np.asarray(bank["col"])


@pytest.fixture
def x64():
    """float64 in JAX, set globally."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("with_residual", [False, True])
def test_als_steps_match_in_float64(x64, steps, with_residual):
    ref_ds, port_ds = _datasets(_ratings(0))
    ref, port = _coords(ref_ds, port_ds)
    resid = None
    if with_residual:
        resid = (np.random.default_rng(5).normal(size=ref_ds.num_rows) * 0.3).astype(np.float32)
    init = port.initialize_model()
    want_rows, want_cols = _ref_als_f64(
        ref, init.row_latent.double().numpy(), init.col_latent.double().numpy(), steps,
        None if resid is None else jnp.asarray(resid, jnp.float64),
    )
    p = replace(init, row_latent=init.row_latent.double(), col_latent=init.col_latent.double())
    for _ in range(steps):
        p, _ = port.update_model(p, None if resid is None else torch.as_tensor(resid).double())
    assert p.row_latent.dtype == torch.float64 and want_rows.dtype == np.float64
    assert_close_to_scale(p.row_latent, want_rows, rtol=1e-9)
    assert_close_to_scale(p.col_latent, want_cols, rtol=1e-9)
    ref_model = RefMFModel("userId", "itemId", jnp.asarray(want_rows), jnp.asarray(want_cols))
    assert_close_to_scale(port.score(p), np.asarray(ref_model.score(ref_ds)), rtol=1e-9)
    reg = float(port.regularization_term_device(p))
    want_reg = 0.5 * 0.5 * (float((want_rows ** 2).sum()) + float((want_cols ** 2).sum()))
    assert abs(reg - want_reg) <= 1e-9 * want_reg


@pytest.mark.parametrize("steps", [1, 2])
def test_als_steps_match_in_float32(steps):
    ref_ds, port_ds = _datasets(_ratings(0))
    ref, port = _coords(ref_ds, port_ds, inner=2)
    r, p = _als(ref, port, steps, None)
    for name in ("row_latent", "col_latent"):
        assert_close_to_scale(getattr(p, name), np.asarray(getattr(r, name)), rtol=1e-4)
    lab = torch.as_tensor(port_ds.labels)
    mse = float(((port.score(p) - lab) ** 2).mean())
    mse0 = float(((port.score(port.initialize_model()) - lab) ** 2).mean())
    assert mse < 0.5 * mse0  # the reference's own check: ALS halves the error


def _mf_model(ref_ds):
    rng = np.random.default_rng(9)
    R = ref_ds.entity_indexes["userId"].num_entities
    C = ref_ds.entity_indexes["itemId"].num_entities
    return (rng.normal(size=(R, K)).astype(np.float32), rng.normal(size=(C, K)).astype(np.float32))


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_mf_files_are_byte_identical_and_cross_load(tmp_path):
    ref_ds, port_ds = _datasets(_ratings(0))
    rows, cols = _mf_model(ref_ds)
    ref_save(
        RefGameModel({"mf": RefMFModel("userId", "itemId", jnp.asarray(rows), jnp.asarray(cols))},
                     RefTask.LINEAR_REGRESSION),
        ref_ds, str(tmp_path / "ref"),
    )
    port_model = game_model_from_reference(
        TaskType.LINEAR_REGRESSION, {}, {}, {},
        matrix_factorizations={"mf": ("userId", "itemId", rows, cols)}, device="cpu",
    )
    assert isinstance(port_model.models["mf"], MatrixFactorizationModel)
    save_game_model(port_model, port_ds, str(tmp_path / "port"))
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files)
    for name, blob in ref_files.items():
        assert port_files[name] == blob, name
    # either package's files, loaded by either package, score new rows alike
    new_ref, new_port = _datasets(_ratings(4, n=150))
    want = np.asarray(ref_load(str(tmp_path / "ref")).score(new_ref, RefTask.LINEAR_REGRESSION))
    for src in ("ref", "port"):
        loaded = load_game_model(str(tmp_path / src))
        assert loaded.coordinate_names() == ["mf"]
        assert_close_to_scale(loaded.score(new_port, TaskType.LINEAR_REGRESSION), want, rtol=1e-6)
        got = np.asarray(ref_load(str(tmp_path / src)).score(new_ref, RefTask.LINEAR_REGRESSION))
        assert_close_to_scale(got, want, rtol=1e-6)


def test_port_scoring_driver_scores_a_jax_written_mf_model(tmp_path):
    ref_ds, _ = _datasets(_ratings(0))
    rows, cols = _mf_model(ref_ds)
    model_dir = tmp_path / "model"
    ref_save(
        RefGameModel({"mf": RefMFModel("userId", "itemId", jnp.asarray(rows), jnp.asarray(cols))},
                     RefTask.LINEAR_REGRESSION),
        ref_ds, str(model_dir),
    )
    data = tmp_path / "data"
    data.mkdir()
    recs = _ratings(6, n=180)
    for r in recs:
        r["metadataMap"] = {"userId": r.pop("userId"), "itemId": r.pop("itemId")}
        r["userFeatures"] = []
    write_container(str(data / "p0.avro"), game_example_schema(), recs)

    def argv(out):
        return [
            "--input-data-dirs", str(data), "--game-model-input-dir", str(model_dir),
            "--output-dir", str(out), "--task-type", "LINEAR_REGRESSION",
            "--feature-shard-id-to-feature-section-keys-map", "g:features",
            "--evaluator-types", "RMSE", "--random-effect-id-set", "userId,itemId",
        ]

    ref = ref_scoring.GameScoringDriver(ref_scoring.params_from_args(argv(tmp_path / "ref")))
    ref.run()
    port = port_scoring.main(argv(tmp_path / "port") + ["--device", "cpu"])
    np.testing.assert_allclose(port.metrics["RMSE"], ref.metrics["RMSE"], rtol=1e-6)
    ref_recs = list(read_avro_records(str(tmp_path / "ref" / "scores")))
    port_recs = list(read_avro_records(str(tmp_path / "port" / "scores")))
    assert [r["uid"] for r in port_recs] == [r["uid"] for r in ref_recs]
    assert_close_to_scale(
        [r["predictionScore"] for r in port_recs], [r["predictionScore"] for r in ref_recs], rtol=1e-6,
    )
