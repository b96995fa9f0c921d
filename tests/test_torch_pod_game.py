"""The port's entity-sharded random effect (``game/pod.py``) against the
JAX package's: ``PodRandomEffectProblem`` update, variances, score and
regularization at 1, 2 and 4 entity shards, ``PodRandomEffectCoordinate``
inside ``CoordinateDescent``, the sharded bank's placement and bytes.

The port runs on entity meshes of 2 and 4 gloo ranks spawned on the CPU
(each shape once, every case inside it) and of 1 rank in process; the
reference on as many of its 8 virtual CPU devices, on the same arrays
made with numpy from a seed. Expected values come from calling the
reference functions here.

Tolerances:
- float32 against the reference's pod: bank rows within 5e-4 of their
  max-abs (Queue 3's envelope), variances within 1e-4 relative (1e-3 for
  TRON, whose rows stop on the function change), scores within 5e-4 of
  scale, the reg term within 1e-5 relative (1e-4 for TRON), the same
  entity count and a
  mean iteration count within 0.1 (float32 rounding can move one
  entity's stop by an iteration);
- float64 (binding) against the reference's replicated update under
  ``jax_enable_x64`` with float32-exact offsets: the same iterations and
  stop reasons, bank rows within 1e-9 of scale;
- within the port: every rank returns the same bits, two updates repeat
  bitwise, and the pod agrees with the port's replicated path within 1e-5
  of scale;
- the CD loop: the objective history within 1e-5 relative of the
  reference's pod CD and of the port's replicated CD.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.game.coordinate import FixedEffectCoordinate as RefFE
from photon_ml_tpu.game.coordinate import PodRandomEffectCoordinate as RefPodCoord
from photon_ml_tpu.game.coordinate_descent import CoordinateDescent as RefCD
from photon_ml_tpu.game.pod import PodRandomEffectProblem as RefPod
from photon_ml_tpu.game.random_effect import RandomEffectOptimizationProblem as RefProblem
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import OptimizerType as RefOptType
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.problem import create_glm_problem as ref_glm_problem
from photon_ml_tpu.parallel.mesh import entity_mesh as ref_entity_mesh
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.game.pod import EntityShardSpec, ShardedREBank, entity_shard_of
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, entity_mesh, spawn_mesh
from test_torch_residual_routing import ref_re
from torch_parity import assert_close_to_scale, clear_reference_pod_programs
from torch_pod_cases import (
    pod_cd,
    pod_suite,
    replicated_update,
    residual_for,
    synthetic_arrays,
)

ARRS = synthetic_arrays()
RESIDUAL = residual_for(ARRS)
VAR_RTOL = {"LBFGS": 1e-4, "TRON": 1e-3}
# the reg term sums the squared rows: TRON's row envelope moves it ~1e-5
REG_RTOL = {"LBFGS": 1e-5, "TRON": 1e-4}


@pytest.fixture(autouse=True)
def fresh_reference_programs():
    """Each test's reference results come from programs built for its own
    problems (``clear_reference_pod_programs``)."""
    clear_reference_pod_programs()


@pytest.fixture(scope="module")
def ranks():
    out = {1: [pod_suite(entity_mesh(1, device="cpu"), ARRS, RESIDUAL)]}
    for n in (2, 4):
        out[n] = spawn_mesh(pod_suite, (n,), (ENTITY_AXIS,), device="cpu",
                            args=(ARRS, RESIDUAL))
    return out


@pytest.fixture(scope="module")
def replicated():
    return {opt: replicated_update(ARRS, RESIDUAL, optimizer=opt) for opt in ("LBFGS", "TRON")}


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _ref_problem(optimizer="LBFGS", max_iter=5, tol=1e-7):
    return RefProblem(
        REF_LOGISTIC, RefOptConfig(RefOptType[optimizer], max_iter=max_iter, tolerance=tol),
        RefReg(RefRegType.L2), reg_weight=0.5,
    )


def _ref_pod(n, optimizer):
    _, red = ref_re(ARRS)
    pod = RefPod(_ref_problem(optimizer), ref_entity_mesh(n))
    offsets = jnp.asarray((ARRS["off"] + RESIDUAL).astype(np.float32))
    bank, tracker, var = pod.update_bank(pod.init_bank(red), red, offsets, with_variances=True)
    return dict(bank=np.asarray(bank.to_global()), var=np.asarray(var.to_global()),
                score=np.asarray(pod.score(bank, red)), reg=pod.regularization_term(bank),
                tracker=(tracker.num_entities, tracker.iterations_mean,
                         tracker.iterations_max, dict(tracker.reason_counts)))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_pod_update_matches_reference(ranks, n, optimizer):
    key = "f32" if optimizer == "LBFGS" else "tron"
    got = ranks[n][0][key]
    ref = _ref_pod(n, optimizer)
    assert_close_to_scale(_np(got["banks"][0]), ref["bank"], rtol=5e-4)
    np.testing.assert_allclose(_np(got["vars"][0]), ref["var"], rtol=VAR_RTOL[optimizer])
    assert_close_to_scale(_np(got["score"]), ref["score"], rtol=5e-4)
    assert abs(got["reg"] - ref["reg"]) <= REG_RTOL[optimizer] * abs(ref["reg"])
    # float32 rounding may move an entity's stop by an iteration; float64
    # holds the whole tracker (below)
    assert got["tracker"][0] == ref["tracker"][0]
    assert abs(got["tracker"][1] - ref["tracker"][1]) <= 0.1


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_pod_ranks_agree_repeat_and_match_replicated(ranks, replicated, n, optimizer):
    key = "f32" if optimizer == "LBFGS" else "tron"
    first = ranks[n][0][key]
    if optimizer == "LBFGS":
        np.testing.assert_array_equal(_np(first["banks"][0]), _np(first["banks"][1]))
        np.testing.assert_array_equal(_np(first["vars"][0]), _np(first["vars"][1]))
    for other in ranks[n][1:]:
        o = other[key]
        np.testing.assert_array_equal(_np(o["banks"][0]), _np(first["banks"][0]))
        np.testing.assert_array_equal(_np(o["score"]), _np(first["score"]))
        assert o["reg"] == first["reg"] and o["tracker"] == first["tracker"]
    rep = replicated[optimizer]
    assert_close_to_scale(_np(first["banks"][0]), _np(rep["bank"]), rtol=1e-5)
    assert_close_to_scale(_np(first["vars"][0]), _np(rep["var"]), rtol=1e-5)
    assert_close_to_scale(_np(first["score"]), _np(rep["score"]), rtol=1e-5)
    assert abs(first["reg"] - rep["reg"]) <= 1e-5 * abs(rep["reg"])
    assert first["tracker"] == rep["tracker"]


@pytest.fixture
def x64():
    """float64 in JAX, set globally (the reference compiles bucket
    programs on worker threads)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_pod_float64_matches_reference_iteration_for_iteration(ranks, x64):
    """The binding check: the port's pod in float64 at 2 shards against
    the reference's replicated update in float64 (its buckets in float64,
    the offsets float32-exact, as its update rounds them)."""
    _, red = ref_re(ARRS)
    red = dataclasses.replace(red, buckets=[
        dataclasses.replace(b, **{k: getattr(b, k).astype(np.float64)
                                  for k in ("values", "labels", "offsets", "weights")})
        for b in red.buckets
    ])
    prob = _ref_problem(max_iter=40)
    prob._aot_cache.clear()  # keyed by shape, not dtype
    try:
        offsets = jnp.asarray((ARRS["off"] + RESIDUAL).astype(np.float32).astype(np.float64))
        bank, tracker = prob.update_bank(
            jnp.zeros((red.num_entities, red.local_dim), jnp.float64), red, offsets,
        )
    finally:
        prob._aot_cache.clear()
    assert np.asarray(bank).dtype == np.float64
    for n in (1, 2, 4):
        got = ranks[n][0]["f64"]
        assert _np(got["banks"][0]).dtype == np.float64
        assert got["tracker"] == (tracker.num_entities, tracker.iterations_mean,
                                  tracker.iterations_max, dict(tracker.reason_counts))
        assert_close_to_scale(_np(got["banks"][0]), np.asarray(bank), rtol=1e-9)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_per_device_bytes_are_the_shard_share(ranks, n):
    """Each rank's bank and variance bytes are its EntityShardSpec share of
    the replicated [E, d] pair (hash padding to E_loc rows at most)."""
    spec = EntityShardSpec(n, ARRS["E"])
    for got in ranks[n]:
        f = got["f32"]
        assert f["shard_rows"] == spec.rows_per_shard
        assert f["bytes"] == 2 * spec.rows_per_shard * ARRS["d"] * 4
        assert f["bytes"] <= 2 * -(-ARRS["E"] // n) * ARRS["d"] * 4


def test_hash_placement_and_round_trip():
    """Entity e at local row e // n of shard e % n; from_global then
    to_global on one rank is the identity."""
    spec = EntityShardSpec(4, 10)
    assert spec.rows_per_shard == 3
    np.testing.assert_array_equal(spec.sharded_row_of(np.arange(10)),
                                  (np.arange(10) % 4) * 3 + np.arange(10) // 4)
    np.testing.assert_array_equal(entity_shard_of(np.arange(10), 4), np.arange(10) % 4)
    mesh = entity_mesh(1, device="cpu")
    bank = np.random.default_rng(0).normal(size=(41, 7)).astype(np.float32)
    sb = ShardedREBank.from_global(mesh, EntityShardSpec(1, 41), bank)
    np.testing.assert_array_equal(sb.to_global().numpy(), bank)


def _ref_cd(n):
    ds, red = ref_re(ARRS)
    fe = RefFE(
        name="fe", dataset=ds,
        problem=ref_glm_problem(RefTask.LOGISTIC_REGRESSION, ARRS["d"],
                                config=RefOptConfig(max_iter=10, tolerance=1e-7),
                                regularization=RefReg(RefRegType.L2)),
        feature_shard_id="s", reg_weight=1.0,
    )
    re = RefPodCoord(name="re", dataset=ds, re_dataset=red, problem=_ref_problem(),
                     mesh=ref_entity_mesh(n))
    res = RefCD({"fe": fe, "re": re}, ds, RefTask.LOGISTIC_REGRESSION).run(2)
    return res.objective_history, np.asarray(res.model.get_model("re").bank)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_pod_coordinate_in_coordinate_descent(ranks, n):
    """PodRandomEffectCoordinate inside CoordinateDescent: the objective
    history of the reference's pod CD and of the port's replicated CD;
    every rank the same bits."""
    got = ranks[n][0]["cd"]
    for other in ranks[n][1:]:
        assert other["cd"]["objective"] == got["objective"]
        np.testing.assert_array_equal(_np(other["cd"]["bank"]), _np(got["bank"]))
    single = pod_cd(None, ARRS, pod=False)
    np.testing.assert_allclose(got["objective"], single["objective"], rtol=1e-5)
    assert_close_to_scale(_np(got["bank"]), _np(single["bank"]), rtol=1e-5)
    if n == 2:  # one reference mesh shape: its programs compile per mesh
        ref_obj, ref_bank = _ref_cd(n)
        np.testing.assert_allclose(got["objective"], ref_obj, rtol=1e-5)
        assert_close_to_scale(_np(got["bank"]), ref_bank, rtol=5e-4)


def test_pod_update_requires_the_residual_vector_and_a_meshless_base():
    from photon_ml_tpu_torch.game.pod import PodRandomEffectProblem
    from photon_ml_tpu_torch.game.coordinate import PodRandomEffectCoordinate
    from torch_pod_cases import port_problem, port_re

    mesh = entity_mesh(1, device="cpu")
    ds, red = port_re(ARRS)
    pod = PodRandomEffectProblem(port_problem(), mesh)
    with pytest.raises(ValueError, match="requires the row-aligned residual"):
        pod.update_bank(pod.init_bank(red), red, None)
    with pytest.raises(ValueError, match="mesh-less base problem"):
        PodRandomEffectProblem(port_problem(mesh=mesh), mesh)
    with pytest.raises(ValueError, match="requires an entity mesh"):
        PodRandomEffectCoordinate(name="x", dataset=ds, re_dataset=red, problem=port_problem())
