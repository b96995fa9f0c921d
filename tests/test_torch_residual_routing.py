"""The port's entity re-sharding (``parallel/shuffle.py``) and residual
routers (``game/residual_routing.py``) against the JAX package's, and the
random-effect problem's ``mesh=`` path that consumes the data router.

The port runs on entity meshes of 2 and 4 gloo ranks spawned on the CPU
(each shape once, every case inside it) and of 1 rank in process; the
reference on as many of its 8 virtual CPU devices. Expected values come
from calling the reference functions here.

Tolerances: the routers' static tables (``cap``, ``slot_row``,
``slot_of_row``, ``dest_dev``, ``flat_pos``) and every routed value are
equal exactly (routing moves values, it computes none); the shuffle's
received rows, counts and drops are equal exactly. The ``mesh=`` update
(float32): bank rows within 5e-4 of their max-abs of the reference's,
variances within 1e-4 relative (1e-3 for TRON, see ``VAR_RTOL``), on 2
ranks; against the port's replicated update within 1e-5 of scale and the
same tracker at 1, 2 and 4 ranks; every rank holds the same bits.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.game.data import EntityIndex as RefEntityIndex
from photon_ml_tpu.game.data import GameDataset as RefGameDataset
from photon_ml_tpu.game.data import ShardData as RefShardData
from photon_ml_tpu.game.config import ProjectorType as RefProjector
from photon_ml_tpu.game.config import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game.random_effect import RandomEffectOptimizationProblem as RefProblem
from photon_ml_tpu.game.random_effect_data import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.game.residual_routing import PodResidualRouter as RefPodRouter
from photon_ml_tpu.game.residual_routing import ResidualRouter as RefRouter
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import OptimizerType as RefOptType
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.parallel.mesh import ENTITY_AXIS as REF_ENTITY
from photon_ml_tpu.parallel.mesh import entity_mesh as ref_entity_mesh
from photon_ml_tpu.parallel.shuffle import entity_all_to_all as ref_all_to_all
from photon_ml_tpu.parallel.shuffle import reshard_capacity as ref_reshard_capacity
from photon_ml_tpu.utils.index_map import IndexMap as RefIndexMap
from photon_ml_tpu.utils.index_map import feature_key as ref_feature_key
from photon_ml_tpu_torch.game.residual_routing import PodResidualRouter
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, entity_mesh, spawn_mesh
from photon_ml_tpu_torch.parallel.shuffle import reshard_capacity
from torch_parity import assert_close_to_scale
from torch_pod_cases import replicated_update, residual_for, routing_suite, synthetic_arrays

ARRS = synthetic_arrays()
RESIDUAL = residual_for(ARRS)
CODES = np.random.default_rng(11).integers(-1, 23, size=130).astype(np.int64)
SMALL_CAP = 8
# TRON stops on the function change, so its float32 rows part from the
# reference's by up to 5e-4 of their scale, and the variances at them by
# up to ~3e-4 relative; L-BFGS stops on the gradient
VAR_RTOL = {"LBFGS": 1e-4, "TRON": 1e-3}


def ref_re(arrs):
    """The reference's GameDataset and IDENTITY RE dataset from the same
    arrays as ``torch_pod_cases.port_re``."""
    n = len(arrs["codes"])
    imap = RefIndexMap.build((ref_feature_key(f"f{i}", "") for i in range(arrs["d"])),
                             add_intercept=False)
    ds = RefGameDataset(
        uids=[str(i) for i in range(n)], labels=arrs["lab"], offsets=arrs["off"],
        weights=arrs["w"],
        shards={"s": RefShardData(indices=arrs["ix"], values=arrs["v"], index_map=imap,
                                  intercept_index=None)},
        entity_codes={"user": arrs["codes"]},
        entity_indexes={"user": RefEntityIndex.build(
            "user", [f"e{i:03d}" for i in range(arrs["E"])])},
        num_real_rows=n,
    )
    red = ref_build_re(ds, RefREConfig(random_effect_type="user", feature_shard_id="s",
                                       projector_type=RefProjector.IDENTITY))
    return ds, red


def _caps(n):
    return [reshard_capacity(np.pad(CODES, (0, -len(CODES) % n), constant_values=-1), n),
            SMALL_CAP]


@pytest.fixture(scope="module")
def ranks():
    """Each mesh shape spawned once; N = 1 runs in this process."""
    out = {1: [routing_suite(entity_mesh(1, device="cpu"), CODES, _caps(1), ARRS, RESIDUAL)]}
    for n in (2, 4):
        out[n] = spawn_mesh(
            routing_suite, (n,), (ENTITY_AXIS,), device="cpu",
            args=(CODES, _caps(n), ARRS, RESIDUAL),
        )
    return out


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_pod_router_tables_and_hops_equal_reference(ranks, n):
    ref = RefPodRouter(ref_entity_mesh(n), CODES)
    vals = np.arange(len(CODES), dtype=np.float32) + 1.0
    ref_slots = np.asarray(ref.route_in(jnp.asarray(vals))).reshape(n, -1)
    for r, got in enumerate(ranks[n]):
        pod = got["pod"]
        assert pod["cap"] == ref.cap
        np.testing.assert_array_equal(pod["slot_row"], ref.slot_row)
        np.testing.assert_array_equal(pod["slot_of_row"], ref.slot_of_row)
        np.testing.assert_array_equal(_np(pod["slots"]), ref_slots[r])
        back = _np(pod["back"])
        np.testing.assert_array_equal(back[CODES >= 0], vals[CODES >= 0])
        assert (back[CODES < 0] == 0).all()


def test_pod_router_tables_are_the_references_at_scale():
    """The vectorised table build (a stable sort, not n_dev² masks) gives
    the reference loop's tables exactly at 200,000 rows over 4 shards."""
    codes = np.random.default_rng(3).integers(-1, 5000, size=200_003).astype(np.int64)
    ref = RefPodRouter(ref_entity_mesh(4), codes)
    mesh = types.SimpleNamespace(
        axis_names=(ENTITY_AXIS,), device="cpu",
        size=lambda axis: 4, index=lambda axis: 1,
    )
    got = PodResidualRouter(mesh, codes)
    assert got.cap == ref.cap
    np.testing.assert_array_equal(got.slot_row, ref.slot_row)
    np.testing.assert_array_equal(got.slot_of_row, ref.slot_of_row)
    np.testing.assert_array_equal(got.send_pos, np.asarray(ref._send_pos))


@pytest.mark.parametrize("n", [2, 4])
def test_reshard_capacity_equals_reference(n):
    for seed in range(3):
        codes = np.random.default_rng(seed).integers(-1, 40, size=96)
        assert reshard_capacity(codes, n) == ref_reshard_capacity(codes, n)
        assert reshard_capacity(codes, n, slack=2.0) == ref_reshard_capacity(codes, n, slack=2.0)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("which", [0, 1], ids=["sized", "overflow"])
def test_shuffle_equals_reference(ranks, n, which):
    """Each rank receives the reference device's rows, codes and counts;
    at the small capacity the overflow rows are dropped and counted, the
    same rows on both sides; at the sized one nothing is dropped."""
    cap = _caps(n)[which]
    n_pad = len(CODES) + (-len(CODES) % n)
    codes = np.full(n_pad, -1, np.int64)
    codes[: len(CODES)] = CODES
    ids = np.arange(n_pad, dtype=np.int64)
    mesh = ref_entity_mesh(n)
    ref = ref_all_to_all(mesh, jnp.asarray(codes.astype(np.int32)),
                         (jnp.asarray(ids.astype(np.int32)),), cap=cap, axis=REF_ENTITY)
    ref_codes = np.asarray(ref.entity_codes).reshape(n, -1)
    ref_ids = np.asarray(ref.payload[0]).reshape(n, -1)
    total_dropped = 0
    for r, got in enumerate(ranks[n]):
        g_codes, g_ids, received, dropped = got["shuffle"][which]
        np.testing.assert_array_equal(_np(g_codes), ref_codes[r])
        np.testing.assert_array_equal(_np(g_ids), ref_ids[r])
        assert received == int(np.asarray(ref.received)[r])
        assert dropped == int(np.asarray(ref.dropped)[r])
        total_dropped += dropped
    if which == 0:
        assert total_dropped == 0
    assert total_dropped + sum(g["shuffle"][which][2] for g in ranks[n]) == int((CODES >= 0).sum())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_data_router_equals_reference(ranks, n):
    _, red = ref_re(ARRS)
    offsets = (ARRS["off"] + RESIDUAL).astype(np.float32)
    mesh = ref_entity_mesh(n)
    ref = RefRouter(mesh, red)
    flat = np.asarray(ref.route(jnp.asarray(offsets))).reshape(n, -1)
    for r, got in enumerate(ranks[n]):
        d = got["data"]
        assert d["cap"] == ref.cap
        np.testing.assert_array_equal(d["dest_dev"], np.asarray(ref._dest_dev))
        np.testing.assert_array_equal(d["flat_pos"], np.asarray(ref._flat_pos))
        np.testing.assert_array_equal(_np(d["flat"]), flat[r])


def _ref_mesh_update(n, optimizer):
    _, red = ref_re(ARRS)
    prob = RefProblem(
        REF_LOGISTIC, RefOptConfig(RefOptType[optimizer], max_iter=5, tolerance=1e-7),
        RefReg(RefRegType.L2), reg_weight=0.5, mesh=ref_entity_mesh(n),
    )
    offsets = jnp.asarray((ARRS["off"] + RESIDUAL).astype(np.float32))
    bank0 = jnp.zeros((red.num_entities, red.local_dim), jnp.float32)
    return prob.update_bank(bank0, red, offsets, with_variances=True)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_mesh_update_matches_reference(ranks, n, optimizer):
    """``RandomEffectOptimizationProblem(mesh=)``: each rank solves its
    slice of every bucket from its routed offsets; the bank comes back
    whole and the same on every rank."""
    key = "mesh_update" if optimizer == "LBFGS" else "mesh_update_tron"
    single = replicated_update(ARRS, RESIDUAL, optimizer=optimizer)
    first = ranks[n][0][key]
    for got in ranks[n]:
        out = got[key]
        np.testing.assert_array_equal(_np(out["bank"]), _np(first["bank"]))
        np.testing.assert_array_equal(_np(out["var"]), _np(first["var"]))
        assert out["tracker"] == first["tracker"]
    assert_close_to_scale(_np(first["bank"]), _np(single["bank"]), rtol=1e-5)
    assert_close_to_scale(_np(first["variances"]), _np(single["variances"]), rtol=1e-5)
    assert first["tracker"] == single["tracker"]
    if n == 2:  # the reference's sharded programs compile per mesh: one shape
        ref_bank, ref_tr, ref_var = _ref_mesh_update(n, optimizer)
        assert_close_to_scale(_np(first["bank"]), np.asarray(ref_bank), rtol=5e-4)
        np.testing.assert_allclose(_np(first["var"]), np.asarray(ref_var), rtol=VAR_RTOL[optimizer])
        assert first["tracker"][0] == ref_tr.num_entities
