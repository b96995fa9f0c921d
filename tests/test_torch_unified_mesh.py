"""The port's unified (grid × entity) mesh (``parallel/unified_mesh.py``,
``game/unified.py``, the grid-bank snapshots of
``reliability/checkpoint.py``) against the JAX package's ``resolve_mesh``,
``GridShardedREBank`` and ``run_game_grid`` on a (2, 2) mesh.

The port runs on a (grid 2, entity 2) gloo mesh of 4 ranks spawned on the
CPU, once for the banks and once for ``run_game_grid`` (and, on the same
ranks, the per-member pod CD it must equal); the reference on 4 of its 8
virtual CPU devices, the same arrays made with numpy from a seed.

Tolerances: the mesh table equal exactly; member round trips and
snapshots bitwise, and each package's snapshot file loads in the other
bitwise. ``run_game_grid`` (float32): the per-member objective history
within 1e-5 relative of the reference's, the RE banks within 5e-4 of
their max-abs (Queue 3's envelope), the FE banks within 1e-3 (stopped at
5 iterations, unconverged: ``FE_RTOL``); against the port's per-member pod
CD within 1e-5 of scale; duplicate-λ members bitwise identical; every
rank the same bits; one batched readback per CD iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.game.pod import EntityShardSpec as RefSpec
from photon_ml_tpu.game.unified import GridShardedREBank as RefGridBank
from photon_ml_tpu.game.unified import run_game_grid as ref_run_game_grid
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.problem import create_glm_problem as ref_glm_problem
from photon_ml_tpu.game.random_effect import RandomEffectOptimizationProblem as RefProblem
from photon_ml_tpu.parallel.unified_mesh import resolve_mesh as ref_resolve_mesh
from photon_ml_tpu.reliability.checkpoint import GridCheckpointer as RefGridCheckpointer
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu.training import grid_bank_bytes as ref_grid_bank_bytes
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, GRID_AXIS, spawn_mesh
from photon_ml_tpu_torch.parallel.unified_mesh import plan_mesh
from photon_ml_tpu_torch.reliability.checkpoint import GridCheckpointer
from photon_ml_tpu_torch.training import grid_bank_bytes, resolve_grid_mode
from test_torch_residual_routing import ref_re
from torch_parity import assert_close_to_scale, clear_reference_pod_programs
from torch_pod_cases import grid_bank_round_trip, unified_arrays, unified_grid

LAMBDAS = [0.1, 0.5, 0.5, 2.0]  # a duplicate member on purpose
ARRS = unified_arrays(n=512, E=64, d=8, k=4)
# the fixed effect stops at the configuration's 5 L-BFGS iterations, short
# of convergence, where float32 iterates of two packages part by ~6e-4
FE_RTOL = 1e-3
BANK_E, BANK_D, BANK_G = 41, 5, 4  # G = 4: the reference's plan is (2, 2) too


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_mesh_table_equals_reference(ranks):
    devices = jax.devices()[:ranks]
    for grid in range(1, 9):
        for ent in (None, 1, 2, -1):
            if ent not in (None, -1) and ent > ranks:
                continue
            ref = ref_resolve_mesh(devices, grid_size=grid, entity_shards=ent, budget=1 << 20,
                                   member_bank_bytes=12345)
            got = plan_mesh(ranks, grid_size=grid, entity_shards=ent, budget=1 << 20,
                            member_bank_bytes=12345)
            for key in ("grid_size", "grid_rows", "entity_shards", "feature_blocks",
                        "members_per_row", "per_device_bank_bytes", "budget_bytes",
                        "grid_padded", "fits_budget"):
                assert getattr(got, key) == getattr(ref, key), (grid, ent, key)
            assert got.pad_members(range(grid)) == ref.pad_members(range(grid))
    for bad in (dict(grid_size=0), dict(grid_size=2, entity_shards=ranks + 1),
                dict(grid_size=2, feature_blocks=0)):
        with pytest.raises(ValueError) as want:
            ref_resolve_mesh(devices, **bad)
        with pytest.raises(ValueError) as got:
            plan_mesh(ranks, **bad)
        assert str(got.value) == str(want.value)


def test_grid_bank_bytes_and_mode_take_entity_shards():
    for n in (1, 2, 3, 8):
        assert grid_bank_bytes(4, 1000, entity_shards=n) == ref_grid_bank_bytes(
            4, 1000, entity_shards=n)
    budget = grid_bank_bytes(4, 1000, entity_shards=4)
    assert resolve_grid_mode("auto", num_weights=4, dim=1000, memory_budget_bytes=budget,
                             entity_shards=4) == "batched"
    assert resolve_grid_mode("auto", num_weights=4, dim=1000,
                             memory_budget_bytes=budget) == "sequential"


def _ref_plan(grid):
    return ref_resolve_mesh(jax.devices()[:4], grid_size=grid, entity_shards=2)


@pytest.fixture(autouse=True)
def fresh_reference_programs():
    """Each test's reference results come from programs built for its own
    problems (``torch_parity.clear_reference_pod_programs``)."""
    clear_reference_pod_programs()


@pytest.fixture(scope="module")
def bank_ranks(tmp_path_factory):
    """The (2, 2) mesh's bank round trips; the port writes its snapshot and
    loads the reference's."""
    root = tmp_path_factory.mktemp("grid_banks")
    rng = np.random.default_rng(7)
    banks = [rng.normal(size=(BANK_E, BANK_D)).astype(np.float32) for _ in range(BANK_G)]
    plan = _ref_plan(BANK_G)
    ref = RefGridBank.from_member_globals(plan.mesh, RefSpec(2, BANK_E), BANK_G,
                                          plan.pad_members(banks))
    RefGridCheckpointer(str(root / "ref"), {"test": "grid-bank"}).save_grid_bank(
        "per-user", ref.snapshot(), ref.layout())
    loaded, _ = GridCheckpointer(str(root / "ref"), {"test": "grid-bank"}).load_grid_bank(
        "per-user", expect_layout=ref.layout())
    out = spawn_mesh(grid_bank_round_trip, (2, 2), (GRID_AXIS, ENTITY_AXIS), device="cpu",
                     args=(BANK_E, BANK_D, [0.0] * BANK_G, str(root / "port"), loaded))
    return root, ref, banks, out


def test_grid_bank_members_and_snapshot_equal_reference(bank_ranks):
    _, ref, banks, out = bank_ranks
    ref_snap = ref.snapshot()
    for got in out:
        for g in range(BANK_G):
            np.testing.assert_array_equal(got["members"][g], banks[g])
            np.testing.assert_array_equal(got["members"][g], np.asarray(ref.member_global(g)))
        np.testing.assert_array_equal(got["snapshot"], ref_snap)
        assert got["layout"] == ref.layout()
        assert got["restored_equal"]


def test_grid_bank_snapshots_cross_load(bank_ranks):
    """The port loads the reference's committed snapshot, the reference
    the port's, bitwise; a snapshot of another layout is refused."""
    root, ref, banks, out = bank_ranks
    for got in out:
        for g in range(BANK_G):
            np.testing.assert_array_equal(got["loaded_members"][g], banks[g])
    snap, layout = RefGridCheckpointer(str(root / "port"), {"test": "grid-bank"}).load_grid_bank(
        "per-user", expect_layout=ref.layout())
    plan = _ref_plan(BANK_G)
    back = RefGridBank.restore(plan.mesh, RefSpec(2, BANK_E), BANK_G, snap)
    for g in range(BANK_G):
        np.testing.assert_array_equal(np.asarray(back.member_global(g)), banks[g])
    ck = GridCheckpointer(str(root / "port"), {"test": "grid-bank"})
    assert ck.has_grid_bank("per-user") and not ck.has_grid_bank("other")
    with pytest.raises(ValueError, match="different layout"):
        ck.load_grid_bank("per-user", expect_layout={**layout, "num_shards": 4})


@pytest.fixture(scope="module")
def grid_ranks():
    return spawn_mesh(unified_grid, (2, 2), (GRID_AXIS, ENTITY_AXIS), device="cpu",
                      args=(ARRS, LAMBDAS, 2))


def _ref_grid():
    ds, red = ref_re(ARRS)
    plan = _ref_plan(len(LAMBDAS))
    fe = ref_glm_problem(RefTask.LOGISTIC_REGRESSION, ds.shards["s"].dim,
                         config=RefOptConfig(max_iter=5))
    re = RefProblem(REF_LOGISTIC, RefOptConfig(max_iter=5, tolerance=1e-6),
                    RefReg(RefRegType.L2), reg_weight=1.0)
    return ref_run_game_grid(plan, ds, red, fe, re, LAMBDAS, feature_shard_id="s",
                             fe_reg_weight=0.1, num_iterations=2)


def test_run_game_grid_matches_reference(grid_ranks):
    ref = _ref_grid()
    got = grid_ranks[0]
    np.testing.assert_allclose(got["objective"], ref.objective_history, rtol=1e-5)
    for g in range(len(LAMBDAS)):
        assert_close_to_scale(got["re"][g], np.asarray(ref.re_bank.member_global(g)), rtol=5e-4)
        assert_close_to_scale(got["fe"][g], np.asarray(ref.fe_banks[g]), rtol=FE_RTOL)


def test_run_game_grid_matches_per_member_pod_cd_and_ranks_agree(grid_ranks):
    got = grid_ranks[0]
    for g, seq in enumerate(got["sequential"]):
        np.testing.assert_allclose([it[g] for it in got["objective"]], seq["objective"],
                                   rtol=1e-5)
        assert_close_to_scale(got["re"][g], seq["re"], rtol=1e-5)
        assert_close_to_scale(got["fe"][g], seq["fe"], rtol=1e-5)
    for other in grid_ranks[1:]:
        assert other["objective"] == got["objective"]
        for g in range(len(LAMBDAS)):
            np.testing.assert_array_equal(other["re"][g], got["re"][g])
            np.testing.assert_array_equal(other["fe"][g], got["fe"][g])


def test_duplicate_lambda_members_bitwise_and_one_readback_per_iteration(grid_ranks):
    for got in grid_ranks:
        np.testing.assert_array_equal(got["re"][1], got["re"][2])
        np.testing.assert_array_equal(got["fe"][1], got["fe"][2])
        assert all(it[1] == it[2] for it in got["objective"])
        assert got["readbacks"] == 2  # two CD iterations
        # each rank holds its 2 members' rows of its entity shard
        assert got["bytes"] == 2 * -(-ARRS["E"] // 2) * ARRS["d"] * 4
