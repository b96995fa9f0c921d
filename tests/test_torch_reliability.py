"""The port's reliability layer (``photon_ml_tpu_torch/reliability``,
``utils/checkpoint.py``, ``utils/preemption.py``) and its wiring through
the trainers, coordinate descent and the drivers: the reference's
``tests/test_reliability.py`` cases pointed at the port, the
GridCheckpointer's files across both packages, and kill -9 resumes.

The crash tests use the fault plan's ``KILL`` kind, SIGKILL delivered to
the process itself at an exact seam crossing, so "kill -9 in the middle of
a stage" is a deterministic, replayable event. The contract: a rerun with
the same arguments gives model files BITWISE equal to an uninterrupted
run's. It holds on the CPU; on the card K1's and K2's float atomics make
two uninterrupted fits with an intercept differ (ROADMAP Queue 3).

The reference's ``TestStageResume`` and its streamed-GAME kill -9 cases
are in ``tests/test_torch_streaming_game.py``, beside the streamed GAME
path they drive.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu.reliability import GridCheckpointer as RefGridCheckpointer
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu.training import train_generalized_linear_model as ref_train
from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.game import CoordinateDescent
from photon_ml_tpu_torch.reliability import (
    SEAMS,
    FaultPlan,
    GridCheckpointer,
    InjectedCorruption,
    SeamFailure,
    StreamingCDCheckpointer,
    atomic_write_json,
    atomic_writer,
    ensure_run_manifest,
    install_plan,
    io_call,
    policy_for,
    quarantine_artifact,
    read_manifest,
    reset_fault_stats,
    reset_retry_stats,
    retry_stats,
)
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model, train_grid_batched
from photon_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer
from photon_ml_tpu_torch.utils.preemption import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_reliability(monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_S", "0.001")
    reset_fault_stats()
    reset_retry_stats()
    yield
    reset_fault_stats()
    reset_retry_stats()


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_parse_forms(self):
        plan = FaultPlan.parse(
            "chunk_read:3:EIO,ckpt_save:1:ENOSPC:2,spill_write:2:eio:once,"
            "cache_load:1:CORRUPT,spill_read:4:EIO:*,ckpt_save:5:KILL"
        )
        assert len(plan.entries) == 6
        e = {x.seam: x for x in plan.entries[:5]}
        assert e["chunk_read"].nth == 3 and e["chunk_read"].times == 1
        assert e["ckpt_save"].times == 2
        assert e["spill_write"].times == 1
        assert e["cache_load"].error == "CORRUPT"
        assert e["spill_read"].times == -1  # poisoned: every call from 4
        assert plan.entries[5].error == "KILL"

    @pytest.mark.parametrize("bad", [
        "not_a_seam:1:EIO",        # unknown seam
        "chunk_read:0:EIO",        # nth < 1
        "chunk_read:1:EFOO",       # unknown error
        "chunk_read:1",            # too few fields
        "chunk_read:1:EIO:0",      # times < 1
    ])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)

    def test_deterministic_by_occurrence(self):
        for _ in range(2):
            plan = FaultPlan.parse("chunk_read:3:EIO:2")
            outcomes = []
            for _ in range(6):
                try:
                    plan.check("chunk_read")
                    outcomes.append("ok")
                except OSError:
                    outcomes.append("EIO")
            assert outcomes == ["ok", "ok", "EIO", "EIO", "ok", "ok"]

    def test_env_plan_single_transient_retries(self, monkeypatch):
        monkeypatch.setenv("PHOTON_FAULT_PLAN", "spill_read:1:EIO")
        reset_fault_stats()  # re-resolve from the env var
        assert io_call("spill_read", lambda: 7, detail="x") == 7
        assert retry_stats()["retries"]["spill_read"] == 1

    def test_seams_and_policies_are_the_references(self):
        from photon_ml_tpu.reliability import SEAMS as REF_SEAMS
        from photon_ml_tpu.reliability import policy_for as ref_policy_for

        assert SEAMS == REF_SEAMS
        from dataclasses import astuple

        for seam in SEAMS:
            assert astuple(policy_for(seam)) == astuple(ref_policy_for(seam)), seam


# ---------------------------------------------------------------------------
# io_call / retry / quarantine
# ---------------------------------------------------------------------------


class TestIoCall:
    def test_transient_fault_retries_to_success(self):
        install_plan("chunk_read:1:EIO")
        calls = []
        assert io_call("chunk_read", lambda: calls.append(1) or 42) == 42
        assert len(calls) == 1  # the first attempt failed at inject, not in fn
        r = retry_stats()
        assert r["retries"]["chunk_read"] == 1
        assert r["giveups"] == {}

    def test_budget_exhaustion_names_the_artifact(self):
        install_plan("spill_write:1:EIO:*")
        with pytest.raises(SeamFailure) as ei:
            io_call("spill_write", lambda: None, detail="chunks/ix.bin[3]")
        assert "spill_write" in str(ei.value)
        assert "chunks/ix.bin[3]" in str(ei.value)
        assert retry_stats()["giveups"]["spill_write"] == 1

    def test_corruption_is_not_retried(self):
        install_plan("cache_load:1:CORRUPT")
        with pytest.raises(InjectedCorruption):
            io_call("cache_load", lambda: None, detail="artifact")
        assert retry_stats()["retries"] == {}

    def test_real_oserror_retries_without_a_plan(self):
        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) < 3:
                raise OSError("transient")
            return "done"

        assert io_call("spill_read", flaky) == "done"
        assert len(attempts) == 3

    def test_quarantine_accounts_and_renames(self, tmp_path):
        p = tmp_path / "poison.npy"
        p.write_bytes(b"bad")
        dst = quarantine_artifact(str(p), "cache_load")
        assert dst.endswith(".corrupt") and os.path.exists(dst)
        assert not p.exists()
        p.write_bytes(b"bad again")
        dst2 = quarantine_artifact(str(p), "cache_load")
        assert dst2.endswith(".corrupt-1")
        r = retry_stats()
        assert r["quarantined"]["cache_load"] == 2
        assert dst in r["quarantined_artifacts"]

    def test_schedule_cache_load_fault_retries(self, tmp_path):
        """The schedule cache's load seam now crosses the fault plan: a
        transient fault retries to a hit."""
        from photon_ml_tpu_torch.ops import schedule_cache as sc

        arrays = [np.arange(8, dtype=np.int32) + i for i in range(len(sc.SCHEDULE_ARRAY_NAMES))]
        assert sc.store_schedule(str(tmp_path), "k" * 32, arrays)
        sc.reset_stats()
        install_plan("cache_load:1:EIO")
        assert sc.load_schedule(str(tmp_path), "k" * 32) is not None
        assert sc.stats().hits == 1
        assert retry_stats()["retries"]["cache_load"] == 1


# ---------------------------------------------------------------------------
# atomic artifacts + manifests
# ---------------------------------------------------------------------------


class TestAtomicArtifacts:
    def test_atomic_writer_publishes_complete_files(self, tmp_path):
        p = tmp_path / "nested" / "out.txt"
        with atomic_writer(str(p)) as f:
            f.write("payload")
        assert p.read_text() == "payload"

    def test_atomic_writer_error_leaves_nothing(self, tmp_path):
        p = tmp_path / "out.json"
        p.write_text("old")
        with pytest.raises(RuntimeError):
            with atomic_writer(str(p)) as f:
                f.write("half-writ")
                raise RuntimeError("crash mid-write")
        assert p.read_text() == "old"
        assert os.listdir(tmp_path) == ["out.json"]

    def test_atomic_write_json(self, tmp_path):
        p = tmp_path / "m.json"
        atomic_write_json(str(p), {"k": [1, 2]})
        assert json.load(open(p)) == {"k": [1, 2]}

    def test_run_manifest_guard(self, tmp_path):
        d = str(tmp_path / "ck")
        ensure_run_manifest(d, {"grid": [1.0, 0.1]}, kind="glm-grid")
        ensure_run_manifest(d, {"grid": [1.0, 0.1]}, kind="glm-grid")  # ok
        with pytest.raises(ValueError, match="different run configuration"):
            ensure_run_manifest(d, {"grid": [9.0]}, kind="glm-grid")
        with pytest.raises(ValueError, match="different run configuration"):
            ensure_run_manifest(d, {"grid": [1.0, 0.1]}, kind="other")

    def test_torn_manifest_quarantined_not_trusted(self, tmp_path):
        (tmp_path / "manifest.json").write_text('{"kind": "ga')  # torn
        assert read_manifest(str(tmp_path)) is None
        assert any(f.startswith("manifest.json.corrupt") for f in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# checkpointers
# ---------------------------------------------------------------------------


class TestGridCheckpointer:
    def test_round_trip(self, tmp_path):
        g = GridCheckpointer(str(tmp_path / "g"), {"grid": [1.0]})
        g.save(
            1.0,
            warm_means=np.arange(4, dtype=np.float32),
            model_means=np.arange(4, dtype=np.float32) * 2,
            model_variances=np.ones(4, np.float32),
            result_arrays={"value": np.float32(3.5), "iterations": np.int32(7)},
        )
        assert g.has(1.0) and not g.has(0.1)
        snap = g.load(1.0)
        np.testing.assert_array_equal(snap["warm_means"], np.arange(4))
        assert snap["result"]["iterations"] == 7

    def test_snapshot_without_marker_is_invisible(self, tmp_path):
        g = GridCheckpointer(str(tmp_path / "g"), {"grid": [1.0]})
        g.save(1.0, warm_means=np.zeros(2), model_means=np.zeros(2),
               model_variances=None, result_arrays={})
        os.unlink(g._base(1.0) + ".json")
        assert not g.has(1.0)
        assert g.load(1.0) is None

    @pytest.mark.parametrize("writer", ["ref", "port"])
    def test_snapshots_load_in_either_package(self, tmp_path, writer):
        """One package's trainer writes every λ's snapshot; the other's
        trainer over the same directory loads them all and solves nothing:
        its models and results are the writer's, bit for bit."""
        ref_batch, port_batch = _glm_batches()
        config = {"v": 1}
        kw = dict(regularization_weights=[10.0, 1.0], max_iter=10, compute_variances=True)
        if writer == "ref":
            written, results = ref_train(
                ref_batch, RefTask.LOGISTIC_REGRESSION, DIM,
                grid_checkpointer=RefGridCheckpointer(str(tmp_path), config), **kw,
            )
            loaded, loaded_results = train_generalized_linear_model(
                port_batch, TaskType.LOGISTIC_REGRESSION, DIM, device="cpu",
                grid_checkpointer=GridCheckpointer(str(tmp_path), config),
                preemption_guard=_requested(), **kw,
            )
        else:
            written, results = train_generalized_linear_model(
                port_batch, TaskType.LOGISTIC_REGRESSION, DIM, device="cpu",
                grid_checkpointer=GridCheckpointer(str(tmp_path), config), **kw,
            )
            loaded, loaded_results = ref_train(
                ref_batch, RefTask.LOGISTIC_REGRESSION, DIM,
                grid_checkpointer=RefGridCheckpointer(str(tmp_path), config),
                preemption_guard=_requested(), **kw,
            )
        # a requested guard stops before any solve: every λ came from disk
        assert sorted(loaded) == sorted(written) == [1.0, 10.0]
        for lam in written:
            for a, b in ((written[lam].means, loaded[lam].means),
                         (written[lam].coefficients.variances, loaded[lam].coefficients.variances)):
                np.testing.assert_array_equal(_np(b), _np(a))
            assert int(loaded_results[lam].iterations) == int(results[lam].iterations)
            assert int(loaded_results[lam].reason) == int(results[lam].reason)
            np.testing.assert_array_equal(_np(loaded_results[lam].tracker.values),
                                          _np(results[lam].tracker.values))


class TestStreamingCDCheckpointer:
    def test_round_trip_and_pruning(self, tmp_path):
        cd = StreamingCDCheckpointer(str(tmp_path), max_to_keep=2)
        for it in range(1, 4):
            cd.save(
                it,
                {"global": np.full(3, float(it)), "per-user": np.eye(2)},
                {"global": None, "per-user": np.ones((2, 2))},
                {"objective": [float(i) for i in range(it)]},
            )
        assert cd.steps() == [2, 3]
        states, variances, hist = cd.load(3)
        np.testing.assert_array_equal(states["global"], [3.0, 3.0, 3.0])
        assert variances["global"] is None
        np.testing.assert_array_equal(variances["per-user"], np.ones((2, 2)))
        assert hist["objective"] == [0.0, 1.0, 2.0]

    def test_loads_the_references_files(self, tmp_path):
        from photon_ml_tpu.reliability import StreamingCDCheckpointer as Ref

        Ref(str(tmp_path)).save(1, {"g": np.arange(3.0)}, {"g": np.ones(3)}, {"o": [1.5]})
        states, variances, hist = StreamingCDCheckpointer(str(tmp_path)).load(1)
        np.testing.assert_array_equal(states["g"], np.arange(3.0))
        np.testing.assert_array_equal(variances["g"], np.ones(3))
        assert hist == {"o": [1.5]}


class TestGameDriverManifest:
    def test_a_changed_configuration_is_refused(self, tmp_path, game_train):
        """The GAME driver's per-combo manifest (``ensure_run_manifest``,
        kind "game-training"): the same configuration resumes, another
        is refused (the reference's guard)."""
        from photon_ml_tpu_torch.cli.game_training_driver import (
            GameTrainingDriver,
            expand_config_grid,
            params_from_args,
        )

        ckpt = str(tmp_path / "ckpt")

        def combo_dir(out, *extra):
            p = params_from_args(_game_args(game_train, str(tmp_path / out), ckpt) + list(extra))
            (combo,) = expand_config_grid({**p.fixed_effect_opt_configs, **p.random_effect_opt_configs})
            return GameTrainingDriver(p)._combo_checkpointer(combo).directory

        d = combo_dir("a")
        assert combo_dir("b") == d  # the same configuration resumes
        assert read_manifest(d)["kind"] == "game-training"
        with pytest.raises(ValueError, match="different run configuration"):
            combo_dir("c", "--updating-sequence", "per-user,global")


class TestTrainingCheckpointer:
    def test_steps_prune_and_a_failed_save_leaves_no_step(self, tmp_path):
        from photon_ml_tpu_torch.game.model import MatrixFactorizationModel

        m = MatrixFactorizationModel("u", "i", torch.ones(3, 2), torch.zeros(4, 2))
        ck = TrainingCheckpointer(str(tmp_path), max_to_keep=2)
        for step in (1, 2, 3):
            ck.save(step, {"mf": m})
        assert ck.available_steps() == [2, 3] and ck.latest_step() == 3
        install_plan("ckpt_save:1:EIO:*")
        with pytest.raises(SeamFailure):
            ck.save(4, {"mf": m})
        install_plan(None)
        assert ck.available_steps() == [2, 3]
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
        restored = ck.restore(3, {"mf": m})["mf"]
        assert torch.equal(restored.row_latent, m.row_latent)
        ck.save_meta({"best_step": 3})
        assert ck.load_meta() == {"best_step": 3}


# ---------------------------------------------------------------------------
# λ-grid checkpoint / preemption wiring (training.py)
# ---------------------------------------------------------------------------

DIM = 20


def _glm_batches():
    """One seeded batch for both packages (every fit of a test sees the
    same rows, or the bitwise comparisons compare different problems)."""
    from photon_ml_tpu.data.batch import SparseBatch as RefBatch
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    n, k = 400, 4
    ix = rng.integers(0, DIM, size=(n, k)).astype(np.int32)
    vs = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    ref = RefBatch(jnp.asarray(ix), jnp.asarray(vs), jnp.asarray(y), jnp.zeros(n), jnp.ones(n))
    rows = [(ix[i].tolist(), vs[i].tolist()) for i in range(n)]
    port = make_sparse_batch(rows, y.tolist(), device="cpu")
    return ref, port


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _requested():
    guard = PreemptionGuard()
    guard.request()
    return guard


def _fit(trainer=train_generalized_linear_model, **kw):
    _, batch = _glm_batches()
    return trainer(
        batch, TaskType.LOGISTIC_REGRESSION, DIM, regularization_weights=[10.0, 1.0, 0.1],
        max_iter=10, device="cpu", **kw,
    )


class TestGridCheckpointWiring:
    @pytest.mark.parametrize("trainer", ["sequential", "batched"])
    def test_snapshots_reload_bitwise(self, tmp_path, trainer):
        fn = train_generalized_linear_model if trainer == "sequential" else train_grid_batched
        models_ref, _ = _fit(fn)
        ck = GridCheckpointer(str(tmp_path / "g"), {"v": 1})
        m_a, r_a = _fit(fn, grid_checkpointer=ck)
        assert sorted(m_a) == [0.1, 1.0, 10.0]
        m_b, r_b = _fit(fn, grid_checkpointer=ck)
        for lam in m_a:
            np.testing.assert_array_equal(_np(m_a[lam].means), _np(m_b[lam].means))
            np.testing.assert_array_equal(_np(models_ref[lam].means), _np(m_b[lam].means))
            assert int(r_b[lam].iterations) == int(r_a[lam].iterations)

    def test_preemption_stops_at_lambda_boundary(self, tmp_path):
        ck = GridCheckpointer(str(tmp_path / "g"), {"v": 1})
        models, results = _fit(grid_checkpointer=ck, preemption_guard=_requested())
        assert models == {} and results == {}

    def test_a_resume_warm_starts_from_the_snapshot(self, tmp_path):
        """Drop λ = 0.1's snapshot: the rerun loads 10 and 1, solves 0.1
        from λ = 1's snapshotted means, and ends bitwise where an
        uninterrupted run ends."""
        ck = GridCheckpointer(str(tmp_path / "g"), {"v": 1})
        full, _ = _fit(grid_checkpointer=ck)
        os.unlink(ck._base(0.1) + ".json")
        resumed, results = _fit(grid_checkpointer=GridCheckpointer(str(tmp_path / "g"), {"v": 1}))
        np.testing.assert_array_equal(_np(resumed[0.1].means), _np(full[0.1].means))
        # the solve of 0.1 started at λ = 1's means: its tracker's first
        # value is the objective there, not at zero
        cold, _ = _fit(warm_start=False)
        assert float(results[0.1].tracker.values[0]) < float(np.log(2) * 400)
        assert not np.array_equal(_np(cold[0.1].means), _np(full[0.1].means))

    def test_mesh_checkpoints_wait_for_item_13(self, tmp_path):
        """λ snapshots on a mesh trainer (ported since): a 2-rank data
        mesh writes each λ's snapshot once (process 0), every rank returns
        the same bits, and a rerun over the snapshots restores them
        bitwise without solving."""
        from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, spawn_mesh
        from photon_ml_tpu_torch.reliability.checkpoint import GridCheckpointer
        from tests.torch_multiprocess_cases import mesh_checkpoint_fit

        config = {"grid": [10.0, 1.0]}
        ckpt = str(tmp_path / "grid")
        GridCheckpointer(ckpt, config)  # the run manifest, before the ranks read it
        first = spawn_mesh(mesh_checkpoint_fit, (2,), (DATA_AXIS,), device="cpu",
                           args=(ckpt, config))
        markers = sorted(f for f in os.listdir(ckpt) if f.endswith(".json") and f.startswith("lambda-"))
        assert len(markers) == 2
        again = spawn_mesh(mesh_checkpoint_fit, (2,), (DATA_AXIS,), device="cpu",
                           args=(ckpt, config))
        for lam in (10.0, 1.0):
            assert np.array_equal(first[0][lam], first[1][lam])
            assert np.array_equal(first[0][lam], again[1][lam])


# ---------------------------------------------------------------------------
# coordinate descent: checkpoints and a preempted run that resumes bitwise
# ---------------------------------------------------------------------------


def _cd_coords(ds, factored=False):
    from photon_ml_tpu_torch.game import (
        FactoredRandomEffectConfiguration,
        FactoredRandomEffectCoordinate,
        FixedEffectCoordinate,
        ProjectorType,
        RandomEffectCoordinate,
        RandomEffectDataConfiguration,
        RandomEffectOptimizationProblem,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem

    l2 = RegularizationContext(RegularizationType.L2)
    opt = OptimizerConfig(max_iter=20)
    coords = {"global": FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, ds.shards["globalShard"].dim, config=opt,
            regularization=l2, intercept_index=ds.shards["globalShard"].intercept_index,
        ),
        feature_shard_id="globalShard", reg_weight=0.5,
    )}
    problem = RandomEffectOptimizationProblem(LOGISTIC, opt, l2, reg_weight=1.0)
    if factored:
        red = build_random_effect_dataset(ds, RandomEffectDataConfiguration(
            "userId", "userShard", projector_type=ProjectorType.IDENTITY))
        coords["per-user"] = FactoredRandomEffectCoordinate(
            name="per-user", dataset=ds, re_dataset=red, problem=problem,
            projection_problem=create_glm_problem(
                TaskType.LOGISTIC_REGRESSION, red.local_dim * 2, config=opt, regularization=l2),
            config=FactoredRandomEffectConfiguration(2, 1), reg_weight_projection=1.0,
        )
    else:
        red = build_random_effect_dataset(ds, RandomEffectDataConfiguration("userId", "userShard"))
        coords["per-user"] = RandomEffectCoordinate(
            name="per-user", dataset=ds, re_dataset=red, problem=problem)
    return coords


class _RequestsOnFirstUpdate:
    """A coordinate that sets the guard's flag during its first update
    (a SIGTERM arriving in the middle of sweep 1)."""

    def __init__(self, coord, guard):
        self.coord, self.guard, self.calls = coord, guard, 0

    def __getattr__(self, name):
        return getattr(self.coord, name)

    def update_model(self, model, residual=None):
        self.calls += 1
        if self.calls == 1:
            self.guard.request()
        return self.coord.update_model(model, residual)


@pytest.mark.parametrize("factored", [False, True])
def test_preempted_cd_resumes_bitwise(tmp_path, factored):
    from torch_game_cases import make_records

    from photon_ml_tpu_torch.game import build_game_dataset
    from torch_game_cases import shards

    ds = build_game_dataset(make_records(3, n=200, n_users=6), shards(), ["userId"], device="cpu")
    full = CoordinateDescent(_cd_coords(ds, factored), ds, TaskType.LOGISTIC_REGRESSION).run(3)
    guard = PreemptionGuard()
    coords = _cd_coords(ds, factored)
    coords["per-user"] = _RequestsOnFirstUpdate(coords["per-user"], guard)
    ck = TrainingCheckpointer(str(tmp_path / "ck"))
    stopped = CoordinateDescent(
        coords, ds, TaskType.LOGISTIC_REGRESSION, checkpointer=ck, preemption_guard=guard,
    ).run(3)
    assert stopped.preempted and len(stopped.objective_history) == 1
    assert ck.latest_step() == 1
    assert stopped.objective_history[0] == full.objective_history[0]
    resumed = CoordinateDescent(
        _cd_coords(ds, factored), ds, TaskType.LOGISTIC_REGRESSION,
        checkpointer=TrainingCheckpointer(str(tmp_path / "ck")),
    ).run(3)
    assert not resumed.preempted
    assert resumed.objective_history == full.objective_history[1:]
    for name, sub in full.model.models.items():
        got = resumed.model.models[name]
        for a, b in _states(sub, got):
            assert torch.equal(a, b), name


def _states(a, b):
    from photon_ml_tpu_torch.utils.checkpoint import model_state

    sa, sb = model_state(a), model_state(b)
    assert sa.keys() == sb.keys()
    return [(sa[k], sb[k]) for k in sa]


# ---------------------------------------------------------------------------
# kill -9 resume, end to end through the drivers
# ---------------------------------------------------------------------------


def _run(args, *, expect_kill=False, timeout=300):
    env = {**os.environ, "PHOTON_RETRY_BASE_S": "0.001"}
    r = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if expect_kill:
        assert r.returncode == -9, f"expected SIGKILL, got rc={r.returncode}\n{r.stderr[-2000:]}"
    else:
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r


def _tree_bytes(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _assert_tree_equal(a, b, label):
    ta, tb = _tree_bytes(a), _tree_bytes(b)
    assert ta.keys() == tb.keys(), (label, ta.keys() ^ tb.keys())
    diff = [k for k in ta if ta[k] != tb[k]]
    assert not diff, f"{label}: files differ after resume: {diff}"


@pytest.fixture(scope="module")
def glm_train(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "dev-scripts"))
    import chaos_matrix

    d = str(tmp_path_factory.mktemp("glm") / "train")
    chaos_matrix.gen_glm_data(d)
    return d


def _glm_args(train, out, ckpt, mode, plan=None):
    args = [
        "photon_ml_tpu_torch.cli.glm_driver", "--training-data-directory", train,
        "--output-directory", out, "--task", "LOGISTIC_REGRESSION",
        "--regularization-weights", "10,1,0.1", "--grid-mode", mode,
        "--num-iterations", "15", "--compute-variances", "true",
        "--delete-output-dirs-if-exist", "true", "--device", "cpu",
    ]
    if ckpt:
        args += ["--checkpoint-dir", ckpt]
    if plan:
        args += ["--fault-plan", plan]
    return args


@pytest.mark.parametrize("mode,plan", [
    # ckpt_save crossings: 1 = the run manifest, 2-3 = λ = 10's npz and
    # marker, 4 = λ = 1's npz
    ("sequential", "ckpt_save:4:KILL"),  # killed in λ = 1's snapshot
    ("sequential", "ckpt_save:2:KILL"),  # killed before any λ is committed
    ("batched", "ckpt_save:4:KILL"),  # the grid's snapshots half written
])
def test_glm_driver_killed_mid_sweep_resumes_bitwise(tmp_path, glm_train, mode, plan):
    """kill -9 at a ckpt_save crossing, then a rerun with the same args
    (no plan): the model files are bitwise an uninterrupted run's."""
    clean, kill, ckpt = (str(tmp_path / n) for n in ("out-clean", "out-kill", "ckpt"))
    _run(_glm_args(glm_train, clean, None, mode))
    _run(_glm_args(glm_train, kill, ckpt, mode, plan=plan), expect_kill=True)
    committed = sorted(f for f in os.listdir(ckpt) if f.startswith("lambda-") and f.endswith(".json"))
    assert len(committed) == (1 if plan.startswith("ckpt_save:4") else 0), committed
    _run(_glm_args(glm_train, kill, ckpt, mode))
    for sub in ("models", "models-text", "optimization-log.txt"):
        a, b = os.path.join(clean, sub), os.path.join(kill, sub)
        if os.path.isdir(a):
            _assert_tree_equal(a, b, sub)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), sub
    metrics = json.load(open(os.path.join(kill, "metrics.json")))
    assert metrics["reliability"]["faults"]["injected"] == {}


@pytest.fixture(scope="module")
def game_train(tmp_path_factory):
    from conftest import game_example_schema
    from photon_ml_tpu_torch.io.avro_codec import write_container
    from torch_game_cases import make_records

    data = tmp_path_factory.mktemp("game") / "train"
    data.mkdir()
    recs = make_records(11, n=240, n_users=8)
    for r in recs:
        r["metadataMap"] = {"userId": r.pop("userId")}
    write_container(str(data / "p0.avro"), game_example_schema(), recs)
    return str(data)


def _game_args(train, out, ckpt=None, plan=None):
    """The GAME training driver's options: a fixed effect and a factored
    per-user random effect, three CD iterations, on the CPU."""
    a = [
        "--train-input-dirs", train, "--output-dir", out,
        "--feature-shard-id-to-feature-section-keys-map",
        "globalShard:features|userShard:userFeatures",
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:20,1e-7,0.5,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,identity",
        "--random-effect-optimization-configurations", "per-user:20,1e-7,1,1,LBFGS,L2",
        "--factored-random-effect-optimization-configurations", "per-user:2,1",
        "--num-iterations", "3", "--model-output-mode", "BEST",
        "--delete-output-dir-if-exists", "true", "--device", "cpu",
    ]
    if ckpt:
        a += ["--checkpoint-dir", ckpt]
    if plan:
        a += ["--fault-plan", plan]
    return a


def test_game_driver_killed_mid_cd_resumes_bitwise(tmp_path, game_train):
    """The GAME training driver with a factored random effect: kill -9 at
    sweep 2's checkpoint, rerun, and the best model's files are bitwise an
    uninterrupted run's."""
    module = "photon_ml_tpu_torch.cli.game_training_driver"
    clean, kill, ckpt = (str(tmp_path / n) for n in ("out-clean", "out-kill", "ckpt"))
    _run([module, *_game_args(game_train, clean)])
    # ckpt_save crossings: the combo's manifest, step 1, its meta, step 2
    # -> killed writing step 2
    _run([module, *_game_args(game_train, kill, ckpt, "ckpt_save:4:KILL")], expect_kill=True)
    (combo,) = os.listdir(ckpt)
    assert TrainingCheckpointer(os.path.join(ckpt, combo)).latest_step() == 1
    _run([module, *_game_args(game_train, kill, ckpt)])
    _assert_tree_equal(
        os.path.join(clean, "best-model"), os.path.join(kill, "best-model"), "GAME best-model"
    )


def test_game_driver_preempted_before_the_first_combo_saves_nothing(
    tmp_path, game_train, monkeypatch
):
    """A preemption seen before any combo completes stops the sweep with
    no combo trained, and the driver writes no model (the reference's
    "no configuration combo completed" branch)."""
    from photon_ml_tpu_torch.cli import game_training_driver as gtd

    class RequestedGuard(PreemptionGuard):
        def install(self):
            super().install()
            self.request()
            return self

    monkeypatch.setattr(gtd, "PreemptionGuard", RequestedGuard)
    out = str(tmp_path / "out")
    driver = gtd.main(_game_args(game_train, out, str(tmp_path / "ckpt")))
    assert driver.best_result is None and driver.results == []
    assert not os.path.exists(os.path.join(out, "best-model"))
    assert not os.path.exists(os.path.join(out, "metrics.json"))
