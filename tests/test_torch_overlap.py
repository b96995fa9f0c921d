"""The port's overlap layer (``photon_ml_tpu_torch/parallel/overlap.py``):
the reference's ``tests/test_overlap.py`` cases (``TestDeferred``,
``TestReadbackDiscipline``, ``TestAsyncCheckpointIO``) pointed at the
port, on the CPU. A CD iteration makes exactly one readback, however many
coordinates and buckets it updates; overlap on and off give bitwise the
same models.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FeatureShardConfiguration,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    RandomEffectDataConfiguration,
    RandomEffectOptimizationProblem,
    build_game_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.task import TaskType

SHARDS = [
    FeatureShardConfiguration("globalShard", ["features"], add_intercept=True),
    FeatureShardConfiguration("userShard", ["userFeatures"], add_intercept=True),
]


def _records(rng, n=240, n_users=10, d_global=5, d_user=3):
    """GLMix records with skewed per-user counts, so that the RE dataset
    lands in several capacity-class buckets (the per-bucket readback
    hazard the discipline test guards against)."""
    w_global = np.linspace(-1, 1, d_global)
    w_user = rng.normal(size=(n_users, d_user)).astype(np.float32)
    # user 0 takes half the rows; the rest spread thin -> >= 2 cap classes
    users = np.concatenate([np.zeros(n // 2, np.int64), rng.integers(1, n_users, size=n - n // 2)])
    recs = []
    for i in range(n):
        u = int(users[i])
        xg = rng.normal(size=d_global).astype(np.float32)
        xu = rng.normal(size=d_user).astype(np.float32)
        z = float(xg @ w_global + xu @ w_user[u])
        recs.append({
            "uid": f"r{i}",
            "response": float(1 / (1 + np.exp(-z)) > rng.uniform()),
            "userId": f"user{u:03d}",
            "features": [{"name": f"g{j}", "term": "", "value": float(xg[j])} for j in range(d_global)],
            "userFeatures": [
                {"name": f"u{j}", "term": "", "value": float(xu[j])} for j in range(d_user)
            ],
        })
    return recs


def _cd(rng, checkpointer=None):
    ds = build_game_dataset(_records(rng), SHARDS, ["userId"], device="cpu")
    red = build_random_effect_dataset(ds, RandomEffectDataConfiguration("userId", "userShard"))
    l2 = RegularizationContext(RegularizationType.L2)
    coords = {
        "global": FixedEffectCoordinate(
            name="global", dataset=ds,
            problem=create_glm_problem(
                TaskType.LOGISTIC_REGRESSION, ds.shards["globalShard"].dim,
                config=OptimizerConfig(max_iter=20), regularization=l2,
            ),
            feature_shard_id="globalShard", reg_weight=0.1,
        ),
        "per-user": RandomEffectCoordinate(
            name="per-user", dataset=ds, re_dataset=red,
            problem=RandomEffectOptimizationProblem(
                LOGISTIC, OptimizerConfig(max_iter=20), l2, reg_weight=1.0,
            ),
        ),
    }
    assert len(red.buckets) >= 2, "need several buckets for the test"
    return CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION, checkpointer=checkpointer)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestDeferred:
    def test_fetch_all_is_one_readback(self):
        with overlap.overlap_scope(True):
            ds = [overlap.Deferred(torch.tensor(float(i)), float) for i in range(5)]
            overlap.reset_readback_stats()
            before = common.host_fetches
            overlap.fetch_all(ds)
            assert overlap.readback_stats() == 1
            assert common.host_fetches == before + 1
            assert [d.result() for d in ds] == [0.0, 1.0, 2.0, 3.0, 4.0]
            overlap.fetch_all(ds)  # already fetched: never again
            assert overlap.readback_stats() == 1

    def test_nested_values_come_back_as_numpy(self):
        with overlap.overlap_scope(True):
            d = overlap.Deferred(
                [(3, torch.arange(4), [1, 2]), {"x": torch.tensor(2.5)}], None
            )
            (n, it, plain), rest = d.result()
            assert n == 3 and plain == [1, 2] and rest["x"] == 2.5
            np.testing.assert_array_equal(it, np.arange(4))

    def test_unfetched_deferred_forces_itself(self):
        with overlap.overlap_scope(True):
            d = overlap.Deferred(torch.tensor(7.0), float)
            overlap.reset_readback_stats()
            assert d.result() == 7.0
            assert overlap.readback_stats() == 1

    def test_overlap_off_fetches_eagerly(self):
        with overlap.overlap_scope(False):
            overlap.reset_readback_stats()
            d = overlap.Deferred(torch.tensor(3.0), float)
            assert overlap.readback_stats() == 1  # eager, serial order
            assert d.done and d.result() == 3.0

    def test_submit_inline_when_off(self):
        with overlap.overlap_scope(False):
            seen = []
            fut = overlap.submit(seen.append, 1)
            assert seen == [1]  # ran before submit returned
            overlap.wait(fut)

    def test_submit_io_failure_surfaces_at_drain(self, monkeypatch):
        monkeypatch.setenv("PHOTON_RETRY_ATTEMPTS", "1")
        monkeypatch.setenv("PHOTON_RETRY_BASE_S", "0.001")

        def boom():
            raise OSError("disk gone")

        with overlap.overlap_scope(True):
            overlap.submit_io(boom, artifact="scores/part-00007.avro")
            with pytest.raises(RuntimeError, match="scores/part-00007.avro") as ei:
                overlap.drain_io()
            # RuntimeError -> SeamFailure (the retry budget) -> the OSError
            assert "disk gone" in str(ei.value.__cause__.__cause__)
            overlap.drain_io()  # the failure is consumed, the barrier clean

    def test_submit_io_failure_does_not_block_later_writes(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PHOTON_RETRY_ATTEMPTS", "1")
        monkeypatch.setenv("PHOTON_RETRY_BASE_S", "0.001")

        def boom():
            raise OSError("disk gone")

        ok = tmp_path / "later.txt"
        with overlap.overlap_scope(True):
            overlap.submit_io(boom, artifact="first")
            overlap.submit_io(ok.write_text, "landed", artifact="second")
            with pytest.raises(RuntimeError, match="first"):
                overlap.drain_io()
        assert ok.read_text() == "landed"  # the write queued behind it landed

    def test_submit_io_crosses_the_io_worker_seam(self, tmp_path):
        from photon_ml_tpu_torch.reliability import install_plan, retry_stats
        from photon_ml_tpu_torch.reliability import reset_fault_stats, reset_retry_stats

        reset_retry_stats()
        install_plan("io_worker:1:EIO")
        try:
            with overlap.overlap_scope(True):
                overlap.submit_io((tmp_path / "a.txt").write_text, "x", artifact="a")
                overlap.drain_io()
        finally:
            reset_fault_stats()
        assert (tmp_path / "a.txt").read_text() == "x"
        assert retry_stats()["retries"]["io_worker"] == 1
        reset_retry_stats()


class TestReadbackDiscipline:
    def test_one_batched_readback_per_cd_iteration(self, rng):
        """A GAME CD iteration (FE + several RE buckets: trackers,
        objective and reg terms) performs exactly one readback."""
        with overlap.overlap_scope(True):
            cd = _cd(rng)
            overlap.reset_readback_stats()
            result = cd.run(num_iterations=3)
            assert overlap.readback_stats() == 3
        assert len(result.objective_history) == 3
        # the tracker facades were fetched in the batch: reading adds none
        before = overlap.readback_stats()
        t = result.trackers["per-user"][-1]
        assert t.num_entities == 10
        assert overlap.readback_stats() == before

    def test_serial_mode_reads_back_more(self, rng):
        """Serial execution pulls the tracker and the objective apart: the
        seam is not bypassed."""
        with overlap.overlap_scope(False):
            cd = _cd(rng)
            overlap.reset_readback_stats()
            cd.run(num_iterations=1)
            assert overlap.readback_stats() >= 2

    def test_overlap_equals_serial(self):
        results = {}
        for label, enabled in (("overlap", True), ("serial", False)):
            with overlap.overlap_scope(enabled):
                results[label] = _cd(np.random.default_rng(7)).run(num_iterations=2)
        a, b = results["overlap"], results["serial"]
        assert a.objective_history == b.objective_history
        assert torch.equal(a.model.get_model("global").model.means,
                           b.model.get_model("global").model.means)
        assert torch.equal(a.model.get_model("per-user").bank, b.model.get_model("per-user").bank)
        for x, y in zip(a.trackers["per-user"], b.trackers["per-user"]):
            assert x.num_entities == y.num_entities
            assert x.iterations_max == y.iterations_max
            assert x.reason_counts == y.reason_counts


class TestAsyncCheckpointIO:
    def test_checkpoints_on_disk_after_run(self, rng, tmp_path):
        from photon_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

        with overlap.overlap_scope(True):
            ckpt = TrainingCheckpointer(str(tmp_path / "ckpt"))
            try:
                _cd(rng, checkpointer=ckpt).run(num_iterations=2)
                # run() drained: the latest step is durable now
                assert ckpt.latest_step() == 2
                assert ckpt.load_meta()["best_step"] is None
            finally:
                ckpt.close()
