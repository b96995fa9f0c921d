"""The port's model registry (``photon_ml_tpu_torch/registry/``) on the CPU,
held to ``tests/test_registry.py`` case by case and against the JAX
package on the same seeded inputs.

- publish protocol: COMMIT-marker visibility, idempotent republish,
  refusal / quarantine / retention, the single-writer lease with
  dead-owner takeover, and a KILL at every ``registry.publish`` crossing
  (committed-or-nothing, the resumed publish bitwise the uninterrupted
  one);
- one file format across the packages: the port's publish of a candidate
  is byte-identical to the JAX package's, each package reads the other's
  registry, and each one's lease excludes the other's publisher;
- drift-safe alignment: the reference's matrix, and ``align_coefficients``
  / ``align_re_bank`` / ``warm_start_game_model`` bitwise the JAX
  package's;
- validation gates: the reference's verdicts, and the same verdicts as
  the JAX package's ``evaluate_gates`` with every measurement within
  1e-12 relative (AUC and drift are float64 numpy in both; the RMSE
  branch's mean transform is float32 in both, held to 1e-6 relative);
- the watcher: promotion, auto-rollback with quarantine, the burn gate;
  and on the port's CPU ``ServingModel``: a rollback restores the parent
  bank bitwise after an in-place swap (same spec) and after a swap that
  changed the bank's shape (a new entity), and the front end's status
  lineage and rollback op.
"""

import filecmp
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu.registry import gates as ref_gates
from photon_ml_tpu.registry import registry as ref_registry
from photon_ml_tpu.registry import warm_start as ref_warm
from photon_ml_tpu_torch.registry import (
    DriftReport,
    GateConfig,
    GateReport,
    ModelRegistry,
    RefusedCandidate,
    RegistryLeaseHeld,
    RegistryWatcher,
    RollbackPolicy,
    align_coefficients,
    align_re_bank,
    content_signature,
    evaluate_gates,
)
from photon_ml_tpu_torch.registry.registry import _Lease
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.testing.determinism import byte_diff_trees
from photon_ml_tpu_torch.utils.index_map import IndexMap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_model(path, payload=b"MODEL-BYTES-1"):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.avro"), "wb") as f:
        f.write(payload)
    return path


@pytest.fixture()
def model_dir(tmp_path):
    return _write_model(str(tmp_path / "candidate"))


@pytest.fixture()
def registry(tmp_path):
    return ModelRegistry(str(tmp_path / "registry"))


class TestPublish:
    def test_publish_commit_and_lineage(self, registry, model_dir, tmp_path):
        info = registry.publish(model_dir, data_ranges={"train_dir": "d1"})
        assert info.generation == 1
        assert registry.latest().generation == 1
        assert registry.latest().gate_verdict == "UNGATED"
        m2 = _write_model(str(tmp_path / "m2"), b"MODEL-BYTES-2")
        info2 = registry.publish(m2, parent=1)
        assert info2.parent == 1
        assert registry.lineage() == [2, 1]
        assert info.manifest["data_ranges"] == {"train_dir": "d1"}
        assert info2.signature == content_signature(m2)

    def test_uncommitted_generation_is_invisible(self, registry, model_dir):
        info = registry.publish(model_dir)
        os.unlink(os.path.join(info.path, "COMMIT"))
        assert registry.latest() is None
        assert registry.list_generations() == []

    def test_republish_same_content_is_idempotent(self, registry, model_dir):
        a = registry.publish(model_dir)
        b = registry.publish(model_dir)
        assert (a.generation, a.signature) == (b.generation, b.signature)
        assert [g.generation for g in registry.list_generations()] == [1]

    def test_refused_candidate_never_loadable(self, registry, model_dir, tmp_path):
        registry.publish(model_dir)
        bad = _write_model(str(tmp_path / "bad"), b"BAD-MODEL")
        with pytest.raises(RefusedCandidate) as ei:
            registry.publish(
                bad, parent=1, gate_report={"verdict": "AUC_REGRESSION", "checks": {}}
            )
        assert ei.value.verdict == "AUC_REGRESSION"
        assert [g.generation for g in registry.list_generations()] == [1]
        refusals = registry.refused_candidates()
        assert len(refusals) == 1
        assert refusals[0]["gates"]["verdict"] == "AUC_REGRESSION"
        assert refusals[0]["signature"] == content_signature(bad)

    def test_quarantine_hides_generation_and_burns_number(self, registry, model_dir, tmp_path):
        registry.publish(model_dir)
        registry.publish(_write_model(str(tmp_path / "m2"), b"G2"), parent=1)
        q = registry.quarantine_generation(2, reason="rollback test")
        assert q is not None and os.path.isdir(q)
        assert registry.latest().generation == 1
        with open(os.path.join(q, "quarantine.json")) as f:
            assert json.load(f)["reason"] == "rollback test"
        m3 = _write_model(str(tmp_path / "m3"), b"G3")
        assert registry.publish(m3, parent=1).generation == 3

    def test_gc_keeps_referenced_parents(self, registry, tmp_path):
        for i in range(5):
            m = _write_model(str(tmp_path / f"m{i}"), f"G{i}".encode())
            parent = registry.latest()
            registry.publish(m, parent=parent.generation if parent else None)
        removed = registry.gc(keep=2)
        assert [g.generation for g in registry.list_generations()] == [3, 4, 5]
        assert removed == [1, 2]

    def test_missing_model_dir_fails_before_lease(self, registry):
        with pytest.raises(ValueError, match="does not exist"):
            registry.publish(str(registry.root) + "/nope")


class TestLease:
    def test_live_holder_wins_second_publisher_loses_cleanly(self, registry, model_dir):
        registry._ensure_layout()
        holder = _Lease(registry.root)
        holder.acquire()
        try:
            with pytest.raises(RegistryLeaseHeld):
                registry.publish(model_dir)
            assert registry.list_generations() == []
            assert os.listdir(registry.generations_dir) == []
        finally:
            holder.release()
        assert registry.publish(model_dir).generation == 1

    def test_dead_owner_lease_is_broken(self, registry, model_dir):
        registry._ensure_layout()
        with open(os.path.join(registry.root, "lease.json"), "w") as f:
            json.dump({"pid": 2 ** 30, "host": socket.gethostname(), "token": "dead"}, f)
        assert registry.publish(model_dir).generation == 1

    def test_torn_lease_file_is_broken(self, registry, model_dir):
        registry._ensure_layout()
        with open(os.path.join(registry.root, "lease.json"), "w") as f:
            f.write('{"pid": 12')
        assert registry.publish(model_dir).generation == 1

    @pytest.mark.parametrize("holder_pkg", ["jax", "port"])
    def test_one_packages_lease_excludes_the_others_publisher(self, tmp_path, model_dir, holder_pkg):
        """Both packages take the same ``lease.json`` with O_EXCL: a live
        holder of either excludes the other's publisher, which writes
        nothing."""
        root = str(tmp_path / "shared")
        port_reg, ref_reg = ModelRegistry(root), ref_registry.ModelRegistry(root)
        port_reg._ensure_layout()
        if holder_pkg == "jax":
            holder, loser, held = ref_registry._Lease(root), port_reg, RegistryLeaseHeld
        else:
            holder, loser, held = _Lease(root), ref_reg, ref_registry.RegistryLeaseHeld
        holder.acquire()
        try:
            with pytest.raises(held):
                loser.publish(model_dir)
            assert os.listdir(port_reg.generations_dir) == []
        finally:
            holder.release()
        assert loser.publish(model_dir).generation == 1


_PUBLISH_HELPER = """
import sys
sys.path.insert(0, {repo!r})
from photon_ml_tpu_torch.registry import ModelRegistry
info = ModelRegistry(sys.argv[1]).publish(
    sys.argv[2], parent=None, data_ranges={{"train_dir": "d"}}
)
print(info.generation, "torch" in sys.modules)
"""


def _tree_equal(a, b):
    for root, _dirs, files in os.walk(a):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), a)
            if not filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False):
                return False
    return True


class TestPublishKillMatrix:
    """A fault-plan KILL at every ``registry.publish`` crossing: the loader
    view is committed-or-nothing, and the resumed publish is bitwise the
    uninterrupted one. The port's registry imports without torch, so each
    child is sub-second."""

    def _publish(self, reg_dir, model, plan=None):
        env = dict(os.environ)
        env.pop("PHOTON_FAULT_PLAN", None)
        if plan:
            env["PHOTON_FAULT_PLAN"] = plan
        return subprocess.run(
            [sys.executable, "-c", _PUBLISH_HELPER.format(repo=REPO), reg_dir, model],
            capture_output=True, text=True, env=env, timeout=60,
        )

    def test_kill_at_every_crossing_never_partial_resume_bitwise(self, tmp_path):
        model = _write_model(str(tmp_path / "model"), b"KILL-MATRIX")
        ref = str(tmp_path / "reg-ref")
        r = self._publish(ref, model)
        assert r.returncode == 0, r.stderr
        # the publisher's process never imported torch
        assert r.stdout.split() == ["1", "False"]
        ref_gen = os.path.join(ref, "generations", "g000001")
        saw_kill = 0
        for n in range(1, 8):
            reg_dir = str(tmp_path / f"reg-k{n}")
            r = self._publish(reg_dir, model, plan=f"registry.publish:{n}:KILL")
            killed = r.returncode == -9
            saw_kill += int(killed)
            vis = [g.generation for g in ModelRegistry(reg_dir).list_generations()]
            assert vis in ([], [1]), (n, vis)
            if vis == [1]:
                assert _tree_equal(ref_gen, os.path.join(reg_dir, "generations", "g000001")), n
            r2 = self._publish(reg_dir, model)
            assert r2.returncode == 0, (n, r2.stderr)
            vis2 = [g.generation for g in ModelRegistry(reg_dir).list_generations()]
            assert vis2 == [1], (n, vis2)
            assert _tree_equal(ref_gen, os.path.join(reg_dir, "generations", "g000001")), n
            if not killed:
                break
        assert saw_kill >= 4

    def test_kill_mid_stage_leaves_adoptable_or_invisible_state(self, tmp_path):
        model = _write_model(str(tmp_path / "model"), b"ADOPT-ME")
        reg_dir = str(tmp_path / "reg")
        r = self._publish(reg_dir, model, plan="registry.publish:4:KILL")
        assert r.returncode == -9
        gen_dir = os.path.join(reg_dir, "generations", "g000001")
        assert os.path.isdir(gen_dir)
        assert not os.path.exists(os.path.join(gen_dir, "COMMIT"))
        assert ModelRegistry(reg_dir).list_generations() == []
        model_sig = content_signature(os.path.join(gen_dir, "model"))
        r2 = self._publish(reg_dir, model)
        assert r2.returncode == 0, r2.stderr
        assert ModelRegistry(reg_dir).latest().generation == 1
        assert content_signature(os.path.join(gen_dir, "model")) == model_sig
        assert os.path.isfile(os.path.join(gen_dir, "COMMIT"))


class TestCrossPackage:
    """One registry format: either package publishes, either reads."""

    def _candidate(self, tmp_path):
        m = _write_model(str(tmp_path / "cand"), b"\x00SHARED-ARTIFACT\xff")
        os.makedirs(os.path.join(m, "feature-index"))
        with open(os.path.join(m, "feature-index", "index.json"), "w") as f:
            f.write('{"a\\t": 0}')
        return m

    def test_publish_tree_is_byte_identical(self, tmp_path):
        m = self._candidate(tmp_path)
        gates = {"verdict": "PASS", "checks": {"auc": {"passed": True}}}
        for pkg, reg in (("port", ModelRegistry), ("jax", ref_registry.ModelRegistry)):
            r = reg(str(tmp_path / pkg))
            r.publish(m, data_ranges={"train": "2026-01"}, gate_report=gates, extra={"task": "X"})
            r.publish(_write_model(str(tmp_path / f"m2-{pkg}"), b"G2"), parent=1)
            r.quarantine_generation(2, reason="same in both")
        assert byte_diff_trees(str(tmp_path / "port"), str(tmp_path / "jax")) is None

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_each_package_reads_the_others_registry(self, tmp_path, writer):
        m = self._candidate(tmp_path)
        m2 = _write_model(str(tmp_path / "m2"), b"G2")
        root = str(tmp_path / "reg")
        w_cls, r_cls = (
            (ref_registry.ModelRegistry, ModelRegistry) if writer == "jax"
            else (ModelRegistry, ref_registry.ModelRegistry)
        )
        w = w_cls(root)
        w.publish(m, data_ranges={"d": 1})
        w.publish(m2, parent=1, gate_report={"verdict": "PASS", "checks": {}})
        reader = r_cls(root)
        assert reader.latest().generation == 2
        assert reader.lineage() == [2, 1]
        assert reader.latest().signature == content_signature(m2)
        assert reader.generation(1).signature == ref_registry.content_signature(m)
        assert reader.latest().gate_verdict == "PASS"
        # the reader's next publish continues the writer's numbering
        m3 = _write_model(str(tmp_path / "m3"), b"G3")
        assert reader.publish(m3, parent=2).generation == 3
        assert w.lineage() == [3, 2, 1]


class TestDriftAlignment:
    def test_no_drift_is_bitwise(self):
        imap = IndexMap.build(["a\t", "b\t", "c\t"])
        parent = {"a\t": 0.1234567, "b\t": -2.5e-8, "c\t": 3.0}
        report = DriftReport()
        vec = align_coefficients(parent, imap, report=report)
        assert report.no_drift
        expected = np.zeros(3, np.float32)
        for k, v in parent.items():
            expected[imap.get_index(k)] = np.float32(v)
        assert vec.dtype == np.float32
        assert np.array_equal(vec, expected)

    def test_vocab_grow_zero_inits_new_terms(self):
        imap = IndexMap.build(["a\t", "b\t", "new\t"])
        report = DriftReport()
        vec = align_coefficients({"a\t": 1.0, "b\t": 2.0}, imap, report=report)
        assert vec[imap.get_index("new\t")] == 0.0
        assert (report.kept, report.new_zero_init, report.dropped) == (2, 1, 0)
        assert not report.no_drift

    def test_vocab_shrink_drops_with_accounting(self):
        imap = IndexMap.build(["a\t"])
        report = DriftReport()
        vec = align_coefficients({"a\t": 1.0, "gone\t": 9.0}, imap, report=report)
        assert vec.shape == (1,)
        assert report.dropped == 1
        assert "gone\t" in report.dropped_keys_sample

    def test_reshuffled_indices_align_by_key(self):
        imap = IndexMap.build(["z\t", "a\t", "m\t"])
        vec = align_coefficients({"a\t": 1.0, "m\t": 2.0, "z\t": 3.0}, imap)
        assert vec[imap.get_index("a\t")] == 1.0
        assert vec[imap.get_index("z\t")] == 3.0

    def _re_fixture(self):
        imap = IndexMap.build(["u0\t", "u1\t", "u2\t"])
        proj = np.asarray([[imap.get_index(f"u{j}\t") for j in range(3)]] * 3, np.int32)
        return imap, proj

    def test_re_bank_no_drift_bitwise(self):
        imap, proj = self._re_fixture()
        parent = {"e0": {"u0\t": 0.5, "u1\t": -0.125}, "e1": {"u2\t": 7.0}, "e2": {"u0\t": 1e-30}}
        report = DriftReport()
        bank = align_re_bank(parent, ["e0", "e1", "e2"], proj, imap, report=report)
        assert report.no_drift and report.kept_entities == 3
        expected = np.zeros((3, 3), np.float32)
        for e, eid in enumerate(["e0", "e1", "e2"]):
            for k, v in parent[eid].items():
                expected[e, imap.get_index(k)] = np.float32(v)
        assert np.array_equal(bank, expected)

    def test_re_entity_churn_prior_mean_init(self):
        imap, proj = self._re_fixture()
        report = DriftReport()
        bank = align_re_bank(
            {"e0": {"u0\t": 1.0}, "e1": {"u0\t": 3.0}}, ["e0", "e1", "NEW"],
            np.asarray([proj[0]] * 3, np.int32), imap, report=report,
        )
        assert report.churned_entities_prior_init == 1
        assert bank[2, imap.get_index("u0\t")] == np.float32(2.0)
        assert not report.no_drift

    def test_re_dropped_entity_accounting(self):
        imap, proj = self._re_fixture()
        report = DriftReport()
        align_re_bank({"kept": {"u0\t": 1.0}, "gone": {"u0\t": 5.0}}, ["kept"], proj[:1], imap,
                      report=report)
        assert (report.dropped_entities, report.kept_entities) == (1, 1)

    @pytest.mark.parametrize("drift", [False, True])
    def test_alignment_is_bitwise_the_jax_packages(self, rng, drift):
        """Seeded parents over a vocabulary that drifts (or not): the same
        vector, bank and report as the JAX package's."""
        from photon_ml_tpu.utils.index_map import IndexMap as RefIndexMap

        keys = [f"f{i}\t" for i in range(40)]
        parent = {k: float(rng.normal()) for k in keys}
        per_entity = {
            f"e{e}": {k: float(rng.normal()) for k in rng.choice(keys, 6, replace=False)}
            for e in range(12)
        }
        new_keys = keys[5:] + [f"n{i}\t" for i in range(4)] if drift else keys
        entities = [f"e{e}" for e in range(3, 12)] + ["fresh0", "fresh1"] if drift else list(
            per_entity)
        imap, ref_imap = IndexMap.build(new_keys), RefIndexMap.build(new_keys)
        assert dict(imap.items()) == dict(ref_imap.items())
        # each entity's slots: its parent terms still in the vocabulary
        # (a new entity gets random ones), padded with -1
        D = 8
        proj = np.full((len(entities), D), -1, np.int32)
        for e, eid in enumerate(entities):
            own = [imap.get_index(k) for k in per_entity.get(eid, {})]
            own = [i for i in own if i >= 0] or list(rng.choice(imap.size, 6, replace=False))
            proj[e, :len(own)] = np.sort(own)
        got_r, want_r = DriftReport(), ref_warm.DriftReport()
        got = align_coefficients(parent, imap, report=got_r)
        want = ref_warm.align_coefficients(parent, ref_imap, report=want_r)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        got_b = align_re_bank(per_entity, entities, proj, imap, report=got_r)
        want_b = ref_warm.align_re_bank(per_entity, entities, proj, ref_imap, report=want_r)
        assert got_b.dtype == want_b.dtype and np.array_equal(got_b, want_b)
        assert got_r.as_dict() == want_r.as_dict()
        assert got_r.no_drift is (not drift)


def _game_world(rng, n_users=6, extra_user=False):
    """The same GAME records and a parent LoadedGameModel, for both
    packages: one FE and one per-user IDENTITY RE coordinate."""
    from torch_serving_cases import synth_model_dicts, synth_records

    recs = synth_records(rng, n=80, n_users=n_users + int(extra_user))
    fixed, random = synth_model_dicts(rng, n_users=n_users, drop_user=False)
    return recs, fixed, random


def test_warm_start_game_model_is_bitwise_the_jax_packages(rng):
    """A parent over 6 users warm-starts a dataset with a 7th: FE vector,
    RE bank (the new user at the prior mean) and drift reports equal the
    JAX package's bitwise."""
    from photon_ml_tpu.game.config import FeatureShardConfiguration as RefShard
    from photon_ml_tpu.game.config import ProjectorType as RefProjector
    from photon_ml_tpu.game.config import RandomEffectDataConfiguration as RefRECfg
    from photon_ml_tpu.game.data import build_game_dataset as ref_build
    from photon_ml_tpu.game.model_io import LoadedGameModel as RefLoaded
    from photon_ml_tpu.game.random_effect_data import build_random_effect_dataset as ref_red
    from photon_ml_tpu.task import TaskType as RefTask
    from photon_ml_tpu_torch.game.config import ProjectorType, RandomEffectDataConfiguration
    from photon_ml_tpu_torch.game.data import build_game_dataset
    from photon_ml_tpu_torch.game.model_io import LoadedGameModel
    from photon_ml_tpu_torch.game.random_effect_data import build_random_effect_dataset
    from photon_ml_tpu_torch.registry import warm_start_game_model
    from torch_serving_cases import SHARDS

    recs, fixed, random = _game_world(rng, extra_user=True)
    ds = build_game_dataset(recs, SHARDS, ["userId"], device="cpu")
    ref_ds = ref_build(recs, [RefShard(s.shard_id, s.feature_bags) for s in SHARDS], ["userId"])
    red = build_random_effect_dataset(
        ds, RandomEffectDataConfiguration("userId", "u", projector_type=ProjectorType.IDENTITY))
    ref_re = ref_red(ref_ds, RefRECfg("userId", "u", projector_type=RefProjector.IDENTITY))
    lm, ref_lm = LoadedGameModel(), RefLoaded()
    lm.fixed_effects = ref_lm.fixed_effects = fixed
    lm.random_effects = ref_lm.random_effects = random
    model, reports = warm_start_game_model(lm, ds, {"per-user": red}, TaskType.LOGISTIC_REGRESSION)
    ref_model, ref_reports = ref_warm.warm_start_game_model(
        ref_lm, ref_ds, {"per-user": ref_re}, RefTask.LOGISTIC_REGRESSION)
    fe, ref_fe = model.models["global"], ref_model.models["global"]
    assert fe.model.means.device.type == "cpu"
    assert np.array_equal(fe.model.means.numpy(), np.asarray(ref_fe.model.means))
    bank, ref_bank = model.models["per-user"].bank, ref_model.models["per-user"].bank
    assert bank.dtype == torch.float32
    assert np.array_equal(bank.numpy(), np.asarray(ref_bank))
    assert {k: r.as_dict() for k, r in reports.items()} == {
        k: r.as_dict() for k, r in ref_reports.items()}
    assert reports["per-user"].churned_entities_prior_init == 1
    # the dataset adds the intercept, which the parent lacks: zero-init
    assert (reports["global"].kept, reports["global"].new_zero_init) == (5, 1)


def _gate_chunks(cand_shift=0.0, n=400, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    y = (1 / (1 + np.exp(-z)) > rng.uniform(size=n)).astype(np.float64)
    return [(z + cand_shift * rng.normal(size=n), z, y, np.ones(n))]


class TestGates:
    def test_identical_models_pass(self):
        report = evaluate_gates(_gate_chunks(0.0), TaskType.LOGISTIC_REGRESSION,
                                candidate_norm=1.0, parent_norm=1.0)
        assert report.verdict == "PASS" and report.passed
        assert report.checks["auc"]["passed"]

    def test_auc_regression_named_verdict(self):
        rng = np.random.default_rng(1)
        _c, par, y, w = _gate_chunks(0.0)[0]
        report = evaluate_gates([(rng.normal(size=len(y)), par, y, w)],
                                TaskType.LOGISTIC_REGRESSION)
        assert report.verdict == "AUC_REGRESSION"
        assert not report.checks["auc"]["passed"]

    def test_coef_norm_blowup_named_verdict(self):
        report = evaluate_gates(_gate_chunks(0.0), TaskType.LOGISTIC_REGRESSION,
                                candidate_norm=1e4, parent_norm=1.0)
        assert report.verdict == "COEF_NORM_BLOWUP"
        assert report.checks["coef_norm"]["ratio"] == pytest.approx(1e4)

    def test_prediction_drift_named_verdict(self):
        report = evaluate_gates(
            _gate_chunks(5.0), TaskType.LOGISTIC_REGRESSION,
            config=GateConfig(max_auc_drop=1.0, max_prediction_drift=0.1))
        assert report.verdict == "PREDICTION_DRIFT"

    def test_rmse_gate_on_regression_task(self):
        rng = np.random.default_rng(2)
        y = rng.normal(size=300)
        par, cand = y + 0.1 * rng.normal(size=300), y + 3.0 * rng.normal(size=300)
        report = evaluate_gates([(cand, par, y, np.ones(300))], TaskType.LINEAR_REGRESSION,
                                device="cpu")
        assert report.verdict == "RMSE_REGRESSION"

    def test_empty_holdout_refuses(self):
        assert evaluate_gates([], TaskType.LOGISTIC_REGRESSION).verdict == "EMPTY_HOLDOUT"

    def test_report_round_trips_through_manifest(self, registry, model_dir, tmp_path):
        passing = evaluate_gates(_gate_chunks(0.0), TaskType.LOGISTIC_REGRESSION,
                                 candidate_norm=1.0, parent_norm=1.0)
        info = registry.publish(model_dir, gate_report=passing.as_dict())
        loaded = GateReport.from_dict(info.manifest["gates"])
        assert loaded.verdict == "PASS" and loaded.as_dict() == passing.as_dict()
        failing = evaluate_gates(_gate_chunks(0.0), TaskType.LOGISTIC_REGRESSION,
                                 candidate_norm=1e6, parent_norm=1.0)
        with pytest.raises(RefusedCandidate):
            registry.publish(_write_model(str(tmp_path / "bad"), b"BAD"), parent=1,
                             gate_report=failing.as_dict())
        rec = registry.refused_candidates()[0]
        assert GateReport.from_dict(rec["gates"]).verdict == "COEF_NORM_BLOWUP"

    # (task, chunk builder, config, norms): each yields one verdict
    CASES = {
        "pass": ("LOGISTIC_REGRESSION", 0.0, {}, (1.0, 1.0)),
        "auc": ("LOGISTIC_REGRESSION", 3.0, {"max_auc_drop": 0.02}, None),
        "norm": ("LOGISTIC_REGRESSION", 0.0, {}, (50.0, 2.0)),
        "drift": ("LOGISTIC_REGRESSION", 0.7, {"max_auc_drop": 1.0, "max_prediction_drift": 0.3},
                  None),
        "svm": ("SMOOTHED_HINGE_LOSS_LINEAR_SVM", 0.2, {}, (0.0, 0.0)),
        "rmse-pass": ("LINEAR_REGRESSION", 0.01, {}, (1.0, 1.0)),
        "rmse": ("LINEAR_REGRESSION", 2.0, {}, None),
        "poisson": ("POISSON_REGRESSION", 0.5, {"max_rmse_increase": 0.05}, None),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_same_verdicts_and_measurements_as_the_jax_package(self, case):
        """Three seeded chunks through both packages' ``evaluate_gates``:
        equal verdicts and check names; AUC, drift and norm measurements
        within 1e-12 relative (float64 on the host in both), RMSE within
        1e-6 (its mean transform is float32 in both)."""
        from photon_ml_tpu.task import TaskType as RefTask

        task, shift, cfg, norms = self.CASES[case]
        rng = np.random.default_rng(sorted(self.CASES).index(case))
        chunks = []
        for _ in range(3):
            n = 300
            z = rng.normal(size=n) * 0.5
            if task == "LINEAR_REGRESSION":
                y = z + 0.3 * rng.normal(size=n)
            elif task == "POISSON_REGRESSION":
                y = rng.poisson(np.exp(z)).astype(np.float64)
            else:
                y = (1 / (1 + np.exp(-z)) > rng.uniform(size=n)).astype(np.float64)
            w = rng.uniform(0.5, 2.0, size=n)
            chunks.append((z + shift * rng.normal(size=n), z, y, w))
        kw = {} if norms is None else {"candidate_norm": norms[0], "parent_norm": norms[1]}
        got = evaluate_gates(chunks, TaskType[task], config=GateConfig(**cfg), device="cpu", **kw)
        want = ref_gates.evaluate_gates(
            chunks, RefTask[task], config=ref_gates.GateConfig(**cfg), **kw)
        assert got.verdict == want.verdict
        assert got.config == want.config
        assert sorted(got.checks) == sorted(want.checks)
        for name, check in want.checks.items():
            rtol = 1e-6 if name == "rmse" else 1e-12
            for key, value in check.items():
                if isinstance(value, float) and np.isfinite(value):
                    assert got.checks[name][key] == pytest.approx(value, rel=rtol), (name, key)
                else:
                    assert got.checks[name][key] == value, (name, key)


class _StubSwapper:
    """ServingModel-shaped stub: records swaps, optional failure."""

    def __init__(self):
        self.swapped_dirs = []
        self.fail_next = False

    def stage_and_swap(self, model_dir, **kw):
        from photon_ml_tpu_torch.serving.swap import SwapResult

        self.swapped_dirs.append(model_dir)
        if self.fail_next:
            self.fail_next = False
            return SwapResult(ok=False, generation=0, rolled_back=True, error="boom")
        return SwapResult(ok=True, generation=len(self.swapped_dirs))


def _two_generations(registry, model_dir, tmp_path):
    g1 = registry.publish(model_dir)
    registry.publish(_write_model(str(tmp_path / "m2"), b"G2"), parent=1)
    return g1


class TestWatcher:
    def _watcher(self, registry, swapper, **kw):
        kw.setdefault("poll_s", 30.0)  # poke-driven in tests
        return RegistryWatcher(registry, swapper, **kw)

    def test_promotes_new_generation(self, registry, model_dir):
        g1 = registry.publish(model_dir)
        swapper = _StubSwapper()
        w = self._watcher(registry, swapper, initial_generation=g1)
        w._check_registry()
        assert swapper.swapped_dirs == []
        registry.publish(_write_model(os.path.join(registry.root, os.pardir, "m2"), b"G2"),
                         parent=1)
        w._check_registry()
        assert swapper.swapped_dirs == [registry.generation(2).model_dir]
        lin = w.lineage()
        assert (lin["registry_generation"], lin["parent"], lin["lineage"]) == (2, 1, [2, 1])
        assert lin["last_swap"]["action"] == "swap"

    def test_health_regression_rolls_back_and_quarantines(self, registry, model_dir, tmp_path):
        g1 = _two_generations(registry, model_dir, tmp_path)
        swapper = _StubSwapper()
        w = self._watcher(registry, swapper, initial_generation=g1, policy=RollbackPolicy(
            window=8, min_requests=4, max_unhealthy_rate=0.5))
        w._check_registry()
        assert w._watching_swap
        for _ in range(6):
            w.observe_outcome(degraded=True)
        assert w._rollback_wanted
        assert w.rollback(reason="post-swap health regression")
        assert registry.latest().generation == 1
        assert w.lineage()["registry_generation"] == 1
        assert w.lineage()["last_swap"]["action"] == "rollback"
        assert swapper.swapped_dirs[-1] == registry.generation(1).model_dir
        w._check_registry()
        assert len(swapper.swapped_dirs) == 2

    def test_healthy_window_never_rolls_back(self, registry, model_dir, tmp_path):
        g1 = _two_generations(registry, model_dir, tmp_path)
        w = self._watcher(registry, _StubSwapper(), initial_generation=g1, policy=RollbackPolicy(
            window=8, min_requests=4, max_unhealthy_rate=0.5))
        w._check_registry()
        for _ in range(50):
            w.observe_outcome(degraded=False)
        assert not w._rollback_wanted
        assert registry.latest().generation == 2

    def test_rollback_without_parent_is_refused(self, registry, model_dir):
        g1 = registry.publish(model_dir)
        w = self._watcher(registry, _StubSwapper(), initial_generation=g1)
        assert w.rollback() is False
        assert registry.latest().generation == 1

    def test_failed_swap_keeps_the_live_generation(self, registry, model_dir, tmp_path):
        g1 = _two_generations(registry, model_dir, tmp_path)
        swapper = _StubSwapper()
        swapper.fail_next = True
        w = self._watcher(registry, swapper, initial_generation=g1)
        w._check_registry()
        assert w.lineage()["registry_generation"] == 1
        assert w.lineage()["last_swap"] == {
            "action": "swap", "registry_generation": 2, "ok": False, "error": "boom"}
        assert not w._watching_swap

    def test_poll_thread_promotes_then_rolls_back(self, registry, model_dir, tmp_path):
        """The thread path: a poke promotes, unhealthy outcomes wake the
        thread, which rolls back once and quarantines."""
        g1 = registry.publish(model_dir)
        swapper = _StubSwapper()
        w = self._watcher(registry, swapper, initial_generation=g1, policy=RollbackPolicy(
            window=4, min_requests=2, max_unhealthy_rate=0.5)).start()
        try:
            registry.publish(_write_model(str(tmp_path / "m2"), b"G2"), parent=1)
            w.poke()
            assert _wait(lambda: len(w.history) == 1)
            for _ in range(4):
                w.observe_outcome(failed=True)
            assert _wait(lambda: len(w.history) == 2)
        finally:
            w.stop()
        assert [r.action for r in w.history] == ["swap", "rollback"]
        assert os.path.isdir(os.path.join(registry.quarantine_dir, "g000002"))

    def test_watcher_burn_gate_replaces_raw_fraction(self):
        """As ``tests/test_fleet_obs.py``'s burn-gate case: raw 100%
        degraded traffic does NOT trigger while the gate is quiet, and
        does the moment it burns."""
        from photon_ml_tpu_torch.registry.watcher import HealthWindow

        gate_state = {"burning": False}
        w = RegistryWatcher.__new__(RegistryWatcher)
        w.policy = RollbackPolicy(window=8, min_requests=4, max_unhealthy_rate=0.5)
        w.burn_gate = lambda: gate_state["burning"]
        w._lock = threading.Lock()
        w._wake = threading.Event()
        w._window = HealthWindow(8)
        w._watching_swap = True
        w._rollback_wanted = False
        for _ in range(6):
            w.observe_outcome(degraded=True)
        assert not w._rollback_wanted
        gate_state["burning"] = True
        w.observe_outcome(degraded=True)
        assert w._rollback_wanted
        assert w._wake.is_set()

    def test_burn_gate_is_an_slo_engines_alert_state(self, registry, model_dir, tmp_path):
        """Wired as the serving driver wires it: ``SLOEngine
        .any_alert_active`` over a registry whose error counter burns."""
        from photon_ml_tpu_torch.obs.registry import MetricsRegistry
        from photon_ml_tpu_torch.obs.slo import SLOEngine, parse_slo_specs

        reg = MetricsRegistry()
        total, bad = reg.counter("req_total"), reg.counter("req_bad")
        engine = SLOEngine(reg, parse_slo_specs(
            '{"name": "a", "objective": 0.99, "metric": "req_total", "bad_metric": "req_bad",'
            ' "short_window_s": 1, "long_window_s": 2}'))
        g1 = _two_generations(registry, model_dir, tmp_path)
        w = self._watcher(registry, _StubSwapper(), initial_generation=g1,
                          burn_gate=engine.any_alert_active,
                          policy=RollbackPolicy(window=8, min_requests=2))
        w._check_registry()
        engine.tick(now=0.0)
        total.inc(100)
        engine.tick(now=0.5)
        for _ in range(4):
            w.observe_outcome(degraded=True)
        assert not w._rollback_wanted  # healthy burn: the raw fraction is ignored
        total.inc(100)
        bad.inc(100)
        engine.tick(now=1.0)
        assert engine.any_alert_active()
        w.observe_outcome()
        assert w._rollback_wanted


def _wait(cond, timeout=10.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class TestServingIntegration:
    """The watcher over the port's CPU ``ServingModel``: promotion under
    the front end, bitwise parent restore on rollback, status lineage
    and the rollback op."""

    @pytest.fixture()
    def game_stack(self, rng, tmp_path):
        from photon_ml_tpu_torch.game.data import build_game_dataset
        from photon_ml_tpu_torch.game.model_io import LoadedGameModel, save_loaded_game_model
        from torch_serving_cases import SHARDS, synth_records

        recs = synth_records(rng)
        ds = build_game_dataset(recs, SHARDS, ["userId"], device="cpu")

        def save(path, scale, n_users=5):
            lm = LoadedGameModel()
            lm.fixed_effects["global"] = (
                "g", {f"g{j}\t": float(rng.normal()) * scale for j in range(5)})
            lm.random_effects["per-user"] = ("userId", "u", {
                f"user{e}": {f"u{j}\t": float(rng.normal()) * scale for j in range(3)}
                for e in range(n_users)})
            return save_loaded_game_model(lm, path) or path

        return ds, save, str(tmp_path)

    def _load(self, ds, model_dir):
        from photon_ml_tpu_torch.serving import ServingModel

        imaps = {s: d.index_map for s, d in ds.shards.items()}
        widths = {s: d.indices.shape[1] for s, d in ds.shards.items()}
        # no entity padding: a new user changes the bank's shape
        return ServingModel.load(model_dir, imaps, widths, ladder=(1, 8), device="cpu",
                                 entity_pad_to=1)

    @pytest.mark.parametrize("g2_users", [5, 6], ids=["in-place", "new-shape"])
    def test_rollback_restores_parent_bank_bitwise(self, game_stack, g2_users):
        """Generation 2 keeps generation 1's spec (values copied in place)
        or adds a user (a new bank shape); either way the rollback reloads
        generation 1 from its artifact, bitwise its first load."""
        ds, save, base = game_stack
        registry = ModelRegistry(os.path.join(base, "registry"))
        g1 = registry.publish(save(os.path.join(base, "m1"), 1.0))
        registry.publish(save(os.path.join(base, "m2"), -2.0, n_users=g2_users), parent=1)
        sm = self._load(ds, g1.model_dir)
        g1_arrays = {k: v.clone() for k, v in sm.current().arrays.items()}
        w = RegistryWatcher(registry, sm, poll_s=30.0, initial_generation=g1,
                            policy=RollbackPolicy(window=8, min_requests=4, max_unhealthy_rate=0.5),
                            swap_kwargs={"entity_pad_to": 1})
        w._check_registry()
        assert sm.generation == 2
        g2_arrays = sm.current().arrays
        assert any(g2_arrays[k].shape != g1_arrays[k].shape for k in g1_arrays) == (g2_users == 6)
        for _ in range(6):
            w.observe_outcome(failed=True)
        assert w.rollback(reason="test regression")
        assert registry.latest().generation == 1
        restored = sm.current().arrays
        assert sorted(restored) == sorted(g1_arrays)
        for k, a in g1_arrays.items():
            assert restored[k].dtype == a.dtype and torch.equal(restored[k], a), k

    def test_frontend_status_lineage_and_rollback_op(self, game_stack):
        from photon_ml_tpu_torch.serving import MicroBatcher, ServingFrontend, ServingMetrics
        from torch_serving_cases import Client

        ds, save, base = game_stack
        registry = ModelRegistry(os.path.join(base, "registry"))
        g1 = registry.publish(save(os.path.join(base, "m1"), 1.0))
        registry.publish(save(os.path.join(base, "m2"), -2.0), parent=1)
        sm = self._load(ds, g1.model_dir)
        watcher = RegistryWatcher(registry, sm, poll_s=30.0, initial_generation=g1)
        metrics = ServingMetrics()
        batcher = MicroBatcher(sm.current, sm.programs, metrics)
        fe = ServingFrontend(batcher, sm, [], metrics=metrics, port=0,
                             lineage_provider=watcher.lineage,
                             rollback_handler=watcher.rollback).start()
        try:
            watcher._check_registry()
            c = Client(fe.port)
            status = c.ask({"op": "status"})
            assert status["registry"]["registry_generation"] == 2
            assert status["registry"]["parent"] == 1
            assert status["registry"]["lineage"] == [2, 1]
            assert status["last_swap"]["ok"] is True
            resp = c.ask({"op": "rollback"})
            assert resp["status"] == "ok" and resp["rolled_back"]
            status = c.ask({"op": "status"})
            assert status["registry"]["registry_generation"] == 1
            assert status["registry"]["last_swap"]["action"] == "rollback"
            assert registry.latest().generation == 1
            c.close()
        finally:
            fe.stop_accepting()
            batcher.drain(5.0)
            fe.close()
            batcher.close()
