"""The port's retrain loop through its drivers on the CPU, held to
``tests/test_retrain_drivers.py`` and to the JAX package's drivers.

- GLM: train -> publish generation 1 -> append one partition -> retrain
  warm-started from generation 1, scanning only the new partition ->
  gates vs the parent -> generation 2 with lineage [2, 1]; a label-flipped
  flood is refused with ``AUC_REGRESSION``; the validation rules.
- GAME: the same loop with a new user (entity churn, prior-mean init).
- Both packages' drivers through the same loop: the same generations,
  lineage, gate verdicts and drift reports; the published coefficients'
  float64 objectives within 1e-6 relative (the tolerance of
  ``tests/test_torch_driver_tolerance.py``).
- The serving driver's ``--registry-dir`` mode: it serves the latest
  generation, its watcher promotes a newly published one under traffic,
  and after ``quarantine_re`` degrades responses it rolls back on its own
  (every score bitwise the port's batch score of the generation it names),
  with ``watcher_history`` in ``metrics.json``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.registry import ModelRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _logistic_rows(rng, w, n, k, uid_prefix):
    d = len(w)
    recs = []
    for i in range(n):
        ix = rng.integers(0, d, size=k)
        vs = rng.normal(size=k)
        z = float((w[ix] * vs).sum())
        recs.append({
            "uid": f"{uid_prefix}-{i}",
            "label": float(1 / (1 + np.exp(-z)) > rng.uniform()),
            "features": [
                {"name": f"f{int(j)}", "term": "", "value": float(v)} for j, v in zip(ix, vs)
            ],
            "offset": 0.0,
            "weight": 1.0,
        })
    return recs


def _write_glm_dir(path, recs):
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    os.makedirs(path, exist_ok=True)
    write_container(
        os.path.join(path, f"part-{len(os.listdir(path)):03d}.avro"),
        schemas.TRAINING_EXAMPLE_AVRO, recs,
    )


@pytest.fixture()
def glm_world(tmp_path, rng):
    d, k = 24, 5
    w = rng.normal(size=d) * 0.8
    train, val = str(tmp_path / "train"), str(tmp_path / "val")
    for fi in range(3):
        _write_glm_dir(train, _logistic_rows(rng, w, 150, k, f"t{fi}"))
    _write_glm_dir(val, _logistic_rows(rng, w, 400, k, "v"))
    return tmp_path, train, val, w, k


def _glm_argv(train, val, out, extra=()):
    return [
        "--training-data-directory", train,
        "--output-directory", out,
        "--validating-data-directory", val,
        "--regularization-weights", "1.0",
        "--num-iterations", "15",
        "--streaming", "true",
        "--delete-output-dirs-if-exist", "true",
        *extra,
    ]


def _glm_run(tmp_path, train, val, out_name, extra=()):
    from photon_ml_tpu_torch.cli.glm_driver import GLMDriver, params_from_args

    out = str(tmp_path / out_name)
    driver = GLMDriver(params_from_args(_glm_argv(train, val, out, extra) + ["--device", "cpu"]))
    driver.run()
    with open(os.path.join(out, "metrics.json")) as f:
        return driver, json.load(f)


def _ref_glm_run(tmp_path, train, val, out_name, extra=()):
    from photon_ml_tpu.cli.glm_driver import GLMDriver, params_from_args

    out = str(tmp_path / out_name)
    driver = GLMDriver(params_from_args(_glm_argv(train, val, out, extra)))
    driver.run()
    with open(os.path.join(out, "metrics.json")) as f:
        return driver, json.load(f)


class TestGLMRetrainLoop:
    def test_publish_retrain_publish_with_lineage_and_scan_cache(self, glm_world, rng):
        tmp_path, train, val, w, k = glm_world
        reg_dir, cache = str(tmp_path / "registry"), str(tmp_path / "scan-cache")
        retrain_args = [
            "--retrain-from", reg_dir, "--publish-registry", reg_dir,
            "--scan-cache-dir", cache, "--gate-max-auc-drop", "0.5",
        ]
        _d1, m1 = _glm_run(tmp_path, train, val, "out1", retrain_args)
        assert m1["registry"]["published_generation"] == 1
        assert m1["registry"]["parent_generation"] is None
        assert m1["scan_cache"]["scanned"] == 3
        assert "publish-registry" in m1["timers"]
        reg = ModelRegistry(reg_dir)
        assert reg.latest().generation == 1
        _write_glm_dir(train, _logistic_rows(rng, w, 100, k, "new"))
        d2, m2 = _glm_run(tmp_path, train, val, "out2", retrain_args)
        r = m2["registry"]
        assert (r["parent_generation"], r["published_generation"]) == (1, 2)
        assert r["gates"]["verdict"] == "PASS"
        assert r["drift"]["dropped"] == 0 and r["drift"]["no_drift"]
        assert (m2["scan_cache"]["partitions"], m2["scan_cache"]["scanned"],
                m2["scan_cache"]["cached"]) == (4, 1, 3)
        info = reg.latest()
        assert info.generation == 2 and info.parent == 1
        assert info.manifest["gates"]["verdict"] == "PASS"
        assert reg.lineage() == [2, 1]
        # the no-drift warm start is bitwise generation 1's coefficients
        from photon_ml_tpu_torch.cli.glm_driver import _glm_artifact_means
        from photon_ml_tpu_torch.registry import align_coefficients

        parent = _glm_artifact_means(reg.generation(1).model_dir)
        initial = d2._retrain_initial()
        assert np.array_equal(initial, align_coefficients(parent, d2._data.index_map))
        assert sorted(os.listdir(info.model_dir)) == ["feature-index", "model.avro"]

    def test_poisoned_retrain_is_refused_with_named_verdict(self, glm_world, rng):
        tmp_path, train, val, w, k = glm_world
        reg_dir = str(tmp_path / "registry")
        base = ["--retrain-from", reg_dir, "--publish-registry", reg_dir,
                "--gate-max-auc-drop", "0.5"]
        _glm_run(tmp_path, train, val, "out1", base)
        _write_glm_dir(train, _logistic_rows(rng, -w, 1200, k, "poison"))
        _d, m = _glm_run(tmp_path, train, val, "out2", [
            "--retrain-from", reg_dir, "--publish-registry", reg_dir,
            "--gate-max-auc-drop", "0.02",
        ])
        r = m["registry"]
        assert r["published_generation"] is None
        assert r["gates"]["verdict"] == "AUC_REGRESSION"
        reg = ModelRegistry(reg_dir)
        assert [g.generation for g in reg.list_generations()] == [1]
        refusals = reg.refused_candidates()
        assert len(refusals) == 1
        assert refusals[0]["gates"]["verdict"] == "AUC_REGRESSION"

    def test_in_memory_retrain_gates_and_publishes(self, glm_world):
        """Without --streaming the gates score the loaded validation batch
        (one fetch for both margins) and the warm start seeds the grid."""
        tmp_path, train, val, _w, _k = glm_world
        reg_dir = str(tmp_path / "registry")
        extra = ["--streaming", "false", "--retrain-from", reg_dir,
                 "--publish-registry", reg_dir, "--gate-max-auc-drop", "0.5"]
        _glm_run(tmp_path, train, val, "out1", extra)
        _d, m = _glm_run(tmp_path, train, val, "out2", extra)
        r = m["registry"]
        assert (r["parent_generation"], r["published_generation"]) == (1, 2)
        assert r["gates"]["verdict"] == "PASS"
        assert r["gates"]["checks"]["coef_norm"]["passed"]

    def test_validation_rules(self):
        from photon_ml_tpu.cli.glm_driver import GLMParams as RefParams
        from photon_ml_tpu_torch.cli.glm_driver import GLMParams

        for cls in (GLMParams, RefParams):
            with pytest.raises(ValueError, match="requires a validating"):
                cls(train_dir="t", output_dir="o", retrain_from="r",
                    publish_registry="r").validate()
            with pytest.raises(ValueError, match="streaming"):
                cls(train_dir="t", output_dir="o", scan_cache_dir="c").validate()
            with pytest.raises(ValueError, match="gate-max-coef-norm-ratio"):
                cls(train_dir="t", output_dir="o", gate_max_coef_norm_ratio=0.0).validate()

    def test_both_packages_run_the_same_loop(self, glm_world, rng):
        """Each package's driver runs publish -> append -> retrain ->
        poison on its own registry over the same files: the same
        generations, lineage, verdicts and drift reports; each published
        model's float64 objective on the training rows within 1e-6 of the
        other's."""
        tmp_path, train, val, w, k = glm_world
        runs = {"port": _glm_run, "jax": _ref_glm_run}
        regs = {pkg: str(tmp_path / f"reg-{pkg}") for pkg in runs}

        def step(tag, gate="0.5"):
            out = {}
            for pkg, run in runs.items():
                _d, m = run(tmp_path, train, val, f"{pkg}-{tag}", [
                    "--retrain-from", regs[pkg], "--publish-registry", regs[pkg],
                    "--gate-max-auc-drop", gate])
                out[pkg] = m["registry"]
            return out

        first = step("g1")
        _write_glm_dir(train, _logistic_rows(rng, w, 100, k, "new"))
        second = step("g2")
        _write_glm_dir(train, _logistic_rows(rng, -w, 1200, k, "poison"))
        third = step("g3", gate="0.02")
        for got in (first, second, third):
            a, b = got["port"], got["jax"]
            assert (a["parent_generation"], a["published_generation"]) == (
                b["parent_generation"], b["published_generation"])
            assert a["drift"] == b["drift"]
            assert (a["gates"] or {}).get("verdict") == (b["gates"] or {}).get("verdict")
            if a["gates"]:
                assert sorted(a["gates"]["checks"]) == sorted(b["gates"]["checks"])
        assert third["port"]["gates"]["verdict"] == "AUC_REGRESSION"
        port_reg, ref_reg = ModelRegistry(regs["port"]), ModelRegistry(regs["jax"])
        assert port_reg.lineage() == ref_reg.lineage() == [2, 1]
        assert len(port_reg.refused_candidates()) == len(ref_reg.refused_candidates()) == 1
        # generation 2's coefficients: the same optimum in float64
        from photon_ml_tpu_torch.cli.glm_driver import _glm_artifact_means
        from photon_ml_tpu_torch.io.input_format import create_input_format

        data = create_input_format("AVRO").load(
            [os.path.join(train, p) for p in sorted(os.listdir(train))[:4]], device="cpu")
        batch, imap = data.batch, data.index_map

        def objective64(means):
            v = np.zeros(imap.size)
            for key, x in means.items():
                v[imap.get_index(key)] = x
            wt = torch.as_tensor(v, dtype=torch.float64)
            z = (batch.values.double() * wt[batch.indices.long()]).sum(1)
            y, s = batch.labels.double(), batch.weights.double()
            return float((s * (torch.nn.functional.softplus(z) - y * z)).sum() + 0.5 * (wt @ wt))

        got = objective64(_glm_artifact_means(port_reg.generation(2).model_dir))
        want = objective64(_glm_artifact_means(ref_reg.generation(2).model_dir))
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def _game_rows(rng, w_g, w_u, n, uid_prefix):
    n_users, d_u = w_u.shape
    recs = []
    for i in range(n):
        u = int(rng.integers(0, n_users))
        xg, xu = rng.normal(size=len(w_g)), rng.normal(size=d_u)
        z = float(xg @ w_g + xu @ w_u[u])
        recs.append({
            "uid": f"{uid_prefix}-{i}",
            "response": float(1 / (1 + np.exp(-z)) > rng.uniform()),
            "metadataMap": {"userId": f"user{u}"},
            "features": [{"name": f"g{j}", "term": "", "value": float(xg[j])}
                         for j in range(len(w_g))],
            "userFeatures": [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                             for j in range(d_u)],
        })
    return recs


def _write_game_dir(path, recs):
    from conftest import game_example_schema
    from photon_ml_tpu_torch.io.avro_codec import write_container

    os.makedirs(path, exist_ok=True)
    write_container(os.path.join(path, f"part-{len(os.listdir(path))}.avro"),
                    game_example_schema(), recs)


def _game_argv(train, val, out, extra=()):
    return [
        "--train-input-dirs", train,
        "--output-dir", out,
        "--validate-input-dirs", val,
        "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map",
        "globalShard:features|userShard:userFeatures",
        "--fixed-effect-data-configurations", "global:globalShard,1",
        # L-BFGS and one sweep (the reference's test: TRON, two sweeps)
        # halve the JAX driver's compile time; the loop is the same
        "--fixed-effect-optimization-configurations", "global:20,1e-6,0.5,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,identity",
        "--random-effect-optimization-configurations", "per-user:20,1e-6,1.0,1,LBFGS,L2",
        "--num-iterations", "1",
        "--model-output-mode", "BEST",
        "--delete-output-dir-if-exists", "true",
        *extra,
    ]


def _game_run(tmp_path, train, val, out_name, extra=(), pkg="port"):
    if pkg == "port":
        from photon_ml_tpu_torch.cli.game_training_driver import (
            GameTrainingDriver,
            params_from_args,
        )

        extra = list(extra) + ["--device", "cpu"]
    else:
        from photon_ml_tpu.cli.game_training_driver import GameTrainingDriver, params_from_args
    out = str(tmp_path / out_name)
    driver = GameTrainingDriver(params_from_args(_game_argv(train, val, out, extra)))
    driver.run()
    with open(os.path.join(out, "metrics.json")) as f:
        return driver, json.load(f)


class TestGameRetrainLoop:
    @pytest.fixture()
    def game_world(self, tmp_path, rng):
        n_users, d_g, d_u = 6, 5, 3
        w_g = np.linspace(-1, 1, d_g)
        w_u = rng.normal(size=(n_users, d_u))
        train, val = str(tmp_path / "train"), str(tmp_path / "val")
        _write_game_dir(train, _game_rows(rng, w_g, w_u, 250, "t"))
        _write_game_dir(val, _game_rows(rng, w_g, w_u, 250, "v"))
        return tmp_path, train, val, w_g, w_u

    def test_warm_start_lineage_and_entity_drift_in_both_packages(self, game_world, rng):
        """The reference's GAME loop through the port's driver; then the
        retrain step also through the JAX package's driver, from a copy
        of the registry the port published (the format is shared): the
        same generations, lineage, verdicts and drift reports."""
        import shutil

        tmp_path, train, val, w_g, w_u = game_world
        regs = {pkg: str(tmp_path / f"reg-{pkg}") for pkg in ("port", "jax")}
        retrain = ["--gate-max-auc-drop", "0.5"]
        _d, m1 = _game_run(tmp_path, train, val, "port-g1", [
            "--retrain-from", regs["port"], "--publish-registry", regs["port"], *retrain])
        assert m1["registry"]["published_generation"] == 1
        assert ModelRegistry(regs["port"]).latest().generation == 1
        shutil.copytree(regs["port"], regs["jax"])
        # append data holding a NEW user (entity churn)
        w_u2 = np.concatenate([w_u, rng.normal(size=(1, w_u.shape[1]))])
        _write_game_dir(train, _game_rows(rng, w_g, w_u2, 120, "new"))
        second = {pkg: _game_run(tmp_path, train, val, f"{pkg}-g2", [
            "--retrain-from", reg, "--publish-registry", reg, *retrain,
        ], pkg=pkg)[1]["registry"] for pkg, reg in regs.items()}
        r = second["port"]
        assert (r["parent_generation"], r["published_generation"]) == (1, 2)
        assert r["gates"]["verdict"] == "PASS"
        drift = r["drift"]
        assert set(drift) == {"global", "per-user"}
        assert drift["global"]["kept"] == len(w_g) + 1  # + intercept
        assert drift["per-user"]["kept_entities"] == len(w_u)
        assert drift["per-user"]["churned_entities_prior_init"] == 1
        a, b = second["port"], second["jax"]
        assert (a["parent_generation"], a["published_generation"]) == (
            b["parent_generation"], b["published_generation"])
        assert a["drift"] == b["drift"]
        assert a["gates"]["verdict"] == b["gates"]["verdict"]
        assert sorted(a["gates"]["checks"]) == sorted(b["gates"]["checks"])
        for reg in regs.values():
            info = ModelRegistry(reg).latest()
            assert info.generation == 2 and info.parent == 1
            assert ModelRegistry(reg).lineage() == [2, 1]

    def test_retrain_validation_rules(self):
        from photon_ml_tpu_torch.cli.game_training_driver import GameTrainingParams
        from photon_ml_tpu_torch.game.config import (
            FixedEffectDataConfiguration,
            ProjectorType,
            RandomEffectDataConfiguration,
        )

        base = dict(
            train_input_dirs=["t"], output_dir="o",
            fixed_effect_data_configs={"global": FixedEffectDataConfiguration("globalShard")},
            fixed_effect_opt_configs={"global": "x"},
        )
        with pytest.raises(ValueError, match="streaming"):
            GameTrainingParams(**base, retrain_from="r", streaming=True).validate()
        with pytest.raises(ValueError, match="validate-input-dirs"):
            GameTrainingParams(**base, retrain_from="r", publish_registry="r").validate()
        with pytest.raises(ValueError, match="model-output-mode NONE"):
            GameTrainingParams(**base, publish_registry="r", model_output_mode="NONE").validate()
        # an IDENTITY RE streams, so the streaming refusal is the retrain's
        re = dict(
            random_effect_data_configs={"u": RandomEffectDataConfiguration(
                "userId", "userShard", projector_type=ProjectorType.IDENTITY)},
            random_effect_opt_configs={"u": "x"},
        )
        with pytest.raises(ValueError, match="--retrain-from does not support"):
            GameTrainingParams(**base, **re, retrain_from="r", streaming=True).validate()


# -- the serving driver following a registry ------------------------------------


def _serving_world(tmp_path, rng):
    """Two generations of a GAME model over the same vocabulary (saved
    artifacts, not trained), name-term lists and requests."""
    from photon_ml_tpu_torch.game.model_io import save_loaded_game_model
    from photon_ml_tpu_torch.io.name_term_list import save_name_and_term_feature_sets
    from torch_serving_cases import synth_model, synth_records

    recs = synth_records(rng, n=64)
    models = []
    for g, scale in ((1, 1.0), (2, -0.5)):
        lm = synth_model(rng, scale=scale, drop_user=False)
        save_loaded_game_model(lm, str(tmp_path / f"m{g}"))
        models.append(lm)
    nt = str(tmp_path / "name-terms")
    save_name_and_term_feature_sets({
        "features": {f"g{j}\t" for j in range(5)},
        "userFeatures": {f"u{j}\t" for j in range(3)},
    }, nt)
    return recs, models, nt


def _batch_scores(recs, lm, nt):
    """The port's batch score of every record under ``lm`` (raw scores +
    offsets) over the serving driver's vocabulary, by uid."""
    from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
    from photon_ml_tpu_torch.game.data import build_game_dataset
    from photon_ml_tpu_torch.io.name_term_list import index_maps_from_name_term_lists
    from torch_serving_cases import batch_reference_scores

    shards = [FeatureShardConfiguration("g", ["features"]),
              FeatureShardConfiguration("u", ["userFeatures"])]
    ds = build_game_dataset(recs, shards, ["userId"], device="cpu",
                            index_maps=index_maps_from_name_term_lists(nt, shards))
    return dict(zip(ds.uids, batch_reference_scores(lm, ds).tolist()))


def test_serving_driver_follows_the_registry_and_rolls_back(tmp_path, rng):
    from photon_ml_tpu_torch.reliability import atomic_write_json  # noqa: F401
    from torch_serving_cases import Client, wait_until

    recs, models, nt = _serving_world(tmp_path, rng)
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish(str(tmp_path / "m1"))
    out = tmp_path / "serve"
    proc = subprocess.Popen([
        sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
        "--registry-dir", reg.root, "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", "g:features|u:userFeatures",
        "--feature-name-and-term-set-path", nt, "--request-nnz-width", "g:6|u:4",
        "--frontend-port", "0", "--registry-poll-s", "0.1", "--rollback-window", "8",
        "--rollback-min-requests", "4", "--rollback-max-unhealthy", "0.5",
        "--ladder", "1,8", "--device", "cpu",
    ], cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        assert wait_until(lambda: (out / "frontend.json").exists(), timeout=120), (
            proc.poll(), proc.stderr.read() if proc.poll() is not None else "")
        meta = json.loads((out / "frontend.json").read_text())
        assert meta["registry"] == reg.root
        c = Client(meta["port"], timeout=30)
        responses = [c.ask(r) for r in recs[:8]]
        reg.publish(str(tmp_path / "m2"), parent=1)
        assert wait_until(
            lambda: c.ask({"op": "status"})["registry"]["registry_generation"] == 2, timeout=30)
        responses += [c.ask(r) for r in recs[8:16]]
        assert c.ask({"op": "quarantine_re", "re_type": "userId"})["status"] == "ok"
        # degraded responses fill the post-swap window; the watcher rolls
        # back on its own once min-requests of them are in
        # (past half of the 8-wide window, which holds the 8 healthy
        # generation-2 responses above)
        degraded = []
        for r in recs[16:32]:
            degraded.append(c.ask(r))
            if c.ask({"op": "status"})["registry"]["last_swap"]["action"] == "rollback":
                break
        assert wait_until(
            lambda: c.ask({"op": "status"})["registry"]["last_swap"]["action"] == "rollback",
            timeout=30)
        assert len(degraded) >= 5
        assert all(r["degraded"] and r["generation"] == 2 for r in degraded[:5]), degraded
        responses += [r for r in degraded if not r["degraded"]]
        responses += [c.ask(r) for r in recs[32:]]
        c.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0
    m = json.loads((out / "metrics.json").read_text())
    assert [h["action"] for h in m["registry"]["watcher_history"]] == ["swap", "rollback"]
    assert m["registry"]["registry_generation"] == 1
    assert m["leaked_connections"] == 0
    assert os.path.isdir(os.path.join(reg.quarantine_dir, "g000002"))
    # bank generations 1, 2, 3 hold registry generations 1, 2, 1
    batch = {1: _batch_scores(recs, models[0], nt), 2: _batch_scores(recs, models[1], nt)}
    by_bank = {1: 1, 2: 2, 3: 1}
    seen = set()
    for r in responses:
        assert r["status"] == "ok" and not r["degraded"], r
        assert np.float32(r["score"]) == np.float32(batch[by_bank[r["generation"]]][r["uid"]]), r
        seen.add(r["generation"])
    assert seen == {1, 2, 3}
