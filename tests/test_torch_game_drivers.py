"""The port's GAME drivers (``cli/game_training_driver.py``,
``cli/game_scoring_driver.py``) against the JAX package's on one small
Avro fixture: the same best combo, validation metrics within 1e-5,
model files that cross-load, score files whose scores agree within 1e-6
(of their max-abs) with equal ids and metadata; and every option of a
later ROADMAP item refused with its item."""

import json
import os

import numpy as np
import pytest

from conftest import game_example_schema
from photon_ml_tpu.cli import game_scoring_driver as ref_scoring
from photon_ml_tpu.cli import game_training_driver as ref_training
from photon_ml_tpu.io.avro_codec import read_avro_records, write_container
from photon_ml_tpu_torch.cli import game_scoring_driver as port_scoring
from photon_ml_tpu_torch.cli import game_training_driver as port_training
from photon_ml_tpu_torch.game import load_game_model
from photon_ml_tpu_torch.registry import ModelRegistry
from torch_game_cases import make_records
from torch_parity import assert_close, assert_close_to_scale

SHARD_MAP = "globalShard:features|userShard:userFeatures"


def _avro(path, seed, n):
    recs = make_records(seed, n=n, n_users=8)
    for r in recs:
        r["metadataMap"] = {"userId": r.pop("userId")}
    write_container(path, game_example_schema(), recs)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("game_avro")
    for d in ("train", "val"):
        (root / d).mkdir()
    _avro(str(root / "train" / "p0.avro"), 20, 160)
    _avro(str(root / "train" / "p1.avro"), 21, 100)
    _avro(str(root / "val" / "p0.avro"), 22, 120)
    return root


def _train_argv(data, out, mode, extra=()):
    return [
        "--train-input-dirs", str(data / "train"),
        "--validate-input-dirs", str(data / "val"),
        "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations",
        "global:40,1e-7,10,1,LBFGS,L2;40,1e-7,0.1,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
        "--random-effect-optimization-configurations", "per-user:40,1e-7,1,1,LBFGS,L2",
        "--num-iterations", "2",
        "--evaluator-types", "AUC,LOGISTIC_LOSS",
        "--compute-variance", "true",
        "--model-output-mode", mode,
        *extra,
    ]


@pytest.fixture(scope="module")
def ref_run(data, tmp_path_factory):
    """The JAX driver, once (ALL writes every output a mode can write; the
    best combo and the metrics do not depend on the mode)."""
    out = tmp_path_factory.mktemp("ref_train") / "out"
    driver = ref_training.GameTrainingDriver(
        ref_training.params_from_args(_train_argv(data, out, "ALL"))
    )
    driver.run()
    return driver, out


def _tree(root, mode="ALL"):
    files = sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, fs in os.walk(root) for f in fs if not f.endswith(".log")
    )
    if mode == "BEST":
        files = [f for f in files if not f.startswith("all" + os.sep)]
    if mode == "NONE":
        files = [f for f in files if f == "metrics.json"]
    return files


@pytest.mark.parametrize("mode", ["ALL", "BEST", "NONE"])
def test_training_drivers_agree(data, tmp_path, ref_run, mode):
    ref, ref_out = ref_run
    port = port_training.main(_train_argv(data, tmp_path / "port", mode) + ["--device", "cpu"])
    assert port.best_config["global"].render() == ref.best_config["global"].render()
    ref_m = json.load(open(ref_out / "metrics.json"))
    port_m = json.load(open(tmp_path / "port" / "metrics.json"))
    assert port_m.keys() == ref_m.keys()
    assert_close(port_m["best_metric"], ref_m["best_metric"], rtol=1e-5)
    for r, p in zip(ref_m["validation_history"], port_m["validation_history"]):
        assert p.keys() == r.keys()
        for k in r:
            assert_close(p[k], r[k], rtol=1e-5)
    assert_close(port_m["objective_history"], ref_m["objective_history"], rtol=1e-5)
    assert port_m["objective_history"][-1] <= port_m["objective_history"][0]
    assert len(port.results) == len(ref.results) == 2
    assert _tree(tmp_path / "port") == _tree(ref_out, mode)
    if mode == "NONE":
        return
    # the model files cross-load: the same coordinates, the same
    # coefficients within the fits' agreement (intercepts: 5e-4, as in
    # test_torch_game_coordinate_descent)
    for d in (ref_out, tmp_path / "port"):
        loaded = load_game_model(str(d / "best-model"))
        assert loaded.coordinate_names() == ["global", "per-user"]
        assert set(loaded.random_effect_variances["per-user"]) == {f"user{u:03d}" for u in range(8)}
    a = load_game_model(str(ref_out / "best-model")).fixed_effects["global"][1]
    b = load_game_model(str(tmp_path / "port" / "best-model")).fixed_effects["global"][1]
    keys = sorted(a)
    assert sorted(b) == keys
    assert_close_to_scale(np.array([b[k] for k in keys]), np.array([a[k] for k in keys]), rtol=5e-4)


def _score_argv(data, model, out):
    return [
        "--input-data-dirs", str(data / "val"),
        "--game-model-input-dir", str(model),
        "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--evaluator-types", "AUC,AUC:userId",
        "--random-effect-id-set", "userId",
        "--game-model-id", "m-7",
        "--num-files", "2",
    ]


def test_scoring_drivers_agree(data, tmp_path, ref_run):
    """Both scoring drivers over one model directory (written by the JAX
    driver), and the port's over its own driver's model."""
    model = ref_run[1] / "best-model"
    port_train = port_training.main(
        _train_argv(data, tmp_path / "port", "BEST") + ["--device", "cpu"]
    )
    ref = ref_scoring.GameScoringDriver(
        ref_scoring.params_from_args(_score_argv(data, model, tmp_path / "ref-scores"))
    )
    ref.run()
    port = port_scoring.main(
        _score_argv(data, model, tmp_path / "port-scores") + ["--device", "cpu"]
    )
    for k in ref.metrics:
        assert_close(port.metrics[k], ref.metrics[k], rtol=1e-6)
    ref_recs = list(read_avro_records(str(tmp_path / "ref-scores" / "scores")))
    port_recs = list(read_avro_records(str(tmp_path / "port-scores" / "scores")))
    assert len(os.listdir(tmp_path / "port-scores" / "scores")) == 2
    assert len(port_recs) == len(ref_recs) == 120
    for key in ("uid", "label", "modelId", "weight", "metadataMap"):
        assert [r[key] for r in port_recs] == [r[key] for r in ref_recs], key
    assert_close_to_scale(
        [r["predictionScore"] for r in port_recs],
        [r["predictionScore"] for r in ref_recs], rtol=1e-6,
    )
    # the port's scores of its own model: the training driver's AUC
    own = port_scoring.main(
        _score_argv(data, tmp_path / "port" / "best-model", tmp_path / "own-scores")
        + ["--device", "cpu"]
    )
    assert_close(own.metrics["AUC"], port_train.best_result[1], rtol=1e-6)


def test_pure_fixed_effect_grid_runs_batched(data, tmp_path):
    """One FE, no RE, one iteration: the λ grid solves as one bank in both
    drivers and picks the same combo."""
    argv = [a for a in _train_argv(data, tmp_path / "x", "BEST")]
    drop = {"--random-effect-data-configurations", "--random-effect-optimization-configurations"}
    keep, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in drop:
            skip = True
            continue
        keep.append(a)
    keep[keep.index("--num-iterations") + 1] = "1"
    ref = ref_training.GameTrainingDriver(ref_training.params_from_args(
        [a if a != str(tmp_path / "x") else str(tmp_path / "ref") for a in keep]))
    ref.run()
    port = port_training.main(
        [a if a != str(tmp_path / "x") else str(tmp_path / "port") for a in keep]
        + ["--device", "cpu"]
    )
    assert "train-fe-grid-batched" in port.timer.durations
    assert port.best_config["global"].render() == ref.best_config["global"].render()
    assert_close(port.best_result[1], ref.best_result[1], rtol=1e-5)


REFUSED = [
    (["--factored-random-effect-optimization-configurations", "per-user:4,2"], None),
    (["--distributed", "feature"], None),
    (["--model-shards", "2"], None),
    (["--entity-shards", "1"], None),
    (["--coordinator-address", "localhost:1234"], "--num-processes"),
    (["--num-processes", "2"], None),
    (["--process-id", "0"], None),
    (["--checkpoint-dir", "ck"], None),
    (["--fault-plan", "spill_write:2:EIO"], None),
    (["--streaming", "true"], "IDENTITY projector"),
    (["--stream-memory-budget", "1000"], "requires --streaming true"),
    (["--retrain-from", "reg"], None),
    (["--publish-registry", "reg"], None),
    (["--gate-max-auc-drop", "0.1"], None),
    (["--retrain-from", "reg", "--publish-registry", "reg", "--validate-input-dirs", ""],
     "requires validate-input-dirs"),
    (["--obs-dir", "obs"], None),
    (["--profile-dir", "prof"], None),
]


@pytest.mark.parametrize("extra,item", REFUSED, ids=[r[0][0] for r in REFUSED])
def test_training_refuses_later_items(data, tmp_path, extra, item):
    """An option of a later item is refused before touching the output; an
    option whose item is ported (None) runs; one whose item is ported but
    that this configuration or another option rules out raises the
    reference's ValueError (streaming takes IDENTITY projectors only; a
    memory budget needs --streaming true; gated promotion needs validation
    data), also before the output. The registry options run: a retrain
    from an empty registry is a cold start, a publish makes generation 1,
    a gate threshold alone gates nothing."""
    extra = [str(tmp_path / a) if a in ("ck", "obs", "prof", "reg") else a for a in extra]
    if item is None:
        from photon_ml_tpu_torch.reliability import install_plan

        try:
            port_training.main(_train_argv(data, tmp_path / "o", "BEST", extra) + ["--device", "cpu"])
        finally:
            install_plan(None)
        metrics = json.load(open(tmp_path / "o" / "metrics.json"))
        assert len(metrics["objective_history"]) == 2
        if extra[0] == "--checkpoint-dir":
            combos = sorted(os.listdir(tmp_path / "ck"))
            assert len(combos) == 2  # one directory per combo of the grid
            assert all(sorted(os.listdir(tmp_path / "ck" / c))[:2] == ["1", "2"] for c in combos)
        elif extra[0] == "--fault-plan":
            assert metrics["reliability"]["faults"]["plan"] == extra[1]
        elif extra[0] == "--obs-dir":
            assert metrics["obs"]["trace_events"] > 0
            assert os.path.exists(metrics["obs"]["flight_path"])
        elif extra[0] == "--profile-dir":
            assert [n for n in os.listdir(extra[1]) if n.endswith(".pt.trace.json")]
        elif extra[0] == "--retrain-from":
            assert metrics["registry"]["parent_generation"] is None
            assert metrics["registry"]["published_generation"] is None
        elif extra[0] == "--publish-registry":
            assert metrics["registry"]["published_generation"] == 1
            assert [g.generation for g in ModelRegistry(extra[1]).list_generations()] == [1]
        elif extra[0] == "--gate-max-auc-drop":
            assert "registry" not in metrics
        return
    error = NotImplementedError if item.startswith("item ") else ValueError
    with pytest.raises(error, match=item):
        port_training.main(_train_argv(data, tmp_path / "o", "BEST", extra) + ["--device", "cpu"])
    assert not (tmp_path / "o").exists()  # refused before touching the output


SCORING_REFUSED = [
    (["--streaming", "true"], "requires prebuilt feature maps"),
    (["--fault-plan", "chunk_read:1:EIO"], None),
    (["--obs-dir", "obs"], None),
    (["--profile-dir", "prof"], None),
]


@pytest.mark.parametrize("extra,item", SCORING_REFUSED, ids=[r[0][0] for r in SCORING_REFUSED])
def test_scoring_refuses_later_items(data, tmp_path, ref_run, extra, item):
    """A later item's option is refused; ``--fault-plan`` (ported) runs and
    shows in the reliability block of metrics.json, ``--obs-dir`` writes
    the trace, flight and snapshot files and ``--profile-dir`` a profiler
    trace; ``--streaming true`` without prebuilt feature maps raises the
    reference's ValueError."""
    if item is None:
        from photon_ml_tpu_torch.reliability import install_plan

        extra = [str(tmp_path / a) if a in ("obs", "prof") else a for a in extra]
        try:
            port_scoring.main(
                _score_argv(data, ref_run[1] / "best-model", tmp_path / "o") + extra
                + ["--device", "cpu"]
            )
        finally:
            install_plan(None)
        if extra[0] == "--obs-dir":
            assert sorted(os.listdir(extra[1])) == [
                "flight.json", "metrics_snapshot.json", "trace.json"
            ]
        elif extra[0] == "--profile-dir":
            assert [n for n in os.listdir(extra[1]) if n.endswith(".pt.trace.json")]
        else:
            metrics = json.load(open(tmp_path / "o" / "metrics.json"))
            assert metrics["reliability"]["faults"]["plan"] == extra[1]
        return
    error = NotImplementedError if item.startswith("item ") else ValueError
    with pytest.raises(error, match=item):
        port_scoring.main(_score_argv(data, tmp_path, tmp_path / "o") + extra + ["--device", "cpu"])
