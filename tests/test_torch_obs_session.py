"""``--obs-dir`` and ``--profile-dir`` in the port's four drivers on the
CPU: the GLM driver, both GAME drivers and the serving driver write the
files the JAX package's drivers write for the same options
(``trace.json``, ``flight.json``, ``metrics_snapshot.json``), with the
same keys and the same span names; ``--profile-dir`` leaves a
``torch.profiler`` Chrome trace; ``ObsSession`` itself wires the same
views and summary as the reference's."""

import json
import os

import pytest

from conftest import game_example_schema
from photon_ml_tpu_torch.io.avro_codec import write_container
from torch_game_cases import make_records

SHARD_MAP = "globalShard:features|userShard:userFeatures"


@pytest.fixture(scope="module")
def game_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_avro")
    (root / "train").mkdir()
    recs = make_records(40, n=120, n_users=6)
    for r in recs:
        r["metadataMap"] = {"userId": r.pop("userId")}
    write_container(str(root / "train" / "p0.avro"), game_example_schema(), recs)
    return root


def _shape(obs_dir):
    """What an obs dir holds, down to the keys: file names, the trace's
    span names, the flight dump's and the snapshot's keys."""
    files = sorted(os.listdir(obs_dir))
    trace = json.load(open(os.path.join(obs_dir, "trace.json")))
    flight = json.load(open(os.path.join(obs_dir, "flight.json")))
    snap = json.load(open(os.path.join(obs_dir, "metrics_snapshot.json")))
    return {
        "files": files,
        "trace_keys": sorted(trace),
        "span_names": sorted({e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}),
        "flight_keys": sorted(flight),
        "conservation_keys": sorted(flight["conservation"]),
        "snapshot_keys": sorted(snap),
    }


def _profile_events(profile_dir):
    names = [n for n in os.listdir(profile_dir) if n.endswith(".pt.trace.json")]
    assert len(names) == 1, names
    return json.load(open(os.path.join(profile_dir, names[0])))["traceEvents"]


def _reset_obs():
    """Drivers share the process's tracer and flight recorder: a clean
    slate and tracing off between runs."""
    import photon_ml_tpu.obs as ref_obs
    import photon_ml_tpu_torch.obs as obs

    for pkg in (obs, ref_obs):
        pkg.set_tracing(False)
        pkg.reset_tracer()
        pkg.reset_flight_recorder()


@pytest.fixture(autouse=True)
def clean_obs():
    _reset_obs()
    yield
    _reset_obs()


def test_obs_session_matches_the_reference(tmp_path):
    from photon_ml_tpu.obs import ObsSession as RefObsSession
    from photon_ml_tpu_torch.obs import ObsSession

    summaries = {}
    for name, cls in (("port", ObsSession), ("ref", RefObsSession)):
        s = cls(str(tmp_path / name), snapshot_period_s=0.05, signal_dump=False)
        s.register_view("extra", lambda: {"a": 1})
        s.record("swap.commit", generation=2)
        summaries[name] = s.finish()
        assert s.finish() is None  # idempotent
    assert sorted(summaries["port"]) == sorted(summaries["ref"])
    assert summaries["port"]["conservation"] == summaries["ref"]["conservation"]
    assert _shape(tmp_path / "port") == _shape(tmp_path / "ref")
    assert ObsSession(None).finish() is None


def test_glm_driver(tmp_path):
    import numpy as np

    from photon_ml_tpu.cli import glm_driver as ref_glm
    from photon_ml_tpu_torch.cli import glm_driver

    rng = np.random.default_rng(3)
    (tmp_path / "train").mkdir()
    with open(tmp_path / "train" / "part-0.txt", "w") as f:
        for _ in range(80):
            ix = sorted(rng.choice(20, size=4, replace=False) + 1)
            feats = " ".join(f"{i}:{rng.normal():.4f}" for i in ix)
            f.write(f"{int(rng.uniform() < 0.5)} {feats}\n")
    argv = ["--training-data-directory", str(tmp_path / "train"),
            "--input-file-format", "LIBSVM",
            "--regularization-weights", "10,1", "--grid-mode", "sequential"]
    glm_driver.main(argv + ["--output-directory", str(tmp_path / "port"),
                            "--obs-dir", str(tmp_path / "port-obs"),
                            "--profile-dir", str(tmp_path / "port-prof"), "--device", "cpu"])
    _reset_obs()
    ref_glm.main(argv + ["--output-directory", str(tmp_path / "ref"),
                         "--obs-dir", str(tmp_path / "ref-obs")])
    port, ref = _shape(tmp_path / "port-obs"), _shape(tmp_path / "ref-obs")
    assert port == ref
    assert "glm.lambda_solve" in port["span_names"]
    assert _profile_events(tmp_path / "port-prof")


def test_game_drivers(tmp_path, game_data):
    from photon_ml_tpu.cli import game_scoring_driver as ref_scoring
    from photon_ml_tpu.cli import game_training_driver as ref_training
    from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver

    train = [
        "--train-input-dirs", str(game_data / "train"),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:10,1e-6,1,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
        "--random-effect-optimization-configurations", "per-user:10,1e-6,1,1,LBFGS,L2",
        "--num-iterations", "1",
    ]
    game_training_driver.main(train + ["--output-dir", str(tmp_path / "port-train"),
                                       "--obs-dir", str(tmp_path / "port-train-obs"),
                                       "--profile-dir", str(tmp_path / "port-train-prof"),
                                       "--device", "cpu"])
    _reset_obs()
    ref_training.main(train + ["--output-dir", str(tmp_path / "ref-train"),
                               "--obs-dir", str(tmp_path / "ref-train-obs")])
    port, ref = _shape(tmp_path / "port-train-obs"), _shape(tmp_path / "ref-train-obs")
    assert port == ref
    assert {"cd.iteration", "cd.update"} <= set(port["span_names"])
    port_m = json.load(open(tmp_path / "port-train" / "metrics.json"))
    ref_m = json.load(open(tmp_path / "ref-train" / "metrics.json"))
    assert sorted(port_m["obs"]) == sorted(ref_m["obs"])
    assert _profile_events(tmp_path / "port-train-prof")
    _reset_obs()
    score = [
        "--input-data-dirs", str(game_data / "train"),
        "--game-model-input-dir", str(tmp_path / "port-train" / "best-model"),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--evaluator-types", "AUC",
    ]
    game_scoring_driver.main(score + ["--output-dir", str(tmp_path / "port-score"),
                                      "--obs-dir", str(tmp_path / "port-score-obs"),
                                      "--profile-dir", str(tmp_path / "port-score-prof"),
                                      "--device", "cpu"])
    _reset_obs()
    ref_scoring.main(score + ["--output-dir", str(tmp_path / "ref-score"),
                              "--obs-dir", str(tmp_path / "ref-score-obs")])
    assert _shape(tmp_path / "port-score-obs") == _shape(tmp_path / "ref-score-obs")
    assert _profile_events(tmp_path / "port-score-prof")


def test_serving_driver(tmp_path, game_data):
    from photon_ml_tpu.cli import game_training_driver as ref_training
    from photon_ml_tpu.cli import serving_driver as ref_serving
    from photon_ml_tpu_torch.cli import serving_driver

    ref_training.main([
        "--train-input-dirs", str(game_data / "train"),
        "--output-dir", str(tmp_path / "model"),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:10,1e-6,1,1,LBFGS,L2",
        "--num-iterations", "1",
    ])
    _reset_obs()
    argv = ["--game-model-input-dir", str(tmp_path / "model" / "best-model"),
            "--request-paths", str(game_data / "train"),
            "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
            "--ladder", "1,8", "--slo", "default"]
    serving_driver.main(argv + ["--output-dir", str(tmp_path / "port"),
                                "--obs-dir", str(tmp_path / "port-obs"),
                                "--profile-dir", str(tmp_path / "port-prof"), "--device", "cpu"])
    _reset_obs()
    ref_serving.main(argv + ["--output-dir", str(tmp_path / "ref"),
                             "--obs-dir", str(tmp_path / "ref-obs")])
    port, ref = _shape(tmp_path / "port-obs"), _shape(tmp_path / "ref-obs")
    assert port == ref
    assert "serving.dispatch" in port["span_names"]
    port_m = json.load(open(tmp_path / "port" / "metrics.json"))
    ref_m = json.load(open(tmp_path / "ref" / "metrics.json"))
    assert sorted(port_m["obs"]) == sorted(ref_m["obs"])
    assert sorted(port_m["slo"]) == sorted(ref_m["slo"])
    assert port_m["obs"]["conservation"]["ok"]
    assert _profile_events(tmp_path / "port-prof")
