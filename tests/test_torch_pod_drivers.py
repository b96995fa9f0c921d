"""``--entity-shards`` through the port's GAME training driver, the
streamed entity shards, ``resolve_entity_shards`` and the driver's
refusals, against the JAX package.

The driver runs as one process with ``--entity-shards 1`` (the
single-shard pod path on one rank) and as 2 processes with
``--entity-shards 2`` (``--coordinator-address --num-processes
--process-id``, gloo on the CPU), each against the JAX driver with the
same option on its virtual CPU devices; and as 2 processes with N = 1 (the
partial case: each process its own 1-rank entity mesh, no fixed-effect
mesh). The streamed path runs ``train_streaming_game(entity_mesh=)`` on 2
spawned ranks against the reference's on 2 virtual devices.

Tolerances (float32): the CD objective history within 1e-5 relative of
the JAX driver's and the best combo the same; the written model's scores
through the port's scoring driver within 5e-4 of scale of the JAX
driver's model's (both coordinates carry an intercept: Queue 3's flat
direction, along which float32 fits part by up to that much); the two 2-process runs' objective histories and model
files bitwise; the partial run bitwise the single process's. The streamed
objective within 1e-5 relative of the reference's streamed pod and of the
port's replicated streamed run, the banks within 1e-3 of their scale (the
streamed tests' envelope), every rank the same bits. Refusals equal the
reference's messages word for word.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from photon_ml_tpu.cli import game_training_driver as ref_training
from photon_ml_tpu_torch.cli import game_scoring_driver as port_scoring
from photon_ml_tpu_torch.cli import game_training_driver as port_training
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, spawn_mesh
from photon_ml_tpu_torch.training import resolve_entity_shards
from test_torch_game_drivers import SHARD_MAP, _avro
from torch_parity import assert_close_to_scale
from torch_pod_cases import STREAM_FE_SPEC, STREAM_RE_SPEC, streamed_game

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(data, out, extra=()):
    return [
        "--train-input-dirs", str(data / "train"),
        "--validate-input-dirs", str(data / "val"),
        "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:40,1e-7,1,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
        "--random-effect-optimization-configurations", "per-user:40,1e-7,1,1,LBFGS,L2",
        "--num-iterations", "2",
        "--evaluator-types", "AUC",
        "--model-output-mode", "BEST",
        *extra,
    ]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argv, n=2, timeout=600):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver", *argv,
             "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(i)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(n)
    ]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pod_drivers")
    for d in ("train", "val"):
        (root / d).mkdir()
    _avro(str(root / "train" / "p0.avro"), 20, 160)
    _avro(str(root / "train" / "p1.avro"), 21, 100)
    _avro(str(root / "val" / "p0.avro"), 22, 120)
    out = {}
    for n in (1, 2):
        ref = ref_training.GameTrainingDriver(ref_training.params_from_args(
            _argv(root, root / f"ref{n}", ["--entity-shards", str(n)])))
        ref.run()
        out[f"ref{n}"] = ref
    out["port1"] = port_training.main(
        _argv(root, root / "port1", ["--entity-shards", "1", "--device", "cpu"]))
    for tag in ("port2a", "port2b"):
        _run_ranks(_argv(root, root / tag, ["--entity-shards", "2", "--device", "cpu"]))
    _run_ranks(_argv(root, root / "partial", ["--entity-shards", "1", "--device", "cpu"]))
    return root, out


def _history(root, tag):
    return json.load(open(root / tag / "metrics.json"))["objective_history"]


def _scores(root, model_dir, tag):
    out = root / f"scores-{tag}"
    port_scoring.main([
        "--input-data-dirs", str(root / "val"), "--game-model-input-dir", str(model_dir),
        "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP, "--device", "cpu",
    ])
    from photon_ml_tpu_torch.io.avro_codec import read_avro_records

    recs = []
    for name in sorted(os.listdir(out / "scores")):
        if name.endswith(".avro"):
            recs += list(read_avro_records(str(out / "scores" / name)))
    return np.array([r["predictionScore"] for r in recs])


@pytest.mark.parametrize("n", [1, 2])
def test_entity_shards_driver_matches_reference(runs, n):
    root, out = runs
    ref = out[f"ref{n}"]
    tag = "port1" if n == 1 else "port2a"
    hist = _history(root, tag)
    np.testing.assert_allclose(hist, ref.best_result[0].objective_history, rtol=1e-5)
    got = _scores(root, root / tag / "best-model", tag)
    want = _scores(root, root / f"ref{n}" / "best-model", f"ref{n}")
    assert_close_to_scale(got, want, rtol=5e-4)
    if n == 1:
        assert out["port1"].best_config["per-user"].render() == \
            ref.best_config["per-user"].render()


def test_two_process_runs_repeat_bitwise_and_partial_is_the_single_process(runs):
    root, _ = runs
    assert _history(root, "port2a") == _history(root, "port2b")
    for sub in ("fixed-effect", "random-effect"):
        a, b = root / "port2a" / "best-model" / sub, root / "port2b" / "best-model" / sub
        for dirpath, _, files in os.walk(a):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), a)
                assert open(os.path.join(a, rel), "rb").read() == \
                    open(os.path.join(b, rel), "rb").read(), rel
    assert _history(root, "partial") == _history(root, "port1")


def test_resolve_entity_shards_equals_reference():
    from photon_ml_tpu.training import resolve_entity_shards as ref_resolve

    for req in (None, 0, -1, 1, 4, 8):
        assert resolve_entity_shards(req, num_devices=8) == ref_resolve(req, num_devices=8)
    for bad in (9, -2):
        with pytest.raises(ValueError) as want:
            ref_resolve(bad, num_devices=8)
        with pytest.raises(ValueError) as got:
            resolve_entity_shards(bad, num_devices=8)
        assert str(got.value) == str(want.value)
    assert resolve_entity_shards(-1) == 1  # one process here


REFUSALS = [
    ["--entity-shards", "-2"],
    ["--entity-shards", "2", "--factored-random-effect-optimization-configurations",
     "per-user:4,2"],
    ["--entity-shards", "2", "--streaming", "true", "--compute-variance", "true"],
    ["--entity-shards", "2", "--retrain-from", "reg"],
    ["--entity-shards", "2", "--retrain-from", "reg", "--streaming", "true"],
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_entity_shard_refusals_equal_reference(tmp_path, case):
    from pathlib import Path

    argv = _argv(Path("t"), tmp_path / "o", REFUSALS[case])
    with pytest.raises(ValueError) as want:
        ref_training.params_from_args(argv).validate()
    with pytest.raises(ValueError) as got:
        port_training.params_from_args(argv + ["--device", "cpu"]).validate()
    assert str(got.value) == str(want.value)
    assert port_training.params_from_args(argv + ["--device", "cpu"]).unported() == []


def test_streamed_entity_shards_match_reference(tmp_path):
    """``train_streaming_game(entity_mesh=)`` on 2 ranks against the
    reference's on 2 virtual devices and the port's replicated streamed
    run; the ranks return the same bits."""
    from photon_ml_tpu.game import streaming as ref_gs
    from photon_ml_tpu.game.config import FeatureShardConfiguration as RefShard
    from photon_ml_tpu.game.config import FixedEffectDataConfiguration as RefFE
    from photon_ml_tpu.game.config import ProjectorType as RefProjector
    from photon_ml_tpu.game.config import RandomEffectDataConfiguration as RefRE
    from photon_ml_tpu.optim.config import GLMOptimizationConfiguration as RefOptConfig
    from photon_ml_tpu.parallel.mesh import entity_mesh as ref_entity_mesh
    from photon_ml_tpu.task import TaskType as RefTask
    from test_torch_streaming_game import _write_game_files

    train = _write_game_files(tmp_path / "train", 0)
    (tmp_path / "spill-ref").mkdir()
    got = spawn_mesh(streamed_game, (2,), (ENTITY_AXIS,), device="cpu",
                     args=(train, str(tmp_path / "spill")))
    single = streamed_game(None, train, str(tmp_path / "spill-single"))
    ref, _ = ref_gs.train_streaming_game(
        [train], [RefShard("globalShard", ["features"]), RefShard("userShard", ["userFeatures"])],
        {"global": RefFE("globalShard")},
        {"per-user": RefRE("userId", "userShard", projector_type=RefProjector.IDENTITY)},
        {"global": RefOptConfig.parse(STREAM_FE_SPEC),
         "per-user": RefOptConfig.parse(STREAM_RE_SPEC)},
        RefTask.LOGISTIC_REGRESSION, num_iterations=2, spill_dir=str(tmp_path / "spill-ref"),
        entity_mesh=ref_entity_mesh(2),
    )
    first = got[0]
    assert got[1]["objective"] == first["objective"]
    np.testing.assert_array_equal(got[1]["bank"], first["bank"])
    np.testing.assert_allclose(first["objective"], ref.objective_history, rtol=1e-5)
    np.testing.assert_allclose(first["objective"], single["objective"], rtol=1e-5)
    ref_bank = np.asarray(ref.game_model.get_model("per-user").bank)
    assert_close_to_scale(first["bank"], ref_bank, rtol=1e-3)
    assert_close_to_scale(first["bank"], single["bank"].numpy(), rtol=1e-3)
    assert_close_to_scale(first["fe"], single["fe"].numpy(), rtol=1e-3)


def test_driver_streaming_with_one_entity_shard(tmp_path):
    """``--streaming true --entity-shards 1``: the streamed pod path on one
    rank, the replicated streamed run's objective."""
    from test_torch_streaming_game import _write_game_files

    train = _write_game_files(tmp_path / "train", 0)
    common = [
        "--train-input-dirs", train, "--feature-shard-id-to-feature-section-keys-map",
        SHARD_MAP, "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", f"global:{STREAM_FE_SPEC}",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,IDENTITY",
        "--random-effect-optimization-configurations", f"per-user:{STREAM_RE_SPEC}",
        "--num-iterations", "2", "--streaming", "true", "--device", "cpu",
    ]
    pod = port_training.main(common + ["--output-dir", str(tmp_path / "a"),
                                       "--entity-shards", "1"])
    rep = port_training.main(common + ["--output-dir", str(tmp_path / "b")])
    a = pod.results[0][1].objective_history
    b = rep.results[0][1].objective_history
    np.testing.assert_allclose(a, b, rtol=1e-5)
