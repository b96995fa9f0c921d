"""Several processes in the port (``parallel/multihost.py``): the file
split, multi-process streaming, the streamed feature-sharded trainer and
the drivers' ``--coordinator-address / --num-processes / --process-id``,
``--distributed feature`` and ``--model-shards``, against the JAX package
and against the port's single process.

Ranks run as spawned CPU processes over gloo (``spawn_mesh``) or as one
driver process a rank. Tolerances: a multi-process streamed fit against the
single-process one, coefficients within 1e-5 of their max-abs and the same
iterations (the same sums, only the processes' partials added in another
grouping); against the JAX package's streamed trainers float32 within
5e-4 of scale (the existing streaming tests' bound); summaries within 1e-6
relative. Every multi-process fit is repeated: the repeats are bitwise,
and every rank returns the same bits.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from photon_ml_tpu_torch.cli import game_training_driver as game_driver
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
from tests.test_torch_streaming import _write_files
from tests.torch_multiprocess_cases import (
    stream_feature_sharded_fit,
    stream_fit,
    stream_summary,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stream_data(tmp_path_factory):
    from photon_ml_tpu_torch.cli import feature_indexing_driver

    tmp = tmp_path_factory.mktemp("mp")
    root = _write_files(tmp / "train", 3, n_files=5, rows_per_file=60)
    store = feature_indexing_driver.run_feature_indexing([root], str(tmp / "store"))
    return tmp, root, store


# -- the file split ------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 5])
def test_process_shard_equals_reference(monkeypatch, n):
    """The content-keyed split gives the reference's lists, whatever the
    order the items come in, and every item goes to one process."""
    from photon_ml_tpu.parallel import multihost as ref_multihost

    items = [f"/data/day={d:02d}/part-{p:05d}.avro" for d in range(4) for p in range(7)]
    mine = []
    for i in range(n):
        for mod in (multihost, ref_multihost):
            monkeypatch.setattr(mod, "process_count", lambda n=n: n)
            monkeypatch.setattr(mod, "process_index", lambda i=i: i)
        got = multihost.process_shard(items)
        assert got == ref_multihost.process_shard(items)
        assert multihost.process_shard(items[::-1]) == got[::-1]
        mine += got
    assert sorted(mine) == sorted(items)
    assert multihost.shard_assignment("x", 7) == ref_multihost.shard_assignment("x", 7)


def test_single_process_guards():
    """One process: nothing joins, every guard says process 0 of 1."""
    assert multihost.initialize_multihost(None) is False
    assert multihost.process_count() == 1 and multihost.is_coordinator()
    assert multihost.process_shard([3, 1, 2]) == [3, 1, 2]
    assert multihost.coordinator_only(lambda: 5)() == 5
    with pytest.raises(ValueError, match="--num-processes"):
        multihost.initialize_multihost("127.0.0.1:1")


# -- multi-process streaming ---------------------------------------------------


def test_streamed_summary_over_processes(stream_data):
    """The summary's moments over 2 processes' shards equal one process's
    over every file."""
    _, root, store = stream_data
    two = spawn_mesh(stream_summary, (2,), (DATA_AXIS,), device="cpu", args=(root, store))
    one = stream_summary(None, root, store)
    assert two[0][2] == two[1][2] == one[2]
    for a, b in zip(two[0][:2], one[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert all(np.array_equal(x, y) for x, y in zip(two[0][:2], two[1][:2]))


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_multiprocess_streamed_fit(stream_data, optimizer):
    """train_streaming_glm over 2 processes, each streaming its shard: in
    float64 the single process's fit (the same iterations, 1e-9); in
    float32 every rank and a repeat bitwise, the single process's
    objective within 1e-5 relative (a float32 stop test may stop an
    iteration apart on rounding) and the JAX package's streamed trainer
    within 5e-4 of scale."""
    from photon_ml_tpu.optim.config import OptimizerType as RefOpt
    from photon_ml_tpu.optim.config import RegularizationType as RefReg
    from photon_ml_tpu.task import TaskType as RefTask
    from photon_ml_tpu.training import train_streaming_glm as ref_train
    from photon_ml_tpu.utils.native_index import load_offheap_index_map as ref_load
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType

    _, root, store = stream_data
    kw = dict(regularization_type=RegularizationType.L2, regularization_weights=[1.0, 0.1],
              optimizer_type=OptimizerType[optimizer], rows_per_chunk=32, tolerance=1e-6)
    wide = dict(kw, float64=True)
    two64 = spawn_mesh(stream_fit, (2,), (DATA_AXIS,), device="cpu", args=(root, store, wide))
    one64 = stream_fit(None, root, store, wide)
    runs = [spawn_mesh(stream_fit, (2,), (DATA_AXIS,), device="cpu", args=(root, store, kw))
            for _ in range(2)]
    single = stream_fit(None, root, store, kw)
    ref_models, _, _ = ref_train(
        [root], RefTask.LOGISTIC_REGRESSION, regularization_type=RefReg.L2,
        regularization_weights=[1.0, 0.1], optimizer_type=RefOpt[optimizer],
        rows_per_chunk=32, tolerance=1e-6, index_map=ref_load(store))
    for lam in (1.0, 0.1):
        assert two64[0][lam][1] == one64[lam][1]
        np.testing.assert_allclose(two64[0][lam][0], one64[lam][0], rtol=0, atol=1e-9)
        coef, it, val = runs[0][0][lam]
        for other in (runs[0][1], runs[1][0], runs[1][1]):
            assert np.array_equal(other[lam][0], coef) and other[lam][1:] == (it, val)
        assert abs(val - single[lam][2]) <= 1e-5 * abs(single[lam][2])
        ref = np.asarray(ref_models[lam].coefficients.means)
        np.testing.assert_allclose(coef, ref, rtol=0, atol=5e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_streamed_feature_sharded_fit(stream_data, shape):
    """train_streaming_feature_sharded on 2 ranks against the JAX
    package's on 2 virtual devices (float32, the same iterations within
    one, 5e-4 of scale) and against the port's single-process streamed
    fit (1e-5 of scale); every rank and a repeat bitwise."""
    import jax

    from photon_ml_tpu.optim.config import OptimizerType as RefOpt
    from photon_ml_tpu.optim.config import RegularizationType as RefReg
    from photon_ml_tpu.parallel.mesh import make_mesh as ref_mesh
    from photon_ml_tpu.task import TaskType as RefTask
    from photon_ml_tpu.training import train_streaming_feature_sharded as ref_train
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType

    _, root, _ = stream_data
    kw = dict(regularization_type=RegularizationType.L2, regularization_weights=[1.0, 0.1],
              optimizer_type=OptimizerType.LBFGS, rows_per_chunk=32, tolerance=1e-6)
    runs = [spawn_mesh(stream_feature_sharded_fit, shape, (DATA_AXIS, MODEL_AXIS),
                       device="cpu", args=(root, kw)) for _ in range(2)]
    single = stream_fit(None, root, None, kw)
    ref_models, ref_results, _ = ref_train(
        [root], RefTask.LOGISTIC_REGRESSION, mesh=ref_mesh(shape, (DATA_AXIS, MODEL_AXIS),
                                                         jax.devices()[:2]),
        regularization_type=RefReg.L2, regularization_weights=[1.0, 0.1],
        optimizer_type=RefOpt.LBFGS, rows_per_chunk=32, tolerance=1e-6)
    for lam in (1.0, 0.1):
        coef, it, val = runs[0][0][lam]
        for other in (runs[0][1], runs[1][0], runs[1][1]):
            assert np.array_equal(other[lam][0], coef) and other[lam][1:] == (it, val)
        assert abs(it - int(ref_results[lam].iterations)) <= 1
        ref = np.asarray(ref_models[lam].coefficients.means)
        np.testing.assert_allclose(coef, ref, rtol=0, atol=5e-4 * float(np.abs(ref).max()))
        s_coef = single[lam][0]
        np.testing.assert_allclose(coef, s_coef, rtol=0, atol=1e-5 * float(np.abs(s_coef).max()))


# -- the drivers -----------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(module, argv_of, n=2, timeout=600):
    """One driver process a rank; -> their exit codes (and output on
    failure)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", module, *argv_of(i),
             "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(i)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(n)
    ]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _objective64(root, store, means, lam):
    """The L2 logistic objective of ``means`` over the files' rows, in
    float64 (the store's index space)."""
    import torch

    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.utils.native_index import load_offheap_index_map

    batch = AvroInputDataFormat().load(
        [root], index_map=load_offheap_index_map(store), device="cpu").batch
    batch = type(batch)(batch.indices, batch.values.double(), batch.labels.double(),
                        batch.offsets.double(), batch.weights.double())
    w = torch.as_tensor(np.asarray(means, np.float64))
    return float(GLMObjective(LOGISTIC, w.shape[0]).value(w, batch, float(lam)))


def _glm_means(out):
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    imap_path = os.path.join(out, "feature-index", "index.json")
    models = os.path.join(out, "models", "models.avro")
    if os.path.exists(imap_path):
        imap = IndexMap.load(imap_path)
    else:
        imap = None
    return {k: m.means.numpy() for k, m in load_glm_models_avro(models, imap, device="cpu").items()}


@pytest.mark.parametrize("mode", ["streaming", "feature"])
def test_glm_driver_over_processes(stream_data, mode):
    """The GLM driver as 2 processes: streamed (each process its shard of
    the files, over the off-heap store) or in memory over a 1 x 2 (data,
    model) mesh; process 0 writes. Its models are a second 2-process
    run's, bitwise, and reach the single process's float64 objective
    within 1e-6 relative (two layouts' float32 sums meet the stop test a
    few ulps apart, so the coefficients themselves may part by ~1e-4)."""
    tmp, root, store = stream_data
    common = ["--training-data-directory", root, "--regularization-weights", "1,0.1",
              "--device", "cpu", "--offheap-indexmap-dir", store,
              "--delete-output-dirs-if-exist", "true"]
    if mode == "streaming":
        common += ["--streaming", "true"]
    else:
        common += ["--distributed", "feature", "--model-shards", "2"]
    outs = [str(tmp / f"{mode}-{r}") for r in range(2)]
    for out in outs:
        _run_ranks("photon_ml_tpu_torch.cli.glm_driver",
                   lambda i, out=out: common + ["--output-directory", out])
    single = str(tmp / f"{mode}-single")
    glm_driver.main(common + ["--output-directory", single])
    a, b, s = (_glm_means(o) for o in (*outs, single))
    assert sorted(a) == sorted(s)
    for lam in a:
        assert np.array_equal(a[lam], b[lam])
        f_a, f_s = _objective64(root, store, a[lam], lam), _objective64(root, store, s[lam], lam)
        assert abs(f_a - f_s) <= 1e-6 * abs(f_s)
    assert json.load(open(os.path.join(outs[0], "metrics.json")))


def test_game_driver_over_processes(tmp_path):
    """The GAME training driver as 2 processes with the fixed effect over
    a 1 x 2 (data, model) mesh: its objective history is the single
    process's (1e-5 relative) and a second run's, bitwise."""
    from tests.test_torch_game_drivers import _avro, _train_argv

    for d in ("train", "val"):
        (tmp_path / d).mkdir()
    _avro(str(tmp_path / "train" / "p0.avro"), 20, 160)
    _avro(str(tmp_path / "train" / "p1.avro"), 21, 100)
    _avro(str(tmp_path / "val" / "p0.avro"), 22, 120)
    extra = ["--device", "cpu", "--distributed", "feature", "--model-shards", "2"]
    outs = [tmp_path / f"out-{r}" for r in range(2)]
    for out in outs:
        _run_ranks("photon_ml_tpu_torch.cli.game_training_driver",
                   lambda i, out=out: _train_argv(tmp_path, out, "BEST", extra))
    single = tmp_path / "single"
    game_driver.main(_train_argv(tmp_path, single, "BEST", extra))
    hist = [json.load(open(o / "metrics.json"))["objective_history"] for o in (*outs, single)]
    assert hist[0] == hist[1]
    np.testing.assert_allclose(hist[0], hist[2], rtol=1e-5)


REFUSALS = [
    ("glm", ["--streaming", "true", "--distributed", "feature",
             "--normalization-type", "STANDARDIZATION"]),
    ("glm", ["--streaming", "true", "--coordinator-address", "127.0.0.1:1",
             "--num-processes", "2", "--process-id", "0"]),
    ("glm", ["--streaming", "true", "--distributed", "feature", "--offheap-indexmap-dir", "s",
             "--coordinator-address", "127.0.0.1:1", "--num-processes", "2",
             "--process-id", "0"]),
    ("glm", ["--retrain-from", "reg", "--distributed", "feature"]),
    ("game", ["--streaming", "true", "--distributed", "feature"]),
    ("game", ["--streaming", "true", "--coordinator-address", "127.0.0.1:1",
              "--num-processes", "2", "--process-id", "0"]),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_driver_refusals_equal_reference(tmp_path, case):
    """What each driver refuses, in the reference's words; and the GAME
    driver lacks no path any more (--entity-shards is ported)."""
    kind, extra = REFUSALS[case]
    if kind == "glm":
        from photon_ml_tpu.cli import glm_driver as ref

        argv = ["--training-data-directory", "t", "--output-directory", str(tmp_path / "o"),
                *extra]
        port = glm_driver.params_from_args(argv + ["--device", "cpu"])
        ref_params = ref.params_from_args(argv)
    else:
        from pathlib import Path

        from photon_ml_tpu.cli import game_training_driver as ref
        from tests.test_torch_game_drivers import _train_argv

        argv = _train_argv(Path("t"), tmp_path / "o", "BEST", extra)
        port = game_driver.params_from_args(argv + ["--device", "cpu"])
        ref_params = ref.params_from_args(argv)
    with pytest.raises(ValueError) as want:
        ref_params.validate()
    with pytest.raises(ValueError) as got:
        port.validate()
    assert str(got.value) == str(want.value)
    if kind == "game":
        port = game_driver.params_from_args(
            _train_argv(Path("t"), tmp_path / "o", "BEST", ["--entity-shards", "2"]))
        assert port.unported() == []
