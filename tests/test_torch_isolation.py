"""The PyTorch port stands alone: it imports neither ``jax`` nor
``photon_ml_tpu`` (checked in a fresh interpreter, in the spawned ranks of
a mesh, and by an AST scan of its sources and of ``chip_smoke.py``), and
its entry points run on the CUDA card unless the caller asks for the CPU.

This module imports nothing of JAX: its rank function runs in spawned
ranks that re-import it.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import photon_ml_tpu_torch
from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.ops.tiled_sparse import build_tiled_batch
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.problem import resolve_kernel
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model
from photon_ml_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(photon_ml_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_fresh_interpreter_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import photon_ml_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'photon_ml_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, check=True,
        capture_output=True, text=True,
    ).stdout.split()
    for module in (
        "training", "cli.glm_driver", "cli.feature_indexing_driver",
        "diagnostics.diagnostics", "diagnostics.report", "diagnostics.reporting",
        "evaluation.evaluator", "evaluation.metrics", "data.sampler",
        "io.name_term_list", "utils.native_index",
        "game", "game.config", "game.data", "game.random_effect_data",
        "game.random_effect", "game.model", "game.coordinate",
        "game.coordinate_descent", "game.model_io",
        "cli.game_training_driver", "cli.game_scoring_driver", "tools.fe_spread",
        "reliability", "reliability.faults", "reliability.retry", "reliability.manifest",
        "reliability.artifacts", "reliability.checkpoint", "utils.checkpoint",
        "utils.preemption", "parallel.overlap",
        "io.streaming", "optim.host_lbfgs", "optim.host_tron", "evaluation.streaming",
        "registry", "registry.stats_cache", "game.streaming",
        "ownership", "obs", "obs.trace", "obs.flight_recorder",
        "serving", "serving.admission", "serving.metrics", "serving.model_bank",
        "serving.programs", "serving.batcher", "serving.swap", "serving.wire",
        "serving.frontend", "cli.serving_driver",
        "events", "obs.events", "obs.registry", "obs.slo", "obs.fleet",
        "serving.routing", "serving.shard_server", "testing", "testing.interleave",
        "utils.profiling",
        "registry.registry", "registry.gates", "registry.warm_start", "registry.watcher",
        "testing.determinism", "testing.determinism_targets",
        "parallel.multihost", "ops.fixed_order",
        "parallel.mesh", "parallel.shuffle", "parallel.unified_mesh",
        "game.residual_routing", "game.pod", "game.unified",
        "parallel", "parallel.distributed", "models", "models.glm",
        "models.coefficients", "optim", "optim.common", "optim.problem", "io",
        "io.libsvm", "evaluation", "data.batch", "ops.objective",
        "ops.schedule_cache", "ops.tiled_sparse", "ops.kernels.entity_products",
        "lint", "lint.core", "lint.baseline", "lint.cli", "lint.__main__",
        "lint.determinism", "lint.rules", "lint.rules.host_sync", "lint.rules.spill",
        "lint.rules.io_drain", "lint.rules.reliability", "lint.rules.request_path",
        "lint.rules.shared_state", "lint.rules.lock_order", "lint.rules.atomicity",
        "lint.rules.artifact_order", "lint.rules.entropy", "lint.rules.float_order",
        "lint.rules.wire_contract",
    ):
        assert f"photon_ml_tpu_torch.{module}" in out
    assert not [m for m in out if _forbidden(m)]


def test_lint_imports_only_the_stdlib():
    """The port's analyzer (``photon_ml_tpu_torch/lint/``) imports the
    standard library and itself: no torch, no jax, nothing of the JAX
    package, so it runs wherever the sources are."""
    lint_dir = os.path.join(PKG, "lint")
    seen = set()
    for root, _, files in os.walk(lint_dir):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for name in names:
                    seen.add(name)
                    top = name.split(".")[0]
                    assert top in sys.stdlib_module_names or name.startswith(
                        "photon_ml_tpu_torch.lint"), f"{f} imports {name}"
    assert "ast" in seen and "tokenize" in seen


_BLOCKER = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'photon_ml_tpu'):\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
)


def test_cpu_driver_runs_where_jax_cannot_be_imported(tmp_path):
    """``python -m photon_ml_tpu_torch.cli.glm_driver ... --device cpu`` in
    a process where importing jax or the JAX package fails, over Avro (the
    native decoder) and LibSVM files."""
    _blocked_driver_runs(tmp_path, slice_options=False)


def test_cpu_driver_slice_runs_where_jax_cannot_be_imported(tmp_path):
    """As above, over a store that ``python -m
    photon_ml_tpu_torch.cli.feature_indexing_driver`` built in that
    process, with per-iteration validation and diagnostics."""
    _blocked_driver_runs(tmp_path, slice_options=True)


def _blocked_driver_runs(tmp_path, slice_options):
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    rng = np.random.default_rng(0)
    rows = [(rng.choice(6, size=3, replace=False), rng.normal(size=3)) for _ in range(40)]
    labels = [int(v.sum() > 0) for _, v in rows]
    (tmp_path / "svm").mkdir()
    (tmp_path / "svm" / "part-0").write_text("".join(
        f"{y} " + " ".join(f"{i + 1}:{x:.6g}" for i, x in zip(ix, v)) + "\n"
        for (ix, v), y in zip(rows, labels)
    ))
    (tmp_path / "avro").mkdir()
    write_container(str(tmp_path / "avro" / "part-0.avro"), schemas.TRAINING_EXAMPLE_AVRO, [
        {"label": float(y), "features": [
            {"name": f"f{i}", "term": "", "value": float(x)} for i, x in zip(ix, v)]}
        for (ix, v), y in zip(rows, labels)
    ])
    for kind, extra in (("svm", ["--input-file-format", "LIBSVM"]), ("avro", [])):
        argv = [
            "--training-data-directory", str(tmp_path / kind),
            "--validating-data-directory", str(tmp_path / kind),
            "--output-directory", str(tmp_path / f"out-{kind}"),
            "--regularization-weights", "1,0.1", "--device", "cpu", *extra,
        ]
        index = ""
        if slice_options:
            store = str(tmp_path / f"store-{kind}")
            argv += ["--validate-per-iteration", "true", "--diagnostic-mode", "ALL",
                     "--offheap-indexmap-dir", store]
            index_argv = ["--input-paths", str(tmp_path / kind), "--output-dir", store,
                          "--format", "LIBSVM" if kind == "svm" else "AVRO"]
            index = (
                f"sys.argv = ['feature_indexing_driver'] + {index_argv!r}\n"
                "runpy.run_module('photon_ml_tpu_torch.cli.feature_indexing_driver', "
                "run_name='__main__')\n"
            )
        code = _BLOCKER + (
            "import runpy\n" + index +
            f"sys.argv = ['glm_driver'] + {argv!r}\n"
            "runpy.run_module('photon_ml_tpu_torch.cli.glm_driver', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'photon_ml_tpu'))\n"
            "assert not bad, bad\n"
        )
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                       capture_output=True, text=True, timeout=300)
        assert (tmp_path / f"out-{kind}" / "best-model" / "model.avro").is_file()
        if slice_options:
            assert (tmp_path / f"out-{kind}" / "model-diagnostics" / "report.html").is_file()


def test_cpu_game_drivers_run_where_jax_cannot_be_imported(tmp_path):
    """``python -m photon_ml_tpu_torch.cli.game_training_driver`` and then
    ``...game_scoring_driver`` with ``--device cpu`` in a process where
    importing jax or the JAX package fails."""
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    rng = np.random.default_rng(0)
    schema = dict(schemas.TRAINING_EXAMPLE_AVRO)
    recs = []
    for i in range(64):
        x = rng.normal(size=3)
        recs.append({
            "label": float(x.sum() > 0), "metadataMap": {"userId": f"u{i % 4}"},
            "features": [{"name": f"f{j}", "term": "", "value": float(x[j])} for j in range(3)],
        })
    (tmp_path / "in").mkdir()
    write_container(str(tmp_path / "in" / "part-0.avro"), schema, recs)
    shard_map = "global:features|user:features"
    train = [
        "--train-input-dirs", str(tmp_path / "in"), "--validate-input-dirs", str(tmp_path / "in"),
        "--output-dir", str(tmp_path / "out"),
        "--feature-shard-id-to-feature-section-keys-map", shard_map,
        "--fixed-effect-data-configurations", "global:global,1",
        "--fixed-effect-optimization-configurations", "global:20,1e-6,1,1,LBFGS,L2",
        "--random-effect-data-configurations", "per-user:userId,user,1,none,none,none,INDEX_MAP",
        "--random-effect-optimization-configurations", "per-user:20,1e-6,1,1,LBFGS,L2",
        "--num-iterations", "2", "--model-output-mode", "BEST", "--device", "cpu",
    ]
    score = [
        "--input-data-dirs", str(tmp_path / "in"),
        "--game-model-input-dir", str(tmp_path / "out" / "best-model"),
        "--output-dir", str(tmp_path / "scores"),
        "--feature-shard-id-to-feature-section-keys-map", shard_map,
        "--evaluator-types", "AUC", "--device", "cpu",
    ]
    code = _BLOCKER + (
        "import runpy\n"
        f"sys.argv = ['game_training_driver'] + {train!r}\n"
        "runpy.run_module('photon_ml_tpu_torch.cli.game_training_driver', run_name='__main__')\n"
        f"sys.argv = ['game_scoring_driver'] + {score!r}\n"
        "runpy.run_module('photon_ml_tpu_torch.cli.game_scoring_driver', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'photon_ml_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   capture_output=True, text=True, timeout=300)
    assert (tmp_path / "out" / "best-model" / "random-effect" / "per-user" / "id-info").is_file()
    assert (tmp_path / "scores" / "scores" / "part-00000.avro").is_file()


def test_sources_import_no_jax():
    offenders = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [(path, n) for n in names if _forbidden(n)]
    assert offenders == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        make_sparse_batch([([0], [1.0])], [1.0])
    rows = np.zeros(1, np.int64)
    with pytest.raises(RuntimeError):
        build_tiled_batch(
            rows, rows, np.ones(1, np.float32), np.ones(1, np.float32),
            np.zeros(1, np.float32), np.ones(1, np.float32), 4,
        )
    batch = make_sparse_batch([([0], [1.0])], [1.0], device="cpu")
    with pytest.raises(RuntimeError):
        train_generalized_linear_model(batch, TaskType.LOGISTIC_REGRESSION, 4)
    with pytest.raises(RuntimeError):
        resolve_kernel("auto")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn_mesh(_probe_rank, (1,), timeout_s=60.0)
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.game import FeatureShardConfiguration, build_game_dataset

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_game_dataset(
            [{"response": 1.0, "features": []}], [FeatureShardConfiguration("g", ["features"])]
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        game_training_driver.GameTrainingDriver(game_training_driver.GameTrainingParams(
            train_input_dirs=["t"], output_dir="o", random_effect_data_configs={},
            fixed_effect_data_configs={"g": None}, fixed_effect_opt_configs={"g": ""},
        ))


def test_cpu_on_request(no_cuda):
    assert resolve_device("cpu").type == "cpu"
    assert resolve_kernel("auto", "cpu") == "scatter"
    assert resolve_kernel("tiled", "cpu") == "tiled"
    with pytest.raises(ValueError):
        resolve_kernel("pallas", "cpu")


def _probe_rank(mesh):
    """What a spawned rank sees: its modules, coordinates and collectives."""
    common.collectives = 0
    model, data = mesh.groups[MODEL_AXIS], mesh.groups[DATA_AXIS]
    x = torch.tensor([float(mesh.rank)])
    reductions = common.MeshReductions(model=model, world=mesh.world)
    out = dict(
        forbidden=sorted(m for m in sys.modules if _forbidden(m)),
        coords=mesh.coords,
        model_sum=common.all_reduce(x.clone(), model),
        data_sum=common.all_reduce(x.clone(), data),
        gathered=common.all_gather_last(x, model),
        flags=common.fetch(x, mesh=reductions)[0],
        dot=common.dot(torch.ones(1, 3), torch.ones(1, 3), reductions),
    )
    out["collectives"] = common.collectives
    return out


@pytest.fixture(scope="module")
def probes():
    return spawn_mesh(
        _probe_rank, (2, 2), (DATA_AXIS, MODEL_AXIS), device="cpu", timeout_s=120.0
    )


def test_spawned_ranks_import_no_jax(probes):
    assert [p["forbidden"] for p in probes] == [[]] * 4


def test_spawned_ranks_see_their_mesh(probes):
    """Rank r = 2 d + m sits at (d, m); the model group sums along m, the
    data group along d; a gather comes back in model order; every rank
    fetches world rank 0's flags; a sharded dot sums over both blocks."""
    for r, p in enumerate(probes):
        d, m = divmod(r, 2)
        assert p["coords"] == (d, m)
        assert p["model_sum"].tolist() == [4.0 * d + 1.0]
        assert p["data_sum"].tolist() == [2.0 * m + 2.0]
        assert p["gathered"].tolist() == [2.0 * d, 2.0 * d + 1.0]
        assert p["flags"] == [0.0]
        assert p["dot"].tolist() == [6.0]
        assert p["collectives"] == 5

