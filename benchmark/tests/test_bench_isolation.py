"""No module of JAX or of the JAX package is loaded by the benchmark's
files or by the port they drive: names are compared whole, so the port
(``photon_ml_tpu_torch``) is not mistaken for the JAX package."""

import os
import subprocess
import sys
import types

import harness

PROBE = r"""
import glob, importlib.util, os, sys
bench = sys.argv[1]
sys.path[:0] = [os.path.dirname(bench), bench]
for path in sorted(glob.glob(os.path.join(bench, "**", "*.py"), recursive=True)):
    if os.sep + "tests" + os.sep in path:
        continue
    spec = importlib.util.spec_from_file_location("probe_" + str(abs(hash(path))), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
import photon_ml_tpu_torch.training, photon_ml_tpu_torch.game  # what the loops drive
import harness
print(harness.forbidden_modules())
"""


def test_every_benchmark_file_imports_clean():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE, harness.BENCH_DIR], capture_output=True,
                         text=True, env=env, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax", "photon_ml_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "photon_ml_tpu_torch", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    found = harness.forbidden_modules()
    assert {"jax", "jaxlib.xla_client", "flax", "photon_ml_tpu.ops"} <= set(found)
    assert "photon_ml_tpu_torch" not in found and "jaxtyping_like" not in found


def test_run_refuses_without_a_card(tmp_path):
    """No result line and a non-zero exit where the card is missing, and in
    a checkout holding only the benchmark's files."""
    import shutil

    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    only = tmp_path / "only"
    shutil.copytree(harness.BENCH_DIR, only / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), only)
    for cwd in (harness.ROOT, str(only)):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "glmix_ads_user.cd_fit",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, cwd=cwd, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == ""
