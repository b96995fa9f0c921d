"""The port's small public functions and its sub-packages' exports against
the JAX package's: ``CoefficientSummary``, the four GLM constructors,
``project_coefficients_to_hypercube``, ``libsvm_feature_keys``, the mesh
helpers in rank terms (``data_sharding``, ``replicated``, ``replicate``,
``shard_batch``, ``ensure_data_sharded``) and the drivers' mesh policy
``maybe_make_mesh`` with its errors word for word; every name each
reference sub-package exports (its ``__all__``; the serving package's
imported names) imports from the port's namesake.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.io.libsvm import libsvm_feature_keys as ref_libsvm_feature_keys
from photon_ml_tpu.models import coefficients as ref_coefficients
from photon_ml_tpu.models import glm as ref_glm
from photon_ml_tpu.optim.common import BoxConstraints as RefBox
from photon_ml_tpu.optim.common import project_coefficients_to_hypercube as ref_project
from photon_ml_tpu.parallel import mesh as ref_mesh
from photon_ml_tpu_torch.data.batch import DenseBatch, make_dense_batch, make_sparse_batch
from photon_ml_tpu_torch.io.libsvm import libsvm_feature_keys, read_libsvm
from photon_ml_tpu_torch.models import CoefficientSummary, Coefficients
from photon_ml_tpu_torch.models import glm
from photon_ml_tpu_torch.optim import BoxConstraints, project_coefficients_to_hypercube
from photon_ml_tpu_torch.parallel import mesh
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh
from photon_ml_tpu_torch.task import TaskType
from tests.torch_parity import to_np

PACKAGES = ("parallel", "models", "optim", "io", "evaluation", "registry", "serving")


@pytest.mark.parametrize("package", PACKAGES)
def test_every_reference_export_imports_from_the_port(package):
    ref = importlib.import_module(f"photon_ml_tpu.{package}")
    ours = importlib.import_module(f"photon_ml_tpu_torch.{package}")
    # the reference's serving package names its exports by importing them
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items() if not n.startswith("_") and not inspect.ismodule(v)
    ]
    assert names and set(names) <= set(ours.__all__)
    for name in names:
        exec(f"from photon_ml_tpu_torch.{package} import {name}", {})


def _replicates(seed=0, shape=(5,)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(7)]


def test_coefficient_summary_matches_reference():
    """Welford's running count / mean / m2 / min / max and the variance, in
    float64, against the reference's ``accumulate``; ``merge`` of two
    halves is the summary of the whole."""
    xs = _replicates()
    with jax.enable_x64(True):
        ref = ref_coefficients.CoefficientSummary.empty(jnp.float64)
        for x in xs:
            ref = ref.accumulate(jnp.asarray(x))
        ref_fields = [np.asarray(getattr(ref, f)) for f in ("count", "mean", "m2", "min", "max")]
        ref_var = np.asarray(ref.variance)
    ours = CoefficientSummary.empty(torch.float64, shape=(5,))
    halves = [CoefficientSummary.empty(torch.float64, shape=(5,)) for _ in range(2)]
    for i, x in enumerate(xs):
        ours = ours.accumulate(torch.as_tensor(x))
        halves[i % 2] = halves[i % 2].accumulate(torch.as_tensor(x))
    for f, want in zip(("count", "mean", "m2", "min", "max"), ref_fields):
        np.testing.assert_allclose(to_np(getattr(ours, f)), want, rtol=1e-12)
    np.testing.assert_allclose(to_np(ours.variance), ref_var, rtol=1e-12)
    merged = halves[0].merge(halves[1])
    for f in ("count", "mean", "m2", "min", "max"):
        np.testing.assert_allclose(to_np(getattr(merged, f)), to_np(getattr(ours, f)),
                                   rtol=1e-12, atol=1e-15)
    empty = CoefficientSummary.empty(torch.float64)
    assert float(empty.variance) == 0.0 and float(empty.min) == float("inf")
    one = empty.accumulate(torch.tensor(2.0, dtype=torch.float64))
    assert float(one.variance) == 0.0 and float(one.merge(empty).mean) == 2.0
    assert float(empty.merge(one).mean) == 2.0


def test_glm_constructors_match_reference():
    means = torch.tensor([0.5, -1.0, 2.0])
    for name in ("logistic_regression_model", "linear_regression_model",
                 "poisson_regression_model", "smoothed_hinge_svm_model"):
        model = getattr(glm, name)(Coefficients(means))
        ref = getattr(ref_glm, name)(ref_coefficients.Coefficients(jnp.asarray(means.numpy())))
        assert model.task.name == ref.task.name and model.task == TaskType[ref.task.name]
        assert torch.equal(model.means, means)
        updated = model.update_coefficients(Coefficients(means * 2))
        assert updated.task == model.task and torch.equal(updated.means, means * 2)
    c = Coefficients(torch.tensor([[3.0, -4.0], [1.0, 0.0]]))
    assert torch.equal(c.l2_norm(), torch.tensor([5.0, 1.0]))
    assert torch.equal(c.l1_norm(), torch.tensor([7.0, 1.0]))
    assert torch.equal(Coefficients.zeros(3).means, torch.zeros(3))


def test_hypercube_projection_matches_reference():
    rng = np.random.default_rng(1)
    w = rng.normal(size=10).astype(np.float32) * 2
    lo, hi = -np.abs(rng.normal(size=10)).astype(np.float32), np.abs(rng.normal(size=10)).astype(np.float32)
    lo[0], hi[1] = -np.inf, np.inf
    want = np.asarray(ref_project(jnp.asarray(w), RefBox(jnp.asarray(lo), jnp.asarray(hi))))
    got = project_coefficients_to_hypercube(
        torch.as_tensor(w), BoxConstraints(torch.as_tensor(lo), torch.as_tensor(hi)))
    np.testing.assert_array_equal(got.numpy(), want)
    same = torch.as_tensor(w)
    assert project_coefficients_to_hypercube(same, None) is same


def test_libsvm_feature_keys_match_reference(tmp_path):
    path = tmp_path / "part-0"
    path.write_text("1 3:0.5 7:1\n-1 1:2 3:1 # comment\n\n0 12:0.25\n")
    parsed = list(read_libsvm([str(path)]))
    assert list(libsvm_feature_keys(parsed)) == list(ref_libsvm_feature_keys(parsed))
    assert list(libsvm_feature_keys(parsed))[:2] == ["2\t", "6\t"]


def _rank_mesh(shape, coords, axes=(DATA_AXIS,)):
    return ProcessMesh(tuple(shape), tuple(axes), 0, tuple(coords),
                       {a: None for a in axes}, None, torch.device("cpu"))


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_shard_batch_in_rank_terms(kind):
    """A rank's shard is its block of the padded rows, the reference's
    ``ensure_data_sharded`` layout; a shard passes ``ensure_data_sharded``
    unchanged; ``replicate`` places every tensor whole."""
    rng = np.random.default_rng(2)
    if kind == "dense":
        batch = make_dense_batch(rng.normal(size=(21, 4)), rng.uniform(size=21), device="cpu")
    else:
        rows = [([i % 5, 5 + i % 3], [1.0, -2.0]) for i in range(21)]
        batch = make_sparse_batch(rows, rng.uniform(size=21), device="cpu")
    padded = mesh.pad_batch_rows(batch, 3)
    n_loc = padded.labels.shape[0] // 3
    for index in range(3):
        m = _rank_mesh((3,), (index,))
        assert mesh.data_sharding(m) == mesh.Placement(torch.device("cpu"), DATA_AXIS, 3, index)
        shard = mesh.ensure_data_sharded(batch, m)
        assert mesh.ensure_data_sharded(shard, m) is shard
        for f, whole in zip(type(batch).__dataclass_fields__, (
                getattr(padded, f) for f in type(batch).__dataclass_fields__)):
            assert torch.equal(getattr(shard, f), whole[index * n_loc:(index + 1) * n_loc])
        if kind == "sparse":
            legacy = mesh.data_shard_sparse_batch(batch, 3, index)
            assert all(torch.equal(getattr(shard, f), getattr(legacy, f))
                       for f in type(batch).__dataclass_fields__)
    with pytest.raises(ValueError, match="do not divide the 5 shards"):
        mesh.shard_batch(batch, _rank_mesh((5,), (0,)))
    m = _rank_mesh((2,), (0,))
    assert mesh.replicated(m) == mesh.Placement(torch.device("cpu"), None, 1, 0)
    tree = {"a": batch, "b": [torch.ones(2)], "c": 3}
    placed = mesh.replicate(tree, m)
    assert placed["c"] == 3 and torch.equal(placed["b"][0], torch.ones(2))
    assert isinstance(placed["a"], DenseBatch if kind == "dense" else type(batch))


def _refusal(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_maybe_make_mesh_policy(monkeypatch):
    """One process: every mode gives None, as the reference's does for one
    device; an unknown mode and a model axis that does not divide the
    processes are refused in the reference's words."""
    from photon_ml_tpu_torch.parallel import multihost

    for mode in ("auto", "off", "feature"):
        assert mesh.maybe_make_mesh(mode) is None
    assert _refusal(mesh.maybe_make_mesh, "sideways") == _refusal(ref_mesh.maybe_make_mesh, "sideways")
    monkeypatch.setattr(multihost, "process_count", lambda: 8)
    assert mesh.maybe_make_mesh("off") is None
    assert _refusal(mesh.maybe_make_mesh, "feature", 3) == _refusal(
        ref_mesh.maybe_make_mesh, "feature", 3)
    made = []
    monkeypatch.setattr(mesh, "make_mesh", lambda *a, **k: made.append((a, k)) or "mesh")
    assert mesh.maybe_make_mesh("feature", 4) == "mesh"
    assert mesh.maybe_make_mesh("feature") == "mesh"
    assert mesh.maybe_make_mesh("auto") == "mesh"
    assert [a for a, _ in made] == [((2, 4), (DATA_AXIS, MODEL_AXIS)),
                                    ((4, 2), (DATA_AXIS, MODEL_AXIS)), ()]
