"""The port's model files against the JAX package's: writing the same
coefficients gives a byte-identical ``models.avro`` and identical text
models, and each package reads the other's file to the same coefficients
(bitwise: float32 values pass through Avro doubles exactly).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.io import model_io as ref_model_io
from photon_ml_tpu.models.coefficients import Coefficients as RefCoefficients
from photon_ml_tpu.models.glm import create_model as ref_create_model
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu.utils.index_map import IdentityIndexMap as RefIdentityIndexMap
from photon_ml_tpu.utils.index_map import IndexMap as RefIndexMap
from photon_ml_tpu_torch.io import model_io
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import create_model
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.index_map import IdentityIndexMap, IndexMap, feature_key

D = 17


def coefficient_sets(seed):
    """{lambda: (means, variances or None)} as float32 numpy."""
    rng = np.random.default_rng(seed)
    return {
        lam: (
            rng.normal(size=D).astype(np.float32),
            None if lam == 0.1 else rng.uniform(0.01, 1.0, size=D).astype(np.float32),
        )
        for lam in (10.0, 1.0, 0.1)
    }


def both_models(task_name, coefs):
    port = {
        lam: create_model(TaskType(task_name), Coefficients(
            torch.as_tensor(m), None if v is None else torch.as_tensor(v)))
        for lam, (m, v) in coefs.items()
    }
    ref = {
        lam: ref_create_model(RefTaskType(task_name), RefCoefficients(
            jnp.asarray(m), None if v is None else jnp.asarray(v)))
        for lam, (m, v) in coefs.items()
    }
    return port, ref


def index_maps(kind):
    if kind == "identity":
        return IdentityIndexMap(D - 1, add_intercept=True), RefIdentityIndexMap(
            D - 1, add_intercept=True)
    keys = [feature_key(f"f{i}", "t" if i % 3 else "") for i in range(D - 1)]
    return IndexMap.build(keys, add_intercept=True), RefIndexMap.build(
        keys, add_intercept=True)


@pytest.mark.parametrize("kind", ["vocabulary", "identity"])
@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION"])
def test_port_writes_the_reference_bytes(tmp_path, kind, task):
    port_map, ref_map = index_maps(kind)
    port, ref = both_models(task, coefficient_sets(1))
    model_io.save_glm_models_avro(port, str(tmp_path / "p" / "models.avro"), port_map)
    ref_model_io.save_glm_models_avro(ref, str(tmp_path / "r" / "models.avro"), ref_map)
    assert (tmp_path / "p" / "models.avro").read_bytes() == \
        (tmp_path / "r" / "models.avro").read_bytes()
    model_io.write_models_in_text(port, str(tmp_path / "p" / "text"), port_map)
    ref_model_io.write_models_in_text(ref, str(tmp_path / "r" / "text"), ref_map)
    for lam in port:
        assert (tmp_path / "p" / "text" / f"{lam}.txt").read_text() == \
            (tmp_path / "r" / "text" / f"{lam}.txt").read_text()


@pytest.mark.parametrize("kind", ["vocabulary", "identity"])
def test_each_reads_the_others_file(tmp_path, kind):
    port_map, ref_map = index_maps(kind)
    coefs = coefficient_sets(2)
    port, ref = both_models("LOGISTIC_REGRESSION", coefs)
    ref_model_io.save_glm_models_avro(ref, str(tmp_path / "ref.avro"), ref_map)
    model_io.save_glm_models_avro(port, str(tmp_path / "port.avro"), port_map)
    got = model_io.load_glm_models_avro(str(tmp_path / "ref.avro"), port_map, device="cpu")
    back = ref_model_io.load_glm_models_avro(str(tmp_path / "port.avro"), ref_map)
    assert sorted(got) == sorted(back) == sorted(str(lam) for lam in coefs)
    for lam, (means, variances) in coefs.items():
        m, r = got[str(lam)], back[str(lam)]
        assert m.task == TaskType.LOGISTIC_REGRESSION
        assert r.task == RefTaskType.LOGISTIC_REGRESSION
        np.testing.assert_array_equal(m.means.numpy(), means)
        np.testing.assert_array_equal(np.asarray(r.means), means)
        if variances is None:
            assert m.coefficients.variances is None and r.coefficients.variances is None
        else:
            np.testing.assert_array_equal(m.coefficients.variances.numpy(), variances)


def test_narrower_index_map_drops_unknown_keys(tmp_path):
    """Loading with a vocabulary that lacks some keys drops them (the
    reference's behavior), and an explicit task overrides the class."""
    _, ref_map = index_maps("vocabulary")
    _, ref = both_models("LOGISTIC_REGRESSION", coefficient_sets(3))
    ref_model_io.save_glm_models_avro(ref, str(tmp_path / "m.avro"), ref_map)
    keys = [feature_key(f"f{i}", "t" if i % 3 else "") for i in range(0, D - 1, 2)]
    narrow, ref_narrow = IndexMap.build(keys), RefIndexMap.build(keys)
    got = model_io.load_glm_models_avro(str(tmp_path / "m.avro"), narrow,
                                        task=TaskType.LINEAR_REGRESSION, device="cpu")
    want = ref_model_io.load_glm_models_avro(str(tmp_path / "m.avro"), ref_narrow,
                                             task=RefTaskType.LINEAR_REGRESSION)
    for lam in want:
        assert got[lam].task == TaskType.LINEAR_REGRESSION
        np.testing.assert_array_equal(got[lam].means.numpy(), np.asarray(want[lam].means))


def _python_codec_only(monkeypatch):
    """Make the model readers take the Python codec for every file."""
    from photon_ml_tpu_torch.io import native_avro

    monkeypatch.setattr(native_avro, "available", lambda: False)


def test_native_reader_matches_the_python_codec(tmp_path, monkeypatch):
    """``read_model_records`` through the native column decoder and through
    the Python codec give the same ids, classes, keys and doubles, and
    ``load_glm_models_avro`` the same models bitwise: a null or empty
    variance list reads as None, an unknown key is dropped and a repeated
    key keeps its last value."""
    from photon_ml_tpu_torch.io import native_avro, schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    if not native_avro.available():
        pytest.skip("the native Avro decoder does not build here (g++, zlib)")
    rng = np.random.default_rng(4)

    def ntvs(names):
        return [{"name": n, "term": t, "value": float(v)}
                for (n, t), v in zip(names, rng.normal(size=len(names)))]

    known = [(f"f{i}", "t" if i % 3 else "") for i in range(D - 1)]
    records = [
        {"modelId": "10.0", "modelClass": model_io._MODEL_CLASS_BY_TASK[
            TaskType.LOGISTIC_REGRESSION], "means": ntvs(known),
         "variances": ntvs(known), "lossFunction": None},
        {"modelId": "1.0", "modelClass": None,
         "means": ntvs(known[:5] + [("unknown", "x"), known[2]] + known[5:]),
         "variances": None, "lossFunction": None},
        {"modelId": "0.1", "modelClass": model_io._MODEL_CLASS_BY_TASK[
            TaskType.POISSON_REGRESSION], "means": [], "variances": [],
         "lossFunction": None},
    ]
    path = str(tmp_path / "m.avro")
    write_container(path, schemas.BAYESIAN_LINEAR_MODEL_AVRO, records)
    index_map, _ = index_maps("vocabulary")

    assert model_io._decoded_models(path) is not None  # the native decoder reads it
    native = list(model_io.read_model_records(path))
    models = model_io.load_glm_models_avro(path, index_map, device="cpu")
    _python_codec_only(monkeypatch)
    python = list(model_io.read_model_records(path))
    want = model_io.load_glm_models_avro(path, index_map, device="cpu")

    assert [r[:2] for r in native] == [r[:2] for r in python] == [
        ("10.0", records[0]["modelClass"]), ("1.0", None), ("0.1", records[2]["modelClass"])]
    for a, b in zip(native, python):
        for x, y in zip(a[2:], b[2:]):
            assert (x is None) == (y is None)
            if x is not None:
                assert x[0] == y[0]
                assert x[1].dtype == y[1].dtype == np.float64
                np.testing.assert_array_equal(x[1].view(np.int64), y[1].view(np.int64))
    assert native[1][3] is None and native[2][3] is None and native[2][2][0] == []
    assert sorted(models) == sorted(want) == ["0.1", "1.0", "10.0"]
    for lam, m in models.items():
        assert m.task == want[lam].task
        assert torch.equal(m.means.view(torch.int32), want[lam].means.view(torch.int32))
        v, w = m.coefficients.variances, want[lam].coefficients.variances
        assert (v is None) == (w is None)
        if v is not None:
            assert torch.equal(v.view(torch.int32), w.view(torch.int32))
    # the repeated key holds its last value, the unknown key is dropped
    last = records[1]["means"][6]
    i = index_map.get_index(feature_key(last["name"], last["term"]))
    assert float(models["1.0"].means[i]) == np.float32(last["value"])
