"""The port's input formats against the JAX package's: Avro (native column
decoder and pure-Python codec) and LibSVM (vocabulary scan and
``feature_dimension``), selected features, intercept on and off, and box
constraint strings. The batch arrays (indices, values, labels, offsets,
weights) must be bitwise equal, the index maps and the bounds equal.
"""

import json

import numpy as np
import pytest

from photon_ml_tpu.io import input_format as ref_input_format
from photon_ml_tpu.io import native_avro as ref_native
from photon_ml_tpu.io import schemas as ref_schemas
from photon_ml_tpu.io.avro_codec import write_container
from photon_ml_tpu_torch.io import input_format, native_avro
from tests.torch_parity import training_examples

BATCH_FIELDS = ("indices", "values", "labels", "offsets", "weights")


def assert_loaded_equal(port, ref):
    assert port.num_features == ref.num_features
    assert port.intercept_index == ref.intercept_index
    assert list(port.index_map.items()) == list(ref.index_map.items())
    for name in BATCH_FIELDS:
        got = getattr(port.batch, name).numpy()
        want = np.asarray(getattr(ref.batch, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (port.constraints is None) == (ref.constraints is None)
    if ref.constraints is not None:
        np.testing.assert_array_equal(port.constraints.lower.numpy(),
                                      np.asarray(ref.constraints.lower))
        np.testing.assert_array_equal(port.constraints.upper.numpy(),
                                      np.asarray(ref.constraints.upper))


@pytest.fixture(scope="module")
def avro_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("avro")
    write_container(str(d / "part-0.avro"), ref_schemas.TRAINING_EXAMPLE_AVRO,
                    training_examples(11, n=50))
    write_container(str(d / "part-1.avro"), ref_schemas.TRAINING_EXAMPLE_AVRO,
                    training_examples(12, n=30))
    (d / "_SUCCESS").write_text("")
    return str(d)


@pytest.fixture(scope="module")
def libsvm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("libsvm")
    rng = np.random.default_rng(13)
    for part in range(2):
        lines = []
        for _ in range(40):
            k = int(rng.integers(0, 5))
            ix = np.sort(rng.choice(np.arange(1, 16), size=k, replace=False))
            label = rng.choice(["-1", "+1", "0", "1"])
            lines.append(label + "".join(
                f" {i}:{v:.7g}" for i, v in zip(ix, rng.normal(size=k))
            ))
        lines.append("# comment")
        (d / f"part-{part}").write_text("\n".join(lines) + "\n")
    return str(d)


SELECTED = ["f1\tt", "f2\t", "f4\tt", "f5\t", "f7\tt", "f11\tt"]
CONSTRAINTS = [
    None,
    json.dumps([{"name": "f1", "term": "t", "lowerBound": -0.5, "upperBound": 0.5},
                {"name": "f2", "term": "", "upperBound": 2.0},
                {"name": "absent", "term": "", "lowerBound": 0.0}]),
    json.dumps([{"name": "*", "term": "", "lowerBound": -1.0, "upperBound": 1.0}]),
]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("selected", [None, SELECTED])
@pytest.mark.parametrize("constraint", range(len(CONSTRAINTS)))
def test_avro_load_equals_reference(avro_dir, monkeypatch, native, intercept,
                                    selected, constraint):
    if not native:  # both packages fall back to their pure-Python codec
        monkeypatch.setattr(native_avro, "available", lambda: False)
        monkeypatch.setattr(ref_native, "available", lambda: False)
    else:
        assert native_avro.available()
    kw = dict(add_intercept=intercept, selected_features=selected)
    port = input_format.create_input_format("AVRO", **kw).load(
        avro_dir, constraint_string=CONSTRAINTS[constraint], device="cpu"
    )
    ref = ref_input_format.create_input_format("AVRO", **kw).load(
        avro_dir, constraint_string=CONSTRAINTS[constraint]
    )
    assert_loaded_equal(port, ref)
    assert port.batch.num_rows == 80


@pytest.mark.parametrize("dimension", [None, 16])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("selected", [None, ["3\t", "5\t", "8\t", "14\t"]])
def test_libsvm_load_equals_reference(libsvm_dir, dimension, intercept, selected):
    kw = dict(add_intercept=intercept, selected_features=selected,
              feature_dimension=dimension)
    constraint = json.dumps([{"name": "3", "term": "", "lowerBound": -0.1}])
    port = input_format.create_input_format("LIBSVM", **kw).load(
        libsvm_dir, constraint_string=constraint, device="cpu"
    )
    ref = ref_input_format.create_input_format("LIBSVM", **kw).load(
        libsvm_dir, constraint_string=constraint
    )
    assert_loaded_equal(port, ref)
    # labels mapped to {0, 1}
    assert set(np.unique(port.batch.labels.numpy()[:80])) <= {0.0, 1.0}


def test_validation_data_loads_with_the_train_index_map(avro_dir, libsvm_dir):
    """The driver loads validation rows with the training vocabulary."""
    for kind, d in (("AVRO", avro_dir), ("LIBSVM", libsvm_dir)):
        train = input_format.create_input_format(kind).load(d, device="cpu")
        ref_train = ref_input_format.create_input_format(kind).load(d)
        port = input_format.create_input_format(kind).load(
            d, index_map=train.index_map, device="cpu")
        ref = ref_input_format.create_input_format(kind).load(
            d, index_map=ref_train.index_map)
        assert_loaded_equal(port, ref)


@pytest.mark.parametrize("entries", [
    [{"name": "*", "term": ""}, {"name": "f1", "term": "t"}],
    [{"name": "f1", "term": "t", "upperBound": 1.0},
     {"name": "f1", "term": "t", "upperBound": 2.0}],
    [{"name": "f1", "term": "t", "lowerBound": 2.0, "upperBound": 1.0}],
    [{"name": "f1"}],
])
def test_bad_constraints_raise_in_both(avro_dir, entries):
    s = json.dumps(entries)
    with pytest.raises(ValueError):
        input_format.create_input_format("AVRO").load(avro_dir, constraint_string=s,
                                                      device="cpu")
    with pytest.raises(ValueError):
        ref_input_format.create_input_format("AVRO").load(avro_dir, constraint_string=s)


def test_response_prediction_field_names(tmp_path):
    """RESPONSE_PREDICTION reads the response from ``response``."""
    schema = json.loads(json.dumps(ref_schemas.TRAINING_EXAMPLE_AVRO))
    schema["fields"][1]["name"] = "response"
    recs = training_examples(3, n=20)
    for r in recs:
        r["response"] = r.pop("label")
    write_container(str(tmp_path / "p.avro"), schema, recs)
    port = input_format.create_input_format(
        "AVRO", field_names="RESPONSE_PREDICTION").load(str(tmp_path), device="cpu")
    ref = ref_input_format.create_input_format(
        "AVRO", field_names="RESPONSE_PREDICTION").load(str(tmp_path))
    assert_loaded_equal(port, ref)
    with pytest.raises(ValueError):
        input_format.create_input_format("AVRO", field_names="OTHER")
    with pytest.raises(ValueError):
        input_format.create_input_format("CSV")
