"""The port's host I/O against the JAX package's: the Avro codec and its
container files, the native column decoder, the LibSVM parser, index maps
and dated input paths. Inputs are made with numpy from a seed; every
comparison here is exact (equal records, equal bytes, equal arrays).
"""

import datetime as dt
import os

import numpy as np
import pytest

from photon_ml_tpu.io import avro_codec as ref_avro
from photon_ml_tpu.io import libsvm as ref_libsvm
from photon_ml_tpu.io import native_avro as ref_native
from photon_ml_tpu.io import schemas as ref_schemas
from photon_ml_tpu.utils import date_range as ref_dates
from photon_ml_tpu.utils import index_map as ref_index_map
from photon_ml_tpu_torch.io import avro_codec, libsvm, native_avro, schemas
from photon_ml_tpu_torch.io.paths import expand_input_paths
from photon_ml_tpu_torch.utils import date_range
from photon_ml_tpu_torch.utils.index_map import IdentityIndexMap, IndexMap, feature_key

from tests.torch_parity import training_examples


def model_records(seed, d=20):
    rng = np.random.default_rng(seed)

    def ntv(values):
        return [
            {"name": f"f{i}", "term": "" if i % 2 else "x", "value": float(v)}
            for i, v in enumerate(values)
        ]

    return [
        {
            "modelId": str(lam),
            "modelClass": "com.linkedin.photon.ml.supervised.classification."
            "LogisticRegressionModel",
            "means": ntv(rng.normal(size=d).astype(np.float32)),
            "variances": None if lam == 0.1 else ntv(rng.uniform(size=d)),
            "lossFunction": None,
        }
        for lam in (10.0, 1.0, 0.1)
    ]


RECORDS = {
    "TRAINING_EXAMPLE": (schemas.TRAINING_EXAMPLE_AVRO, ref_schemas.TRAINING_EXAMPLE_AVRO,
                         training_examples),
    "BAYESIAN_LINEAR_MODEL": (schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                              ref_schemas.BAYESIAN_LINEAR_MODEL_AVRO, model_records),
}


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("kind", sorted(RECORDS))
def test_container_bytes_equal_reference(tmp_path, kind, codec):
    """Same records, same schema, same codec: the same bytes (the sync
    marker is derived from the schema in both packages)."""
    schema, ref_schema, make = RECORDS[kind]
    assert schema == ref_schema
    recs = make(3)
    # a small sync interval puts the records in several blocks
    n = avro_codec.write_container(
        str(tmp_path / "port.avro"), schema, recs, codec=codec, sync_interval=512
    )
    ref_n = ref_avro.write_container(
        str(tmp_path / "ref.avro"), ref_schema, recs, codec=codec, sync_interval=512
    )
    assert n == ref_n == len(recs)
    port_bytes = (tmp_path / "port.avro").read_bytes()
    assert port_bytes == (tmp_path / "ref.avro").read_bytes()


@pytest.mark.parametrize("kind", sorted(RECORDS))
def test_container_round_trips(tmp_path, kind):
    """What the port writes reads back equal in both packages, and what
    the reference writes reads back equal in the port."""
    schema, ref_schema, make = RECORDS[kind]
    recs = make(4)
    avro_codec.write_container(str(tmp_path / "port.avro"), schema, recs)
    ref_avro.write_container(str(tmp_path / "ref.avro"), ref_schema, recs)
    for path in ("port.avro", "ref.avro"):
        _, it = avro_codec.read_container(str(tmp_path / path))
        assert list(it) == recs
    _, it = ref_avro.read_container(str(tmp_path / "port.avro"))
    assert list(it) == recs
    parsed = avro_codec.read_container_schema(str(tmp_path / "port.avro"))
    assert parsed["name"] == schema["name"]
    assert list(avro_codec.read_avro_records(str(tmp_path))) == recs + recs


def test_datum_codec_round_trips_every_type():
    """Primitives, enum, fixed, union, array and map through the port's
    encoder and decoder, and the same bytes as the reference's encoder."""
    import io

    schema = {
        "type": "record", "name": "All", "fields": [
            {"name": "b", "type": "boolean"},
            {"name": "i", "type": "int"},
            {"name": "l", "type": "long"},
            {"name": "f", "type": "float"},
            {"name": "d", "type": "double"},
            {"name": "s", "type": "string"},
            {"name": "by", "type": "bytes"},
            {"name": "e", "type": {"type": "enum", "name": "E", "symbols": ["A", "B"]}},
            {"name": "fx", "type": {"type": "fixed", "name": "F", "size": 3}},
            {"name": "u", "type": ["null", "long", "string"]},
            {"name": "a", "type": {"type": "array", "items": "double"}},
            {"name": "m", "type": {"type": "map", "values": "long"}},
        ],
    }
    datum = {
        "b": True, "i": -7, "l": 2**40, "f": 0.5, "d": -1.25, "s": "héllo",
        "by": b"\x00\x01", "e": "B", "fx": b"abc", "u": "x", "a": [1.0, 2.5],
        "m": {"k": -3},
    }
    out, ref_out = io.BytesIO(), io.BytesIO()
    avro_codec.write_datum(avro_codec.BinaryEncoder(out), avro_codec.parse_schema(
        dict(schema)), datum)
    ref_avro.write_datum(ref_avro.BinaryEncoder(ref_out), ref_avro.parse_schema(
        dict(schema)), datum)
    assert out.getvalue() == ref_out.getvalue()
    back = avro_codec.read_datum(
        avro_codec.BinaryDecoder(out.getvalue()), avro_codec.parse_schema(dict(schema))
    )
    assert back == datum


def test_native_decode_columns_equal_reference(tmp_path):
    """The port's ctypes binding over native/avro_reader.cpp (built into the
    port's build directory) decodes the same columns as the reference's."""
    path = str(tmp_path / "part-0.avro")
    ref_avro.write_container(path, ref_schemas.TRAINING_EXAMPLE_AVRO, training_examples(5))
    plan_kw = dict(
        numeric_fields=["label", "offset", "weight"], string_fields=["uid"],
        bag_fields=["features"], map_field="metadataMap", map_keys=["k"],
    )
    port = native_avro.decode_columns(path, native_avro.plan_for_file(path, **plan_kw))
    ref = ref_native.decode_columns(path, ref_native.plan_for_file(path, **plan_kw))
    assert port.num_records == ref.num_records == 60
    assert port.strings == ref.strings
    for field in ("label", "offset", "weight"):
        np.testing.assert_array_equal(port.f64(field), ref.f64(field))
    np.testing.assert_array_equal(port.str_ids("uid"), ref.str_ids("uid"))
    np.testing.assert_array_equal(port.map_ids("k"), ref.map_ids("k"))
    for a, b in zip(port.bag("features"), ref.bag("features")):
        np.testing.assert_array_equal(a, b)
    port.close()
    ref.close()


LIBSVM_LINES = [
    "+1 1:0.5 3:-2 7:1e-3",
    "-1 2:1.5",
    "0 4:2 5:3 # trailing comment",
    "1 1:1",
    "   ",
    "# a comment line",
    "-1",
]


@pytest.mark.parametrize("zero_based", [False, True])
def test_libsvm_parsing_equals_reference(tmp_path, zero_based):
    """±1 and 0/1 labels, comments, blank lines, rows without features,
    one- and zero-based indices."""
    for line in LIBSVM_LINES:
        assert libsvm.parse_libsvm_line(line, zero_based=zero_based) == \
            ref_libsvm.parse_libsvm_line(line, zero_based=zero_based)
    d = tmp_path / "data"
    d.mkdir()
    (d / "part-0").write_text("\n".join(LIBSVM_LINES[:4]) + "\n")
    (d / "part-1").write_text("\n".join(LIBSVM_LINES[4:]) + "\n")
    (d / "_SUCCESS").write_text("")
    (d / ".hidden").write_text("1 1:1\n")
    rows = list(libsvm.read_libsvm(str(d), zero_based=zero_based))
    assert rows == list(ref_libsvm.read_libsvm(str(d), zero_based=zero_based))
    assert len(rows) == 5


def test_expand_input_paths_skips_hidden_and_markers(tmp_path):
    for name in ("b.avro", "a.avro", "_SUCCESS", ".crc", "c.txt"):
        (tmp_path / name).write_text("")
    from photon_ml_tpu.io.paths import expand_input_paths as ref_expand

    for pred in (None, lambda fn: fn.endswith(".avro")):
        assert expand_input_paths(str(tmp_path), pred) == ref_expand(str(tmp_path), pred)
    assert [os.path.basename(p) for p in expand_input_paths(str(tmp_path))] == [
        "a.avro", "b.avro", "c.txt",
    ]


def test_index_map_json_equals_reference(tmp_path):
    """IndexMap.build (sorted keys, the intercept last) saves the same
    JSON bytes as the reference's; so does the identity map's descriptor;
    both load back in either package."""
    rng = np.random.default_rng(7)
    keys = [feature_key(f"f{i}", "t" if i % 2 else "") for i in rng.integers(0, 50, 200)]
    for intercept in (False, True):
        port = IndexMap.build(keys, add_intercept=intercept)
        ref = ref_index_map.IndexMap.build(keys, add_intercept=intercept)
        port.save(str(tmp_path / "port.json"))
        ref.save(str(tmp_path / "ref.json"))
        assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
        back = IndexMap.load(str(tmp_path / "ref.json"))
        assert dict(back.items()) == dict(ref.items())
        assert [back.get_feature_name(i) for i in range(back.size)] == [
            ref.get_feature_name(i) for i in range(ref.size)
        ]
        ident = IdentityIndexMap(40, add_intercept=intercept)
        ident.save(str(tmp_path / "port_id.json"))
        ref_index_map.IdentityIndexMap(40, add_intercept=intercept).save(
            str(tmp_path / "ref_id.json")
        )
        assert (tmp_path / "port_id.json").read_bytes() == \
            (tmp_path / "ref_id.json").read_bytes()
        loaded = IndexMap.load(str(tmp_path / "ref_id.json"))
        assert list(loaded.items()) == list(
            ref_index_map.IdentityIndexMap(40, add_intercept=intercept).items()
        )
        assert loaded.get_index("39\t") == 39 and loaded.get_index("40\t") == -1


def test_dated_paths_equal_reference(tmp_path):
    for day in (dt.date(2024, 1, 30), dt.date(2024, 2, 1), dt.date(2024, 2, 2)):
        os.makedirs(date_range.daily_path(str(tmp_path), day))
    rng = date_range.resolve_date_range("20240130-20240202", None)
    ref_rng = ref_dates.resolve_date_range("20240130-20240202", None)
    assert str(rng) == str(ref_rng)
    assert date_range.input_paths_within_date_range(str(tmp_path), rng) == \
        ref_dates.input_paths_within_date_range(str(tmp_path), ref_rng)
    now = dt.date(2024, 2, 3)
    assert str(date_range.resolve_date_range(None, "4-1", now=now)) == str(
        ref_dates.resolve_date_range(None, "4-1", now=now)
    )
    for bad in (("20240202-20240130", None), ("x", None), ("1", "2-1")):
        with pytest.raises(ValueError):
            date_range.resolve_date_range(*bad)
        with pytest.raises(ValueError):
            ref_dates.resolve_date_range(*bad)
