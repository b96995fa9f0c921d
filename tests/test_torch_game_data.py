"""The port's GAME datasets against the JAX package's: the same records give
bit-equal row tables, entity codes, buckets, projections and reservoir
draws (``game/data.py``, ``game/random_effect_data.py``), and the config
strings parse to equal fields (``game/config.py`` and the driver's
per-coordinate DSL)."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import game_example_schema
from photon_ml_tpu.cli import game_training_driver as ref_driver
from photon_ml_tpu.game import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game import build_game_dataset_from_files as ref_from_files
from photon_ml_tpu.game import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.game.config import MFOptimizationConfiguration as RefMF
from photon_ml_tpu.game.config import ProjectorType as RefProjector
from photon_ml_tpu.game.data import slice_game_dataset as ref_slice
from photon_ml_tpu.io.avro_codec import write_container
from photon_ml_tpu_torch.cli import game_training_driver as port_driver
from photon_ml_tpu_torch.game import (
    ProjectorType,
    RandomEffectDataConfiguration,
    build_game_dataset_from_files,
    build_random_effect_dataset,
    slice_game_dataset,
)
from photon_ml_tpu_torch.game.config import MFOptimizationConfiguration
from torch_game_cases import both_datasets, make_records, shards


def assert_same_dataset(port, ref):
    assert port.uids == ref.uids
    assert port.num_real_rows == ref.num_real_rows
    for f in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert port.shards.keys() == ref.shards.keys()
    for sid, sd in ref.shards.items():
        np.testing.assert_array_equal(port.shards[sid].indices, sd.indices)
        np.testing.assert_array_equal(port.shards[sid].values, sd.values)
        assert port.shards[sid].intercept_index == sd.intercept_index
        assert dict(port.shards[sid].index_map.items()) == dict(sd.index_map.items())
    for t, codes in ref.entity_codes.items():
        np.testing.assert_array_equal(port.entity_codes[t], codes)
        assert port.entity_indexes[t].ids == ref.entity_indexes[t].ids


def test_build_game_dataset_is_bit_equal():
    recs = make_records(0, n=150, n_users=9, n_items=5)
    ref, port = both_datasets(recs, ("userId", "itemId"))
    assert_same_dataset(port, ref)
    assert port.device == torch.device("cpu")
    batch = port.batch_for_shard("userShard")
    np.testing.assert_array_equal(batch.indices.numpy(), ref.shards["userShard"].indices)
    # the batch shares the dataset's uploaded tensors from call to call
    again = port.batch_for_shard("userShard", offsets=np.ones(port.num_rows, np.float32))
    assert again.indices is batch.indices and again.weights is batch.weights
    assert torch.all(again.offsets == 1.0)


@pytest.mark.parametrize("start,stop", [(0, 40), (17, 150), (100, 400)])
def test_slice_game_dataset(start, stop):
    ref, port = both_datasets(make_records(1, n=150))
    assert_same_dataset(slice_game_dataset(port, start, stop), ref_slice(ref, start, stop))


@pytest.mark.parametrize("native", [True, False])
def test_build_from_files_is_bit_equal(tmp_path, native, monkeypatch):
    """Avro files through the native column decoder, and through the
    record-at-a-time fallback, give the reference's arrays."""
    recs = make_records(2, n=120, n_users=6)
    for r in recs:
        r["metadataMap"] = {"userId": r.pop("userId")}
    write_container(str(tmp_path / "p0.avro"), game_example_schema(), recs[:70])
    write_container(str(tmp_path / "p1.avro"), game_example_schema(), recs[70:])
    if not native:
        from photon_ml_tpu.io import native_avro as ref_native
        from photon_ml_tpu_torch.io import native_avro as port_native

        monkeypatch.setattr(ref_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    ref = ref_from_files([str(tmp_path)], shards("ref"), ["userId"])
    port = build_game_dataset_from_files(
        [str(tmp_path)], shards("port"), ["userId"], device="cpu"
    )
    assert_same_dataset(port, ref)


RE_CONFIGS = {
    "plain": dict(),
    "reservoir": dict(active_data_upper_bound=8),
    "reservoir_pearson": dict(active_data_upper_bound=10, features_to_samples_ratio=0.3),
    "pearson": dict(features_to_samples_ratio=0.5),
    "passive": dict(active_data_upper_bound=12, passive_data_lower_bound=2),
    "random": dict(projector_type="RANDOM", random_projection_dim=3),
    "identity": dict(projector_type="IDENTITY"),
}


@pytest.mark.parametrize("name", sorted(RE_CONFIGS))
def test_random_effect_dataset_is_bit_equal(name):
    """Buckets, projections, row views, the reservoir's draws with their
    rescaled weights, the Pearson filter and the random projection, for
    the same seed."""
    kw = dict(RE_CONFIGS[name])
    ptype = kw.pop("projector_type", "INDEX_MAP")
    recs = make_records(3, n=260, n_users=7)
    ref_ds, port_ds = both_datasets(recs)
    ref = ref_build_re(
        ref_ds, RefREConfig("userId", "userShard", projector_type=RefProjector(ptype), **kw),
        seed=11,
    )
    port = build_random_effect_dataset(
        port_ds,
        RandomEffectDataConfiguration(
            "userId", "userShard", projector_type=ProjectorType(ptype), **kw
        ),
        seed=11,
    )
    for f in ("num_entities", "local_dim", "num_active_rows", "num_passive_rows",
              "intercept_local_index"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("projection", "row_local_indices", "row_local_values", "row_entity_codes"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    if ref.random_projection is None:
        assert port.random_projection is None
    else:
        np.testing.assert_array_equal(port.random_projection, ref.random_projection)
    assert len(port.buckets) == len(ref.buckets)
    for pb, rb in zip(port.buckets, ref.buckets):
        for f in dataclasses.fields(rb):
            np.testing.assert_array_equal(
                getattr(pb, f.name), getattr(rb, f.name), err_msg=f.name
            )
    if "reservoir" in name:
        assert port.num_passive_rows > 0


RE_STRINGS = [
    "userId,userShard,4,none,none,none,INDEX_MAP",
    "userId,userShard,1,32,2,0.5,INDEX_MAP",
    "itemId,itemShard,1,none,none,inf,IDENTITY",
    "userId,userShard,1,16.0,none,none,RANDOM=8",
]


@pytest.mark.parametrize("s", RE_STRINGS)
def test_random_effect_config_strings_parse_alike(s):
    ref, port = RefREConfig.parse(s), RandomEffectDataConfiguration.parse(s)
    assert dataclasses.asdict(port) | {"projector_type": port.projector_type.value} == (
        dataclasses.asdict(ref) | {"projector_type": ref.projector_type.value}
    )


@pytest.mark.parametrize("s", ["a,b,c", "userId,userShard,1,none,none,none,RANDOM"])
def test_bad_random_effect_config_strings_raise_alike(s):
    with pytest.raises(ValueError):
        RefREConfig.parse(s)
    with pytest.raises(ValueError):
        RandomEffectDataConfiguration.parse(s)


def test_mf_config_parses_alike():
    assert dataclasses.asdict(MFOptimizationConfiguration.parse("7,3")) == dataclasses.asdict(
        RefMF.parse("7,3")
    )


def test_driver_dsl_parses_alike():
    """The reference's own cases (``tests/test_game_drivers.py::
    TestConfigParsing``) through both drivers' parsers."""
    for mod in (ref_driver, port_driver):
        assert mod.parse_keyed_map("a:1,2|b:3,4") == {"a": "1,2", "b": "3,4"}
    for r, p in zip(
        ref_driver.parse_shard_map("global:features|user:userFeatures,extra"),
        port_driver.parse_shard_map("global:features|user:userFeatures,extra"),
    ):
        assert (p.shard_id, list(p.feature_bags), p.add_intercept) == (
            r.shard_id, list(r.feature_bags), r.add_intercept
        )
    grid = {
        "a": "10,1e-4,1.0,1,LBFGS,L2;10,1e-4,10.0,1,LBFGS,L2",
        "b": "5,1e-4,0.5,1,LBFGS,L2",
    }
    ref_combos = ref_driver.expand_config_grid(grid)
    port_combos = port_driver.expand_config_grid(grid)
    assert len(port_combos) == len(ref_combos) == 2
    for rc, pc in zip(ref_combos, port_combos):
        for name in rc:
            assert pc[name].render() == rc[name].render()
    flags = "globalShard:false|userShard"
    for r, p in zip(
        ref_driver.apply_intercept_map(shards("ref"), flags),
        port_driver.apply_intercept_map(shards("port"), flags),
    ):
        assert (p.shard_id, p.add_intercept) == (r.shard_id, r.add_intercept)
    with pytest.raises(ValueError):
        port_driver.apply_intercept_map(shards("port"), "globalShard:ture")
