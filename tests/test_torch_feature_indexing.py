"""The port's off-heap index stores (``utils/native_index.py`` over
``native/index_store.cpp``), name-and-term lists (``io/name_term_list.py``)
and the feature-indexing driver (``cli/feature_indexing_driver.py``)
against the JAX package's.

Keys are made with numpy from a seed (names with terms, unicode, a key
longer than the lookup buffer). A store built by either package is
byte-identical to the other's and opens in the other with the same
lookups both ways; the pointer that ``PartitionedIndexMap.save`` writes
reopens through ``IndexMap.load`` in both packages; the driver builds the
same stores from Avro feature bags and from LibSVM; the name-term lists
read, write and index as the reference's.
"""

import os

import numpy as np
import pytest

from photon_ml_tpu.cli import feature_indexing_driver as ref_fid
from photon_ml_tpu.io import name_term_list as ref_ntl
from photon_ml_tpu.utils import index_map as ref_index_map
from photon_ml_tpu.utils import native_index as ref_native
from photon_ml_tpu_torch.cli import feature_indexing_driver as fid
from photon_ml_tpu_torch.io import name_term_list as ntl
from photon_ml_tpu_torch.utils import native_index
from photon_ml_tpu_torch.utils.device import build_dir
from photon_ml_tpu_torch.utils.index_map import IndexMap, feature_key, intercept_key
from tests.test_glm_driver import synth_avro
from tests.test_torch_glm_driver import synth_libsvm


def _keys(seed, n=300):
    rng = np.random.default_rng(seed)
    keys = {feature_key(f"f{i}", "t" if i % 3 else "") for i in rng.integers(0, 10 * n, n)}
    keys |= {feature_key("é名", "∂"), feature_key("long" * 2000, "x"), intercept_key()}
    return sorted(keys)


def _files(directory):
    return {f: open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))}


@pytest.mark.parametrize("partitions", [1, 3, 11])
def test_store_matches_reference_both_ways(tmp_path, partitions):
    keys = _keys(partitions)
    pm = native_index.build_partitioned_index(keys, str(tmp_path / "port"), partitions)
    ref_pm = ref_native.build_partitioned_index(keys, str(tmp_path / "ref"), partitions)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")  # byte-identical
    assert pm.size == ref_pm.size == len(keys)
    for key in keys:
        i = pm.get_index(key)
        assert i == ref_pm.get_index(key) and 0 <= i < len(keys)
        assert pm.get_feature_name(i) == key
        assert key in pm
    assert sorted(i for _, i in pm.items()) == list(range(len(keys)))
    assert dict(pm.items()) == dict(ref_pm.items())
    assert pm.get_index("absent\t") == -1 and pm.get_index("absent\t", 7) == 7
    assert pm.get_feature_name(len(keys)) is None
    # each package opens the other's store
    for opener, d in ((native_index.PartitionedIndexMap, tmp_path / "ref"),
                      (ref_native.PartitionedIndexMap, tmp_path / "port")):
        other = opener(str(d))
        assert [other.get_index(k) for k in keys] == [pm.get_index(k) for k in keys]
        other.close()
    lookups = native_index.NativeIndexStore(
        str(tmp_path / "port" / "index-partition-0.pidx"))
    part0 = [k for k in keys if pm._partition_of(k) == 0]
    assert lookups.get_indices(part0).tolist() == [lookups.get_index(k) for k in part0]
    lookups.close()
    pm.close()
    ref_pm.close()


def test_the_library_builds_into_the_port_build_dir():
    native_index._lib()
    assert os.path.isfile(os.path.join(build_dir(), "libindex_store.so"))


def test_duplicate_keys_raise(tmp_path):
    with pytest.raises(ValueError, match="duplicate"):
        native_index.build_store(str(tmp_path / "s.pidx"), ["a", "a"])


def test_pointer_round_trip_in_both_packages(tmp_path):
    keys = _keys(4)
    pm = native_index.build_partitioned_index(keys, str(tmp_path / "store"), 2)
    pointer = tmp_path / "out" / "feature-index" / "index.json"
    pm.save(str(pointer))
    want = [pm.get_index(k) for k in keys]
    for load in (IndexMap.load, ref_index_map.IndexMap.load):
        back = load(str(pointer))
        assert back.size == len(keys)
        assert [back.get_index(k) for k in keys] == want
        back.close()
    pm.close()
    # the store and the output tree moved together: found by the relative path
    (tmp_path / "moved").mkdir()
    os.rename(tmp_path / "store", tmp_path / "moved" / "store")
    os.rename(tmp_path / "out", tmp_path / "moved" / "out")
    moved = IndexMap.load(str(tmp_path / "moved" / "out" / "feature-index" / "index.json"))
    assert moved.directory == os.path.join(
        str(tmp_path / "moved" / "out" / "feature-index"), os.pardir, os.pardir, "store")
    assert [moved.get_index(k) for k in keys] == want
    moved.close()


def test_load_offheap_index_map_rules(tmp_path):
    keys = _keys(5)
    for shard in ("global", "other"):
        native_index.build_partitioned_index(keys, str(tmp_path / "two" / shard), 2).close()
    native_index.build_partitioned_index(keys, str(tmp_path / "one" / "global"), 2).close()
    pm = native_index.load_offheap_index_map(str(tmp_path / "one"))  # one shard dir
    assert pm.size == len(keys)
    pm.close()
    with pytest.raises(OSError, match="exactly one"):
        native_index.load_offheap_index_map(str(tmp_path / "two"))
    with pytest.raises(ValueError, match="partitions"):
        native_index.load_offheap_index_map(str(tmp_path / "one"), num_partitions=3)
    maps = native_index.load_offheap_index_maps(str(tmp_path / "two"), ["global", "other"])
    assert sorted(maps) == ["global", "other"]
    for m in maps.values():
        m.close()
    with pytest.raises(OSError, match="shard"):
        native_index.load_offheap_index_map(str(tmp_path / "two"), shard_name="absent")


@pytest.mark.parametrize("fmt", ["AVRO", "LIBSVM"])
def test_driver_builds_the_reference_store(tmp_path, fmt):
    rng = np.random.default_rng(9)
    data = tmp_path / "data"
    data.mkdir()
    if fmt == "AVRO":
        synth_avro(str(data / "part-0.avro"), rng, n=120)
    else:
        synth_libsvm(str(data / "part-0.txt"), rng, n=120)
    argv = ["--input-paths", str(data), "--format", fmt, "--num-partitions", "2"]
    fid.main(argv + ["--output-dir", str(tmp_path / "port")])
    ref_fid.main(argv + ["--output-dir", str(tmp_path / "ref")])
    assert _files(tmp_path / "port" / "global") == _files(tmp_path / "ref" / "global")
    pm = native_index.load_offheap_index_map(str(tmp_path / "port"))
    assert intercept_key() in pm
    no_icept = fid.run_feature_indexing(
        [str(data)], str(tmp_path / "bare"), data_format=fmt, add_intercept=False,
        shard_name="s",
    )
    bare = native_index.PartitionedIndexMap(no_icept)
    assert intercept_key() not in bare and bare.size == pm.size - 1
    bare.close()
    pm.close()


def test_name_term_lists_match_reference(tmp_path):
    rng = np.random.default_rng(13)
    data = tmp_path / "data"
    data.mkdir()
    synth_avro(str(data / "part-0.avro"), rng, n=80)
    sets = ntl.generate_name_and_term_lists([str(data)], ["features"], str(tmp_path / "port"))
    ref_sets = ref_ntl.generate_name_and_term_lists(
        [str(data)], ["features"], str(tmp_path / "ref"))
    assert sets == ref_sets and sets["features"]
    assert _files(tmp_path / "port" / "features") == _files(tmp_path / "ref" / "features")
    read = ntl.read_name_and_term_feature_sets(str(tmp_path / "ref"), ["features"])
    assert read == ref_sets
    (tmp_path / "extra").mkdir()
    (tmp_path / "extra" / "part-0").write_text("solo\nname\tterm\n\n")
    assert ntl.read_name_and_term_set(str(tmp_path / "extra")) == \
        ref_ntl.read_name_and_term_set(str(tmp_path / "extra"))
    for add_intercept in (True, False):
        got = ntl.index_map_from_sections(read, ["features"], add_intercept=add_intercept)
        want = ref_ntl.index_map_from_sections(read, ["features"], add_intercept=add_intercept)
        assert dict(got.items()) == dict(want.items())
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "part-0").write_text("a\tb\tc\n")
    with pytest.raises(ValueError, match="name<TAB>term"):
        ntl.read_name_and_term_set(str(tmp_path / "bad"))
    with pytest.raises(OSError, match="section"):
        ntl.read_name_and_term_feature_sets(str(tmp_path / "port"), ["absent"])
