"""The schedule cache's roles across processes (``ops/schedule_cache.py``:
``configure``, ``is_cache_writer``, ``wait_and_load``, ``ScheduleLRU``;
their wiring in ``ops/tiled_sparse.py``) and ``ensure_tiled_sharded``.

The rule held: every key is stored by exactly one process; a process waits
only for a key that another process also builds; a waiter that times out
builds locally and stores nothing; a warm rerun builds nothing anywhere.
Ranks are ``spawn_mesh`` gloo processes on the CPU sharing one cache
directory (rank functions in ``tests/torch_surface_cases.py``). Schedules
and K1's passes (their plain versions here) are compared bitwise; the LRU
and the refusal message against the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import schedule_cache as ref_cache
from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops import tiled_sparse as ts
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh, spawn_mesh
from tests.torch_parity import random_rows
from tests.torch_surface_cases import CACHE_PARAMS, cell_rank, same_key_rank, schedule_arrays

D = 150


@pytest.fixture
def fresh_stats():
    schedule_cache.reset_stats()
    yield
    schedule_cache.reset_stats()


def _rows(seed=0):
    return random_rows(np.random.default_rng(seed), n=120, d=D, k=8)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_environment_and_configure(monkeypatch, tmp_path):
    """Process 0 writes; ``PHOTON_TILE_CACHE_WRITER`` forces the role as the
    reference reads it; ``builders`` names the writer; the wait deadline
    comes from ``PHOTON_TILE_CACHE_WAIT_S``; ``configure`` sits between the
    scope and the env var, ``""`` turning the cache off."""
    assert schedule_cache.ENV_WRITER == ref_cache.ENV_WRITER
    assert schedule_cache.ENV_WAIT_S == ref_cache.ENV_WAIT_S
    monkeypatch.delenv(schedule_cache.ENV_WRITER, raising=False)
    assert schedule_cache.is_cache_writer()
    assert schedule_cache.is_cache_writer((0, 3)) and not schedule_cache.is_cache_writer((1, 2))
    for value, role in (("0", False), ("false", False), ("no", False), ("", False),
                        ("1", True), ("yes", True)):
        monkeypatch.setenv(schedule_cache.ENV_WRITER, value)
        assert schedule_cache.is_cache_writer() is role is ref_cache.is_cache_writer()
        assert schedule_cache.is_cache_writer((0,)) is role
    for value, deadline in (("2.5", 2.5), ("soon", 300.0)):
        monkeypatch.setenv(schedule_cache.ENV_WAIT_S, value)
        assert schedule_cache._wait_deadline_s() == deadline == ref_cache._wait_deadline_s()
    monkeypatch.delenv(schedule_cache.ENV_WAIT_S)
    assert schedule_cache._wait_deadline_s() == 300.0

    monkeypatch.setenv(schedule_cache.ENV_CACHE_DIR, str(tmp_path / "env"))
    try:
        assert schedule_cache.resolve_cache_dir() == str(tmp_path / "env")
        schedule_cache.configure(str(tmp_path / "conf"))
        assert schedule_cache.resolve_cache_dir() == str(tmp_path / "conf")
        with schedule_cache.cache_scope(str(tmp_path / "scope")):
            assert schedule_cache.resolve_cache_dir() == str(tmp_path / "scope")
        schedule_cache.configure("")
        assert schedule_cache.resolve_cache_dir() is None
    finally:
        schedule_cache.configure(None)
    assert schedule_cache.resolve_cache_dir() == str(tmp_path / "env")


def test_timed_out_waiter_builds_and_stores_nothing(monkeypatch, tmp_path, fresh_stats):
    """A forced non-writer with no writer anywhere waits out
    ``PHOTON_TILE_CACHE_WAIT_S``, builds locally and stores nothing: the
    schedules are the writer's, bitwise."""
    rows, labels = _rows()
    batch = make_sparse_batch(rows, labels, device="cpu")
    params = ts.TileParams(**CACHE_PARAMS)
    want = ts.tiled_batch_from_sparse(batch, D, params=params, device="cpu")
    schedule_cache.reset_stats()
    monkeypatch.setenv(schedule_cache.ENV_WRITER, "0")
    monkeypatch.setenv(schedule_cache.ENV_WAIT_S, "0.3")
    with schedule_cache.cache_scope(str(tmp_path)):
        got = ts.tiled_batch_from_sparse(batch, D, params=params, device="cpu")
    st = schedule_cache.stats()
    assert (st.builds, st.stores, st.hits) == (2, 0, 0)
    assert st.wait_s >= 0.3  # both passes waited, on two threads
    assert not os.path.isdir(tmp_path / f"v{schedule_cache.SCHEDULE_CACHE_VERSION}") or not [
        d for d in os.listdir(tmp_path / f"v{schedule_cache.SCHEDULE_CACHE_VERSION}")
        if not d.endswith(".tmp")
    ]
    _same(schedule_arrays(got), schedule_arrays(want))


def test_wait_and_load_finds_a_later_store(tmp_path, fresh_stats):
    """The waiter loads the artifact once the writer's atomic rename lands."""
    import threading

    arrays = [np.arange(i + 3, dtype=np.int32) for i in range(len(schedule_cache.SCHEDULE_ARRAY_NAMES))]
    timer = threading.Timer(0.2, schedule_cache.store_schedule, (str(tmp_path), "k", arrays))
    timer.start()
    got = schedule_cache.wait_and_load(str(tmp_path), "k", timeout_s=30)
    timer.join()
    _same(got, arrays)
    assert schedule_cache.stats().wait_s > 0.1
    assert schedule_cache.wait_and_load(str(tmp_path), "missing", timeout_s=0.1) is None


def _stats(run):
    return run["stats"]


def test_two_processes_one_key(tmp_path):
    """Two ranks tile the same whole batch: every key is stored once, by
    process 0; process 1 waits, loads and builds nothing, and its schedules
    and passes are process 0's bits; the warm rerun builds nothing on
    either."""
    rows, labels = _rows(1)
    r0, r1 = spawn_mesh(same_key_rank, (2,), device="cpu", args=(rows, labels, D, str(tmp_path)))
    cold0, cold1 = _stats(r0[0]), _stats(r1[0])
    assert (cold0["builds"], cold0["stores"], cold0["wait_s"]) == (2, 2, 0.0)
    assert (cold1["builds"], cold1["stores"], cold1["hits"]) == (0, 0, 2)
    assert cold1["wait_s"] > 0
    assert r1[0]["builder"] == "cache"
    for warm in (_stats(r0[1]), _stats(r1[1])):
        assert (warm["builds"], warm["stores"], warm["hits"], warm["misses"]) == (0, 0, 2, 0)
    _same(r0[0]["arrays"], r1[0]["arrays"])
    _same(r0[1]["arrays"], r0[0]["arrays"])
    _same(r0[1]["passes"], r1[1]["passes"])
    stored = os.listdir(tmp_path / f"v{schedule_cache.SCHEDULE_CACHE_VERSION}")
    assert len(stored) == 2 and not [d for d in stored if d.endswith(".tmp")]


@pytest.mark.parametrize("replicas", [False, True])
def test_cells_and_replicas(tmp_path, replicas):
    """A 1 x 2 (data, model) mesh: two cells, each its own rank's key,
    stored by that rank with no wait. Two 1 x 1 replica blocks holding the
    same cell: the lowest rank stores it, the other waits and loads it.
    Warm: no builds anywhere."""
    rows, labels = _rows(2)
    shape = (2,) if replicas else (1, 2)
    axes = (DATA_AXIS,) if replicas else (DATA_AXIS, MODEL_AXIS)
    ranks = spawn_mesh(cell_rank, shape, axes, device="cpu",
                       args=(rows, labels, D, str(tmp_path), replicas))
    builders = [r["builders"] for r in ranks]
    assert builders == ([(0, 1), (0, 1)] if replicas else [(0,), (1,)])
    colds = [_stats(r["runs"][0]) for r in ranks]
    if replicas:
        assert (colds[0]["builds"], colds[0]["stores"], colds[0]["wait_s"]) == (2, 2, 0.0)
        assert (colds[1]["builds"], colds[1]["stores"]) == (0, 0) and colds[1]["wait_s"] > 0
        _same(ranks[0]["runs"][0]["arrays"], ranks[1]["runs"][0]["arrays"])
    else:
        for cold in colds:
            assert (cold["builds"], cold["stores"], cold["wait_s"]) == (2, 2, 0.0)
    for r in ranks:
        warm = _stats(r["runs"][1])
        assert (warm["builds"], warm["stores"], warm["hits"]) == (0, 0, 2)
        _same(r["runs"][1]["arrays"], r["runs"][0]["arrays"])
    stored = os.listdir(tmp_path / f"v{schedule_cache.SCHEDULE_CACHE_VERSION}")
    assert len(stored) == (2 if replicas else 4)


def test_lru_matches_the_reference():
    """The same operations give the same keys, in the same recency order."""
    ours, ref = schedule_cache.ScheduleLRU(3), ref_cache.ScheduleLRU(3)
    for op, key in (("put", "a"), ("put", "b"), ("put", "c"), ("get", "a"), ("put", "d"),
                    ("get", "b"), ("put", "c"), ("pop", "a"), ("put", "e"), ("put", "f"),
                    ("get", "zz"), ("pop", "zz")):
        for lru in (ours, ref):
            getattr(lru, op)(*((key, key.upper()) if op == "put" else (key,)))
        assert ours.keys() == ref.keys() and len(ours) == len(ref)
        assert ours.get(key) == ref.get(key)
    ours.clear()
    assert len(ours) == 0
    with pytest.raises(ValueError, match="maxsize must be >= 1"):
        schedule_cache.ScheduleLRU(0)


def _mesh(shape, coords, axes=(DATA_AXIS,)):
    return ProcessMesh(tuple(shape), tuple(axes), 0, tuple(coords),
                       {a: None for a in axes}, None, torch.device("cpu"))


def test_ensure_tiled_sharded(fresh_stats):
    """A SparseBatch -> this rank's shard of the data-parallel layout; the
    same tensors again reuse its schedules with their own row metadata; a
    tiled batch of the same layout passes through, one of another shard
    count is refused in the reference's words."""
    from photon_ml_tpu.data.batch import make_sparse_batch as ref_make
    from photon_ml_tpu.ops.tiled_sparse import build_sharded_tiled_batch as ref_build
    from photon_ml_tpu.ops.tiled_sparse import ensure_tiled_sharded as ref_ensure
    from photon_ml_tpu.parallel.mesh import make_mesh as ref_make_mesh
    import jax

    rows, labels = _rows(3)
    batch = make_sparse_batch(rows, labels, device="cpu")
    mesh = _mesh((2,), (1,))
    first = ts.ensure_tiled_sharded(batch, D, mesh)
    want = ts.build_sharded_tiled_batch(batch, D, 2, 1, device="cpu")
    _same(schedule_arrays(first), schedule_arrays(want))
    for a in ("labels", "offsets", "weights"):
        assert torch.equal(getattr(first, a), getattr(want, a))
    assert schedule_cache.stats().builds == 4
    shifted = type(batch)(batch.indices, batch.values, batch.labels,
                          batch.offsets + 1.0, batch.weights)
    again = ts.ensure_tiled_sharded(shifted, D, mesh)
    assert schedule_cache.stats().builds == 4 and again.z_sched is first.z_sched
    built = ts.build_sharded_tiled_batch(shifted, D, 2, 1, device="cpu")
    for a in ("labels", "offsets", "weights"):
        assert torch.equal(getattr(again, a), getattr(built, a))
    assert ts.ensure_tiled_sharded(first, D, mesh) is first
    with pytest.raises(ValueError) as ours:
        ts.ensure_tiled_sharded(first, D, _mesh((4,), (1,)))
    ref_batch = ref_make(rows, labels)
    ref_mesh2 = ref_make_mesh((2,), devices=jax.devices()[:2])
    ref_mesh4 = ref_make_mesh((4,), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as theirs:
        ref_ensure(ref_build(ref_batch, D, 2, mesh=ref_mesh2), D, ref_mesh4)
    assert str(ours.value) == str(theirs.value)
