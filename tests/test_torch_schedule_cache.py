"""The port's persistent schedule cache (``ops/schedule_cache.py``), its
hook in the schedule builder, ``ensure_tiled`` and ``tile_cache_dir`` on
the single-card trainers. Schedules are compared exactly: a loaded
schedule must be the one the builder makes, and an artifact the JAX
package's cache wrote must load in the port to the JAX package's arrays.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import schedule_cache as ref_cache
from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import tiled_batch_from_sparse as ref_tiled
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TileParams,
    ensure_tiled,
    tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model, train_grid_batched

from tests.test_torch_tiled_sparse import FIELDS, sorted_reference
from tests.torch_parity import both_batches, random_rows

D = 150
PARAMS = dict(s_hi=8, s_lo=8, chunk=32, spill_cap=8)


@pytest.fixture
def fresh_stats():
    schedule_cache.reset_stats()
    ref_cache.reset_stats()
    yield
    schedule_cache.reset_stats()
    ref_cache.reset_stats()


def _batches(seed=0):
    rows, labels = random_rows(np.random.default_rng(seed), n=120, d=D, k=8)
    return both_batches(rows, labels)


def _schedule_arrays(tb):
    return [
        t.numpy() for sched in (tb.z_sched, tb.g_sched)
        for t in (sched.step_out, sched.step_in, sched.step_init, sched.out_pos,
                  sched.in_pos, sched.vals, sched.spill_out, sched.spill_in,
                  sched.spill_vals)
    ]


def _assert_same_schedules(a, b):
    for x, y in zip(_schedule_arrays(a), _schedule_arrays(b)):
        np.testing.assert_array_equal(x, y)


def test_store_and_load_round_trip(tmp_path, fresh_stats):
    rng = np.random.default_rng(1)
    arrays = [rng.integers(0, 9, size=s).astype(np.int32) for s in (5, 5, 5)] + [
        rng.normal(size=(8, 4)).astype(np.float32) for _ in range(3)
    ] + [np.zeros(128, np.int32), np.zeros(128, np.int32), np.zeros(128, np.float32)]
    key = schedule_cache.schedule_key(
        schedule_cache.content_digest(*arrays[:3]), TileParams(**PARAMS), False, 3)
    assert schedule_cache.load_schedule(str(tmp_path), key) is None  # a miss
    assert schedule_cache.store_schedule(str(tmp_path), key, arrays)
    back = schedule_cache.load_schedule(str(tmp_path), key)
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    s = schedule_cache.stats()
    assert (s.misses, s.stores, s.hits) == (1, 1, 1)


def test_keys_and_digests_equal_the_reference():
    """Both packages key a schedule alike, so either loads the other's."""
    rng = np.random.default_rng(2)
    rows, feats = rng.integers(0, 99, 500), rng.integers(0, 99, 500)
    vals = rng.normal(size=500).astype(np.float32)
    digest = schedule_cache.content_digest(rows, feats, vals)
    assert digest == ref_cache.content_digest(rows, feats, vals)
    for chunk in (32, None):
        for sort in (False, True):
            assert schedule_cache.schedule_key(
                digest, TileParams(8, 8, chunk, 4), sort, 7
            ) == ref_cache.schedule_key(digest, RefTileParams(8, 8, chunk, spill_cap=4),
                                        sort, 7)


def test_a_hit_skips_the_build(tmp_path, fresh_stats):
    _, batch = _batches()
    cold = tiled_batch_from_sparse(batch, D, params=TileParams(**PARAMS), device="cpu")
    assert schedule_cache.stats().builds == 2  # counted with the cache off too
    with schedule_cache.cache_scope(str(tmp_path)):
        first = tiled_batch_from_sparse(batch, D, params=TileParams(**PARAMS), device="cpu")
        s = schedule_cache.stats()
        assert (s.builds, s.misses, s.stores, s.hits) == (4, 2, 2, 0)
        second = tiled_batch_from_sparse(batch, D, params=TileParams(**PARAMS), device="cpu")
    s = schedule_cache.stats()
    assert (s.builds, s.hits) == (4, 2)
    assert second.builder == "cache" and first.builder != "cache"
    _assert_same_schedules(second, cold)
    np.testing.assert_array_equal(second.g_vals_sq.numpy(), cold.g_vals_sq.numpy())


def test_corrupt_artifact_is_quarantined_and_rebuilt(tmp_path, fresh_stats):
    _, batch = _batches()
    params = TileParams(**PARAMS)
    with schedule_cache.cache_scope(str(tmp_path)):
        clean = tiled_batch_from_sparse(batch, D, params=params, device="cpu")
        version_dir = tmp_path / f"v{schedule_cache.SCHEDULE_CACHE_VERSION}"
        victim = sorted(version_dir.iterdir())[0]
        with open(victim / "vals.npy", "r+b") as f:
            f.seek(100)
            f.write(b"\xff" * 8)
        schedule_cache.reset_stats()
        rebuilt = tiled_batch_from_sparse(batch, D, params=params, device="cpu")
        s = schedule_cache.stats()
        assert (s.corrupt, s.quarantined, s.builds, s.hits, s.stores) == (1, 1, 1, 1, 1)
        assert os.path.isdir(f"{victim}.corrupt")
        assert os.path.isfile(victim / "meta.json")  # stored again, clean
        schedule_cache.reset_stats()
        again = tiled_batch_from_sparse(batch, D, params=params, device="cpu")
        assert schedule_cache.stats().hits == 2
    for tb in (rebuilt, again):
        _assert_same_schedules(tb, clean)


def test_reference_artifact_loads_in_the_port(tmp_path, fresh_stats):
    """The JAX package's cache writes the artifacts; the port's build of
    the same batch loads both passes from them, to the reference's arrays."""
    ref_batch, batch = _batches(4)
    with ref_cache.cache_scope(str(tmp_path)):
        ref_tb = ref_tiled(ref_batch, D, params=RefTileParams(**PARAMS))
    assert ref_cache.stats().stores == 2
    with schedule_cache.cache_scope(str(tmp_path)):
        tb = tiled_batch_from_sparse(batch, D, params=TileParams(**PARAMS), device="cpu")
    s = schedule_cache.stats()
    assert (s.hits, s.builds) == (2, 0) and tb.builder == "cache"
    # entries sorted by output slot within each step, as the port holds them
    want = [
        sorted_reference(sched, tb.params.window)[name]
        for sched in (ref_tb.z_sched, ref_tb.g_sched) for name in FIELDS
    ]
    for got, ref in zip(_schedule_arrays(tb), want):
        np.testing.assert_array_equal(got, ref)


def test_ensure_tiled_reuses_the_conversion(tmp_path, fresh_stats):
    """A tiled batch passes through; a SparseBatch whose tensors an earlier
    call tiled, unedited since, reuses that conversion (the in-memory
    tier); an in-place edit is seen and tiled afresh; new tensors reuse
    schedules only through the disk cache, keyed by content."""
    _, batch = _batches(5)
    first = ensure_tiled(batch, D, device="cpu")
    assert ensure_tiled(first, D) is first
    again = ensure_tiled(batch, D, device="cpu")
    assert again is not first and schedule_cache.stats().builds == 2
    assert again.z_sched is first.z_sched
    _assert_same_schedules(again, first)
    # values edited in place: the next conversion sees them
    batch.values.mul_(2.0)
    edited = ensure_tiled(batch, D, device="cpu")
    assert schedule_cache.stats().builds == 4
    np.testing.assert_array_equal(edited.z_sched.vals.numpy(), 2.0 * first.z_sched.vals.numpy())

    def fresh():
        return dataclasses.replace(
            batch, indices=batch.indices.clone(), values=batch.values.clone()
        )

    with schedule_cache.cache_scope(str(tmp_path)):
        ensure_tiled(fresh(), D, device="cpu")
        cached = ensure_tiled(fresh(), D, device="cpu")
    assert cached.builder == "cache"
    _assert_same_schedules(cached, edited)


@pytest.mark.parametrize("trainer", [train_generalized_linear_model, train_grid_batched])
def test_trainers_take_a_tile_cache_dir(tmp_path, fresh_stats, trainer):
    """The second fit over the same rows loads its schedules and fits the
    same models."""
    _, batch = _batches(6)
    kw = dict(regularization_weights=[1.0, 0.1], max_iter=4, kernel="tiled",
              device="cpu", tile_cache_dir=str(tmp_path))
    cold, _ = trainer(batch, TaskType.LOGISTIC_REGRESSION, D, **kw)
    assert schedule_cache.stats().stores == 2
    schedule_cache.reset_stats()
    warm, _ = trainer(batch, TaskType.LOGISTIC_REGRESSION, D, **kw)
    s = schedule_cache.stats()
    assert (s.hits, s.builds) == (2, 0)
    for lam in cold:
        torch.testing.assert_close(warm[lam].means, cold[lam].means, rtol=0, atol=0)
    assert schedule_cache.resolve_cache_dir() is None  # the scope ended
