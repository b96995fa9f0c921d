"""``parallel/mesh.py``: a mesh of spawned ranks fails loudly and never
hangs its caller (a rank that raises, dies or hangs), and the data-shard
layout of a SparseBatch. Which ranks see which groups is checked in
``tests/test_torch_isolation.py``'s spawned probe.
"""

import os
import re
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    data_shard_sparse_batch,
    make_mesh,
    spawn_mesh,
)


def _raising_rank(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one gives up")
    return mesh.rank


def _dying_rank(mesh):
    if mesh.rank == 1:
        os._exit(3)
    return mesh.rank


def _hanging_rank(mesh):
    if mesh.rank == 1:
        time.sleep(600)
    return mesh.rank


def test_a_rank_exception_reaches_the_caller():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed.*rank one gives up"):
        spawn_mesh(_raising_rank, (2,), device="cpu", timeout_s=120.0)


def test_a_dead_rank_reaches_the_caller():
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        spawn_mesh(_dying_rank, (2,), device="cpu", timeout_s=120.0)


def test_a_hanging_rank_times_out():
    """Only the hanging rank is named, and the caller is freed within the
    timeout (plus the ranks' teardown) of the mesh's start: the deadline
    counts from the moment every rank joined, so a slow spawn on a loaded
    host (ranks that import torch) cannot make rank 0 miss it."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] did not finish within 10.0 s") as e:
        spawn_mesh(_hanging_rank, (2,), device="cpu", timeout_s=10.0)
    started_s = float(re.search(r"group ([0-9.]+) s after the spawn", str(e.value)).group(1))
    assert time.monotonic() - t0 - started_s < 30.0


def _slow_joining_rank(mesh):
    return mesh.rank


def test_a_rank_that_never_joins_is_named(monkeypatch):
    """The start has its own bound: a rank missing from the process group
    fails the call naming it, with nothing left running."""
    from photon_ml_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "START_TIMEOUT_S", 0.2)
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1, 2\] did not join"):
        spawn_mesh(_slow_joining_rank, (3,), device="cpu", timeout_s=10.0)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized default process group"):
        make_mesh((1,), (DATA_AXIS,), device="cpu")


def test_data_shard_sparse_batch():
    """10 rows over 4 shards: 3 rows a shard, the last holding row 9 and
    two weight-0 padding rows, as the reference's ensure_data_sharded."""
    rows = [([i % 3], [float(i + 1)]) for i in range(10)]
    batch = make_sparse_batch(rows, list(range(10)), device="cpu", pad_rows_to=1)
    shards = [data_shard_sparse_batch(batch, 4, i) for i in range(4)]
    assert [s.num_rows for s in shards] == [3, 3, 3, 3]
    np.testing.assert_array_equal(
        torch.cat([s.labels for s in shards]).numpy(), list(range(10)) + [0, 0]
    )
    np.testing.assert_array_equal(shards[3].weights.numpy(), [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(shards[3].values[:, 0].numpy(), [10.0, 0.0, 0.0])
