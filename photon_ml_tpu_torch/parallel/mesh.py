"""Process meshes over ``torch.distributed`` (port of
``photon_ml_tpu/parallel/mesh.py``).

The reference lays a ``jax.sharding.Mesh`` over the devices of one
controller and runs collectives inside ``shard_map``. PyTorch reaches
several devices through processes: here each rank is one process, and a
:class:`ProcessMesh` gives it its coordinates on a named grid of ranks and
one process group per axis (the ranks that share every other coordinate),
so a ``psum`` over an axis becomes an all-reduce over that axis's group.

Axis names are the reference's: ``"data"`` (examples) and ``"model"``
(features, for coefficient vectors sharded by block).

Backend: ``gloo``, explicitly, on the CPU and on the card alike (gloo
takes CUDA tensors and stages them through the host). It lets several
ranks share one card, which NCCL refuses; NCCL with one card per rank is
for a machine with several cards.
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class ProcessMesh:
    """This rank's view of a grid of ranks (row-major: the last axis
    varies fastest, as ``np.reshape`` lays out the reference's devices)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    coords: Tuple[int, ...]  # this rank's index along each axis
    groups: Dict[str, Any]  # axis -> process group of the ranks along it
    world: Any  # process group of every rank
    device: torch.device

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    *,
    device: DeviceLike = None,
    backend: str = "gloo",
) -> ProcessMesh:
    """This rank's :class:`ProcessMesh` over the already-initialized default
    process group (so ``torchrun`` works as it is). Every rank must call it
    with the same arguments: each creates every group, in one order.

    ``shape`` defaults to a 1-D mesh over every rank; its product must be
    the world size. ``device=None`` means the card (raises without one);
    on the card rank r takes ``cuda:(r % device_count)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group")
    world_size = dist.get_world_size()
    rank = dist.get_rank()
    shape = (world_size,) if shape is None else tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh shape {shape} != world size {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    grid = np.arange(world_size).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups = {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                groups[name] = group
    world = dist.new_group(list(range(world_size)), backend=backend)
    return ProcessMesh(shape, axis_names, rank, coords, groups, world, dev)


def data_shard_sparse_batch(batch: SparseBatch, n_shards: int, index: int) -> SparseBatch:
    """Rows ``[index * n_loc, (index + 1) * n_loc)`` of ``batch`` with its
    rows padded (weight 0) to a multiple of ``n_shards``: shard ``index``
    of the reference's ``ensure_data_sharded`` layout."""
    n = batch.num_rows
    n_loc = -(-n // n_shards)
    lo, hi = index * n_loc, min((index + 1) * n_loc, n)

    def rows(t: torch.Tensor) -> torch.Tensor:
        part = t[lo:hi]
        missing = n_loc - part.shape[0]
        if missing:
            part = torch.cat([part, part.new_zeros((missing,) + part.shape[1:])])
        return part

    return SparseBatch(*(rows(t) for t in (
        batch.indices, batch.values, batch.labels, batch.offsets, batch.weights,
    )))


# ---------------------------------------------------------------------------
# Spawning a mesh of ranks
# ---------------------------------------------------------------------------


# A rank that has not joined its process group this long after the spawn
# is stuck (a spawn that imports torch takes seconds, tens on a loaded
# host); the caller's own timeout counts from the join.
START_TIMEOUT_S = 300.0


def _to_host(obj):
    """Tensors -> numpy (recursively through lists, tuples and dicts), so a
    rank's result crosses the process boundary as plain pickled data."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(
    rank, world_size, init_method, fn, shape, axis_names, device, backend,
    args, timeout_s, results,
):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size, timeout=timedelta(seconds=timeout_s),
        )
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    # joined: the caller's deadline for fn starts once every rank is here
    results.put((rank, None, None))
    try:
        mesh = make_mesh(shape, axis_names, device=device, backend=backend)
        status = (rank, True, _to_host(fn(mesh, *args)))
    except BaseException:
        status = (rank, False, traceback.format_exc())
    results.put(status)
    dist.destroy_process_group()


def spawn_mesh(
    fn: Callable,
    shape: Sequence[int],
    axis_names: Sequence[str] = (DATA_AXIS,),
    *,
    device: DeviceLike = None,
    backend: str = "gloo",
    args: tuple = (),
    timeout_s: float = 600.0,
) -> List[Any]:
    """Start ``prod(shape)`` ranks (``spawn``; a ``file://`` rendezvous in a
    fresh temporary directory, so no TCP port is shared), call
    ``fn(mesh, *args)`` on each and return each rank's result, tensors as
    numpy. ``fn`` must be importable by name from a module that the ranks
    can import (a rank re-imports it).

    Raises when a rank raises (with its traceback), exits without a result,
    does not join its process group within ``START_TIMEOUT_S`` of the
    spawn, or does not finish within ``timeout_s`` of the mesh's start
    (the moment the last rank joined: spawning ranks that import torch
    takes seconds, and many more on a loaded host, which must not eat
    into ``fn``'s time); the other ranks are then stopped. Nothing of a
    rank outlives the call."""
    resolve_device(device)  # no CUDA when asked for it: raise before spawning
    world_size = math.prod(int(s) for s in shape)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="photon_mesh_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [
        ctx.Process(
            target=_rank_main, daemon=True,
            args=(
                r, world_size, init_method, fn, tuple(shape), tuple(axis_names),
                device, backend, tuple(args), max(timeout_s, START_TIMEOUT_S), results,
            ),
        )
        for r in range(world_size)
    ]
    t_spawn = time.monotonic()
    deadline = t_spawn + START_TIMEOUT_S
    joined: set = set()
    started_s = None  # seconds from the spawn to the last rank's join
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if started_s is None:
                    missing = sorted(set(range(world_size)) - joined)
                    raise TimeoutError(
                        f"mesh ranks {missing} did not join the process group "
                        f"within {START_TIMEOUT_S} s of the spawn"
                    )
                missing = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(
                    f"mesh ranks {missing} did not finish within {timeout_s} s "
                    f"of the mesh's start (every rank joined its process group "
                    f"{started_s:.3f} s after the spawn)"
                )
            try:
                rank, ok, payload = results.get(timeout=min(remaining, 0.5))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"mesh rank {r} exited with code {p.exitcode} "
                            "and no result"
                        ) from None
                continue
            if ok is None:  # a rank joined its process group
                joined.add(rank)
                if len(joined) == world_size:
                    started_s = time.monotonic() - t_spawn
                    deadline = time.monotonic() + timeout_s
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(out) == world_size else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
