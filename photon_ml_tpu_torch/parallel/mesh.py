"""Process meshes over ``torch.distributed`` (port of
``photon_ml_tpu/parallel/mesh.py``).

The reference lays a ``jax.sharding.Mesh`` over the devices of one
controller and runs collectives inside ``shard_map``. PyTorch reaches
several devices through processes: here each rank is one process, and a
:class:`ProcessMesh` gives it its coordinates on a named grid of ranks and
one process group per axis (the ranks that share every other coordinate),
so a ``psum`` over an axis becomes an all-reduce over that axis's group.

Axis names are the reference's: ``"data"`` (examples), ``"model"``
(features, for coefficient vectors sharded by block), ``"entity"``
(random-effect banks sharded by entity hash, ``game/pod.py``) and
``"grid"`` (λ-grid members, ``game/unified.py``). A device of the
reference is a rank here: its ``len(jax.devices())`` is the process
count, and its mesh over the first N devices is a mesh over N ranks. Where
N is below the process count, the ranks split into consecutive blocks of
N, each its own mesh running the same program on the same inputs (the
replicas of :func:`entity_mesh`).

Backend: ``gloo``, explicitly, on the CPU and on the card alike (gloo
takes CUDA tensors and stages them through the host). It lets several
ranks share one card, which NCCL refuses; NCCL with one card per rank is
for a machine with several cards.
"""

from __future__ import annotations

import dataclasses
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

from photon_ml_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# Pod-scale GAME (game/pod.py): random-effect banks shard entities over
# this axis by entity hash (code % n_shards); residuals ride all-to-alls.
ENTITY_AXIS = "entity"
# Unified-mesh λ-grid axis (parallel/unified_mesh.py): grid members shard
# over it, so a (grid, entity) mesh trains G entity-sharded members at once.
GRID_AXIS = "grid"


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

    def ranks_sharing(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The world ranks, in every replica block, whose coordinates along
        ``axes`` are this rank's: the processes that hold the same shard of
        an ``axes``-sharded layout (the schedule cache's builders of it)."""
        size = self.world_size
        grid = np.arange(size).reshape(self.shape)
        local = grid[tuple(
            c if name in axes else slice(None)
            for c, name in zip(self.coords, self.axis_names)
        )].reshape(-1)
        blocks = dist.get_world_size() // size if dist.is_initialized() else 1
        return tuple(sorted(int(b * size + r) for b in range(blocks) for r in local))


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    *,
    device: DeviceLike = None,
    backend: str = "gloo",
    replicas: bool = False,
) -> ProcessMesh:
    """This rank's :class:`ProcessMesh` over the already-initialized default
    process group (so ``torchrun`` works as it is). Every rank must call it
    with the same arguments: each creates every group, in one order.

    ``shape`` defaults to a 1-D mesh over every rank; its product must be
    the world size, or with ``replicas`` divide it: the ranks then split
    into consecutive blocks of ``prod(shape)``, each a mesh of its own
    (``world`` is the block's group; a 1-rank block's groups are None). ``device=None`` means the card (raises without
    one); on the card rank r takes ``cuda:(r % device_count)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group")
    world_size = dist.get_world_size()
    rank = dist.get_rank()
    shape = (world_size,) if shape is None else tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    size = math.prod(shape)
    if size != world_size and not (replicas and world_size % size == 0):
        raise ValueError(f"mesh shape {shape} != world size {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    base = (rank // size) * size
    grid = np.arange(size).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(grid == rank - base)[0])
    groups: Dict[str, Any] = {name: None for name in axis_names}
    world = None
    # a 1-rank block of a larger world has no groups: a collective over
    # None would span the world
    if size > 1 or world_size == 1:
        for first in range(0, world_size, size):
            block = grid + first
            for a, name in enumerate(axis_names):
                lines = np.moveaxis(block, a, -1).reshape(-1, shape[a])
                for line in lines:
                    group = dist.new_group([int(r) for r in line], backend=backend)
                    if rank in line:
                        groups[name] = group
            group = dist.new_group([int(r) for r in block.reshape(-1)], backend=backend)
            if first == base:
                world = group
    return ProcessMesh(shape, axis_names, rank, coords, groups, world, dev)


def entity_mesh(
    num_shards: Optional[int] = None,
    *,
    device: DeviceLike = None,
    backend: str = "gloo",
) -> ProcessMesh:
    """1-D mesh over the ``entity`` axis for hash-sharded random-effect
    banks (``game/pod.py``; the reference's ``entity_mesh``, ranks counted
    as devices). ``num_shards`` defaults to every process; fewer shards
    than processes make blocks of consecutive ranks, each an entity mesh
    running the same program (so it must divide the process count). One
    shard needs no process group."""
    from photon_ml_tpu_torch.parallel import multihost

    n = multihost.process_count()
    if num_shards is None:
        num_shards = n
    if not 1 <= num_shards <= n:
        raise ValueError(
            f"entity shards {num_shards} out of range for {n} visible devices"
        )
    if n % num_shards:
        raise ValueError(
            f"entity shards {num_shards} do not divide the {n} processes: each "
            "block of consecutive ranks is one entity mesh"
        )
    if not dist.is_initialized():
        # one process, one shard: no process group, no collective
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return ProcessMesh((1,), (ENTITY_AXIS,), 0, (0,), {ENTITY_AXIS: None}, None, dev)
    return make_mesh((num_shards,), (ENTITY_AXIS,), device=device, backend=backend, replicas=True)


@dataclass(frozen=True)
class Placement:
    """Where this rank holds a tensor of a mesh layout (the reference's
    ``NamedSharding`` in rank terms): on ``device``, rows split over
    ``axis`` into ``shards`` contiguous blocks of which it holds block
    ``index``; ``axis`` None is a replicated tensor (the whole of it)."""

    device: torch.device
    axis: Optional[str]
    shards: int
    index: int


def data_sharding(mesh: ProcessMesh, axis: str = DATA_AXIS) -> Placement:
    """Leading-axis (example) sharding over ``axis``, on this rank."""
    return Placement(mesh.device, axis, mesh.size(axis), mesh.index(axis))


def replicated(mesh: ProcessMesh) -> Placement:
    return Placement(mesh.device, None, 1, 0)


def _map_tensors(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def replicate(tree, mesh: ProcessMesh):
    """Every tensor of ``tree`` (through dataclasses, dicts, lists and
    tuples) on this rank's device, whole."""
    return _map_tensors(lambda t: t.to(mesh.device), tree)


_ROW_FIELDS = {
    SparseBatch: ("indices", "values", "labels", "offsets", "weights"),
    DenseBatch: ("features", "labels", "offsets", "weights"),
}


def _row_fields(batch):
    fields = _ROW_FIELDS.get(type(batch))
    if fields is None:
        raise TypeError(f"cannot row-pad {type(batch).__name__}")
    return fields


def pad_batch_rows(batch, multiple: int):
    """A Sparse or Dense batch with its rows zero-padded (weight 0, inert in
    every objective) up to a multiple of ``multiple``; the batch itself
    when its rows already are one."""
    fields = _row_fields(batch)
    n = batch.labels.shape[0]
    n_pad = ((n + multiple - 1) // multiple) * multiple
    if n_pad == n:
        return batch
    return type(batch)(*(
        torch.cat([t, t.new_zeros((n_pad - n,) + t.shape[1:])])
        for t in (getattr(batch, f) for f in fields)
    ))


def _shard_rows(batch, n_shards: int, index: int):
    """Rows ``[index * n_loc, (index + 1) * n_loc)`` of ``batch`` with its
    rows padded (weight 0) to a multiple of ``n_shards``."""
    padded = pad_batch_rows(batch, n_shards)
    n_loc = padded.labels.shape[0] // n_shards
    rows = slice(index * n_loc, (index + 1) * n_loc)
    return type(batch)(*(getattr(padded, f)[rows] for f in _row_fields(batch)))


def shard_batch(batch, mesh: ProcessMesh, axis: str = DATA_AXIS):
    """This rank's rows of ``batch`` sharded over ``axis``, on its device:
    block ``mesh.index(axis)`` of ``mesh.size(axis)`` contiguous blocks.
    The row count must divide the axis (pad first, as the reference
    asks)."""
    placement = data_sharding(mesh, axis)
    n = batch.labels.shape[0]
    if n % placement.shards:
        raise ValueError(
            f"{n} rows do not divide the {placement.shards} shards of the "
            f"{axis!r} axis; pad them first (pad_batch_rows)"
        )
    out = _shard_rows(batch, placement.shards, placement.index).to(placement.device)
    # marks the shard for ensure_data_sharded (a frozen dataclass takes a
    # non-field attribute)
    object.__setattr__(out, "_placement", placement)
    return out


def ensure_data_sharded(batch, mesh: ProcessMesh, axis: str = DATA_AXIS):
    """Idempotent pad + shard: the batch unchanged when it already is this
    rank's ``axis`` shard on this mesh (so a λ-grid loop cuts the rows
    once), else :func:`shard_batch` of it padded to the axis."""
    if getattr(batch, "_placement", None) == data_sharding(mesh, axis):
        return batch
    return shard_batch(pad_batch_rows(batch, mesh.size(axis)), mesh, axis)


def data_shard_sparse_batch(batch: SparseBatch, n_shards: int, index: int) -> SparseBatch:
    """Shard ``index`` of the reference's ``ensure_data_sharded`` layout of
    ``batch`` over ``n_shards`` (on the batch's device)."""
    return _shard_rows(batch, n_shards, index)


def maybe_make_mesh(
    distributed: str, model_shards: Optional[int] = None, *,
    device: DeviceLike = None, backend: str = "gloo",
) -> Optional[ProcessMesh]:
    """The drivers' mesh policy (the reference's ``maybe_make_mesh``, with
    the processes for its devices). "auto" -> a 1-D data mesh over every
    process when there is more than one, else None; "off" -> None;
    "feature" -> a (data, model) mesh for feature-sharded coefficients
    (model axis ``model_shards``, default 2; data axis the rest). Every
    process must call it, in the same order."""
    if distributed not in ("auto", "off", "feature"):
        raise ValueError(
            f"unknown distributed mode {distributed!r}; "
            "expected auto | off | feature"
        )
    from photon_ml_tpu_torch.parallel import multihost

    n = multihost.process_count()
    if distributed == "off" or n < 2:
        return None
    if distributed == "feature":
        m = model_shards if model_shards is not None else 2
        if n % m != 0:
            raise ValueError(
                f"model_shards={m} does not divide the {n} visible devices"
            )
        return make_mesh((n // m, m), (DATA_AXIS, MODEL_AXIS), device=device, backend=backend)
    return make_mesh(device=device, backend=backend)


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
