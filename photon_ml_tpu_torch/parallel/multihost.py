"""Multi-process orchestration: joining the ranks, IO guards, input shards
(port of ``photon_ml_tpu/parallel/multihost.py``).

The reference joins the JAX coordination service and then runs one program
over every process's devices. Here each process is one rank of a
``torch.distributed`` default group, joined over ``tcp://`` at the
coordinator's address with the world size and the rank given explicitly
(nothing on the machine announces a cluster). Then:

- process 0 is elected for host-side effects (output files, checkpoints,
  logs of record), the reference's driver role;
- host-side work lists (input files) are split across processes by
  content (:func:`shard_assignment`), so two processes that list the same
  files in different orders agree on every file's owner.

A single process passes through untouched: ``initialize_multihost(None)``
is a no-op and every guard says "process 0 of 1".

Backend: gloo for ranks on the CPU and for ranks that share one card
(NCCL refuses two ranks on one card; gloo stages CUDA tensors through the
host, the compute stays on the card); NCCL where every rank has a card of
its own.
"""

from __future__ import annotations

import functools
import os
import shutil
import zlib
from datetime import timedelta
from typing import List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")

_initialized = False


def backend_for(num_processes: int, device: Optional[str]) -> str:
    """gloo on the CPU or where ranks share a card; NCCL when each rank
    has a card of its own."""
    if device == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str],
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the ranks at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``; process 0 listens there). No-op (False) without
    an address, the single-process path. ``num_processes`` and
    ``process_id`` are required with one: nothing here detects a cluster.
    Safe to call again in the same process."""
    global _initialized
    if coordinator_address is None:
        return False
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    if num_processes is None or process_id is None:
        raise ValueError(
            "--coordinator-address needs --num-processes and --process-id"
        )
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(
            f"process id {process_id} outside [0, {num_processes})"
        )
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend_for(int(num_processes), device), init_method=address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=timeout_s),
    )
    _initialized = True
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process elected for host-side effects (process 0)."""
    return process_index() == 0


def coordinator_only(fn):
    """Decorator: run ``fn`` only on process 0; other processes get None.
    For output, model and checkpoint writes that must happen once."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_coordinator():
            return fn(*args, **kwargs)
        return None

    return wrapper


def prepare_output_dir(path: str, *, delete_if_exists: bool, hint: str = "") -> None:
    """The multi-process output-directory guard: every process runs the
    read-only non-empty check, so a refusal raises the same error
    everywhere (no process left waiting at a barrier); only the
    coordinator changes the directory, and the barrier orders that before
    anyone goes on."""
    if os.path.isdir(path) and os.listdir(path) and not delete_if_exists:
        suffix = f" ({hint})" if hint else ""
        raise ValueError(f"output directory {path} exists and is non-empty{suffix}")
    if is_coordinator():
        if os.path.isdir(path) and delete_if_exists:
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
    sync_processes("output-dir-ready")


def shard_assignment(item: T, num_shards: int) -> int:
    """The content-keyed shard of one work item: CRC32 of its string form
    mod the shard count, so it depends on the item alone, never on its
    place in a list (the reference's contract, bit for bit)."""
    return zlib.crc32(str(item).encode("utf-8")) % num_shards


def process_shard(items: Sequence[T]) -> List[T]:
    """This process's part of a host-side work list (input files, daily
    paths), by :func:`shard_assignment`; single-process: the list as it
    is."""
    n = process_count()
    if n <= 1:
        return list(items)
    i = process_index()
    return [x for x in items if shard_assignment(x, n) == i]


def sync_processes(name: str = "photon-ml-barrier") -> None:
    """Barrier across processes (no-op single-process). Use between a
    coordinator-only write and a global read of its output."""
    del name  # the reference names its barrier; torch's are anonymous
    if process_count() <= 1:
        return
    dist.barrier()


def allgather_objects(obj) -> list:
    """Every process's ``obj`` (picklable), in rank order; ``[obj]``
    single-process. Sums over ranks add these in rank order, so their
    bits do not depend on the backend's reduction order."""
    if process_count() <= 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_in_rank_order(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``t`` (of ``group``, the world by default) stacked
    in rank order -> ``[n, ...]``; ``t[None]`` single-process. The tensor
    goes to the backend as it is (gloo stages a CUDA tensor itself)."""
    if group is None and process_count() <= 1:
        return t[None]
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts)


def sum_in_rank_order(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``t`` (of ``group``, the world by default) summed in
    rank order (an all-gather, then adds from rank 0 up), so the bits are
    the same in every process and in every run, whatever order a
    backend's all-reduce would take; ``t`` itself single-process."""
    if group is None and process_count() <= 1:
        return t
    parts = gather_in_rank_order(t, group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def any_process(flag: bool) -> bool:
    """Whether ``flag`` holds on any process (a stop every process takes
    together at the same boundary); ``flag`` single-process."""
    if process_count() <= 1:
        return bool(flag)
    return any(allgather_objects(bool(flag)))
