"""Scatter-adds in one fixed order of additions.

``index_add_`` and ``scatter_add_`` add with float atomics on a CUDA
tensor, so the order in which several sources reach one output, and so
the rounding, changes from run to run. The fit paths that must repeat
bitwise sum through :func:`index_add` instead:

- on the CPU it is ``index_add_`` itself (one thread, entry order);
- on the card the sources are sorted by their output index, stably, once
  per index tensor (:func:`segment_plan`), each output's sources are summed
  in that order (``torch.segment_reduce``, one segment at a time), and the
  sums are added to the outputs once each (unique indices, no two writes
  meet).

Either way the result is a function of the inputs alone, whatever
``torch.use_deterministic_algorithms`` says.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class SegmentPlan:
    """The sources of one index tensor grouped by output: ``order`` sorts
    them by output index (stably), ``offsets`` [n_unique + 1] bound each
    output's run in that order, ``slots`` are the outputs."""

    order: Tensor
    offsets: Tensor
    slots: Tensor


def segment_plan(index: Tensor) -> SegmentPlan:
    """The plan of a 1-D index tensor (on its device)."""
    index = index.reshape(-1).long()
    order = torch.sort(index, stable=True).indices
    slots, counts = torch.unique_consecutive(index[order], return_counts=True)
    offsets = torch.zeros(slots.shape[0] + 1, dtype=torch.long, device=index.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return SegmentPlan(order, offsets, slots)


# plans of index tensors the objectives keep (a batch's indices): keyed by
# the tensor's id, held by a weak reference and its version counter, so a
# freed or edited tensor never finds another's plan
_PLANS_MAX = 16
_plans: dict = {}


def cached_plan(index: Tensor, width: Optional[int] = None) -> SegmentPlan:  # photon: entropy(id-keyed plan memo; weakref- and version-checked, never serialized)
    """:func:`segment_plan` of ``index``, made once while the tensor lives
    unedited; with ``width``, of a row-wise scatter's flat output
    coordinates (row * width + index, rows along the last axis)."""
    key = (id(index), width)
    hit = _plans.get(key)
    if hit is not None and hit[0]() is index and hit[1] == index._version:
        return hit[2]
    plan = segment_plan(index if width is None else _row_coordinates(index, width))
    _plans[key] = (weakref.ref(index), index._version, plan)
    while len(_plans) > _PLANS_MAX:
        _plans.pop(next(iter(_plans)))
    return plan


def index_add(
    out: Tensor, index: Tensor, source: Tensor, *, plan: Optional[SegmentPlan] = None
) -> Tensor:
    """``out[..., index[i]] += source[..., i]`` over the last axis, in
    place, in a fixed order (module note). ``plan``: ``index``'s
    :func:`segment_plan`, when the caller keeps one."""
    if out.device.type != "cuda":
        return out.index_add_(-1, index, source)
    return segmented_add(out, source, plan if plan is not None else cached_plan(index))


def scatter_add_rows(out: Tensor, index: Tensor, source: Tensor) -> Tensor:
    """``out.scatter_add_(-1, index, source)`` for ``[..., n]`` rows (each
    row scatters into its own row of ``out``), in a fixed order on the card
    (module note); the plan is cached on ``index``."""
    if out.device.type != "cuda":
        return out.scatter_add_(-1, index, source)
    plan = cached_plan(index, out.shape[-1])
    flat = out.reshape(-1)
    segmented_add(flat, source.reshape(-1), plan)
    return flat.view(out.shape)


def _row_coordinates(index: Tensor, width: int) -> Tensor:
    rows = torch.arange(index.numel() // index.shape[-1], device=index.device)
    return (rows[:, None] * width + index.reshape(-1, index.shape[-1])).reshape(-1)


def segmented_add(out: Tensor, source: Tensor, plan: SegmentPlan) -> Tensor:
    """The card's path of :func:`index_add` on any device: each output's
    sources summed in plan order, then added once."""
    if plan.slots.shape[0] == 0:
        return out
    ordered = source.index_select(-1, plan.order)
    # segment_reduce sums along the leading axis of a [n, ...] tensor
    sums = torch.segment_reduce(
        ordered.movedim(-1, 0), "sum", offsets=plan.offsets, axis=0
    ).movedim(0, -1)
    out[..., plan.slots] = out[..., plan.slots] + sums
    return out
