"""K1, the tiled bilinear pass: CUDA kernel wrapper, work plan and plain
version.

Replaces the Pallas kernel ``photon_ml_tpu/ops/tiled_sparse.py``
(``_bilinear_pass_kernel``, launched by ``_run_bilinear_pass``). One
function serves the z-pass ``X . w``, the g-pass ``X^T . c`` and the
Hessian-diagonal g-pass over squared values:

    out[step_out[s] * W + out_pos[s, e]] +=
        vals[s, e] * src[step_in[s] * W + in_pos[s, e]]

over the ``S`` steps of a schedule (entry rows past ``S`` are padding) and
the ``L`` entries of each step, with ``W`` the window. ``src`` and the
result are flat padded vectors. With ``spill=True`` the pass also adds the
schedule's spill remainder (the tile tails its steps leave out; the JAX
package's ``_Schedule.apply_spill``, an XLA scatter-add after its Pallas
kernel): on the card in the same launch, where each output element is
written once, each slot's spilled products fused-multiply-added in entry
order and the sum added once (:class:`SpillPlan`, :func:`spill_ordered`);
on the CPU by ``_Schedule.apply_spill`` after the plain version.

What bounds it on the H100: bytes. Each entry is read once as 12 bytes
(``in_pos``, ``out_pos``, ``val``): ~200 MB per pass at the ads shape
(16.7M entries), so ~60 us at 3.35 TB/s is the least it could take. That
is a bound, not a measurement; ``PERF.md`` has the measured times.

The kernel (``ops/csrc/bilinear_pass_core.cuh``, shared with K2) runs one
CTA per *work item* of :func:`plan_work`: a contiguous run of one output
block's entries, sized so that the pass fills the card once
(``ctas_per_sm`` resident CTAs on each SM) and no CTA walks more than its
share. A step's real entry count (:func:`step_sizes`) ends its walk, so
padding slots cost nothing. A pass whose gathers fall at random in the
window copies each window into shared memory; one whose gathers come in
order reads it through L1 (:func:`default_mode`). On a CUDA tensor
:func:`bilinear_pass` launches the kernel (built with ``nvcc`` for
``sm_90a`` at first use) or raises; only a CPU tensor takes the plain
version. ``launches`` counts kernel launches, ``spill_launches`` those that
folded a spill remainder in.

Determinism: the kernel adds in one fixed order. Each step's entries are
sorted by output slot (``tiled_sparse.sort_steps_by_output``); a CTA sums
each trip's runs of equal slots in a fixed tree and adds the run sums one
step after another; items that share an output block store their windows
in scratch rows (:func:`shared_items`), which a second kernel sums in item
order. So the same schedule and source give the same bits on every launch
and in every process. The order depends on the work plan, which depends on
the CTA target (the card's SMs times resident CTAs), so bits are fixed per
card model: a plan for another target (``launch_with``) cuts the items
elsewhere and may round otherwise. Against the plain version (``index_add_``
in entry order) the kernel agrees to f32 rounding (relative error ~1e-7 of
the output's scale, checked at 1e-5).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.ops.kernels.cuda_build import (
    load_kernel_library,
    timed_build,
)

Tensor = torch.Tensor

# Kernel launches on the CUDA path, and those of them that folded a
# spill remainder in (a run sets them to 0 and reads them).
launches = 0
spill_launches = 0

MAX_SHARED_BYTES = 227 * 1024  # the H100's opt-in per CTA

# Columns of a work item: output block, first step, first entry (of the
# first step), last step (inclusive), end entry (of the last step), and 1
# when the item is its block's only writer.
ITEM_COLUMNS = 6
# The kernel's work items carry one more column: the item's scratch row
# (-1 when it is its block's only writer).
KERNEL_ITEM_COLUMNS = 7
# Item boundaries inside a step fall on multiples of this many entries, so
# the kernel's 16-byte entry loads stay aligned.
ENTRY_ALIGN = 4


def step_sizes(vals: np.ndarray, num_steps: int) -> np.ndarray:
    """Real entries of each step [S] int32: the last slot of the step with
    a nonzero value, plus one (0 for a step without one). Both schedule
    builders fill a step's entries from slot 0 and pad with zero values,
    so this is the builder's chunk size; an explicit zero at a step's tail
    is skipped with the padding (it adds ``0 * src``)."""
    nz = np.asarray(vals)[:num_steps] != 0
    if nz.shape[1] == 0:
        return np.zeros(num_steps, np.int32)
    last = nz.shape[1] - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last, 0).astype(np.int32)


def gathers_in_order(in_pos: np.ndarray, sizes: np.ndarray, sample: int = 256) -> bool:
    """Whether the steps' entries read their input window in order: at
    least 90% of neighbouring real entries with a non-decreasing
    ``in_pos``, over up to ``sample`` steps spread through the schedule.
    Both builders keep the input's order within a tile, so this is the
    data's order: a z-pass over row-major rows reads its features at
    random, the g-pass reads its rows in order."""
    S = sizes.shape[0]
    steps = np.unique(np.linspace(0, S - 1, min(S, sample)).astype(np.int64))
    pos = np.asarray(in_pos)[steps]
    real = np.arange(1, pos.shape[1])[None, :] < sizes[steps][:, None]
    pairs = int(real.sum())
    rising = int((real & (np.diff(pos, axis=1) >= 0)).sum())
    return pairs > 0 and rising >= 0.9 * pairs


def plan_work(
    step_out: np.ndarray, sizes: np.ndarray, target: int, num_out_blocks: int,
    *, min_entries: int = 1,
) -> np.ndarray:
    """CTA work table [n_items, ITEM_COLUMNS] int32 for ``target`` CTAs.

    The pass's entries are cut into about ``min(target, entries /
    min_entries)`` items of equal size. An item never crosses an output
    block: a block gets ``round(its entries / share)`` items (at least one,
    so a block without entries is still written), cut at equal entry
    offsets rounded down to ``ENTRY_ALIGN`` within a step. A block with
    fewer steps than items splits its steps across CTAs. An item alone on
    its block writes the window with plain stores; items that share a
    block store theirs into scratch rows that a second launch sums in item
    order (:func:`shared_items`). A block of ``range(num_out_blocks)`` without
    steps gets an item without steps (last step = first step - 1), which
    writes its zero window, so every output element is written."""
    step_out = np.asarray(step_out)
    sizes = np.asarray(sizes).astype(np.int64)
    S = step_out.shape[0]
    total = int(sizes.sum())
    n_ctas = max(1, min(int(target), -(-total // max(int(min_entries), 1))))
    share = max(total / n_ctas, 1.0)
    heads = np.flatnonzero(np.diff(step_out, prepend=-1) != 0)  # block starts
    ends = np.r_[heads[1:], S]
    ends_at = np.cumsum(sizes)  # flat entry offset where each step ends
    starts_at = ends_at - sizes
    items = []
    for a, b in zip(heads.tolist(), ends.tolist()):
        block_entries = int(ends_at[b - 1] - starts_at[a])
        k = max(1, int(block_entries / share + 0.5))
        cuts = [(a, 0)]
        for i in range(1, k):
            flat = int(starts_at[a]) + block_entries * i // k
            s = a + int(np.searchsorted(ends_at[a:b], flat, side="right"))
            if s >= b:
                continue
            pos = (flat - int(starts_at[s])) // ENTRY_ALIGN * ENTRY_ALIGN
            if (s, pos) > cuts[-1]:
                cuts.append((s, pos))
        cuts.append((b, 0))
        sole = int(len(cuts) == 2)
        for (s0, p0), (s1, p1) in zip(cuts[:-1], cuts[1:]):
            if p1 == 0:  # ends at a step boundary: the end of step s1 - 1
                s1, p1 = s1 - 1, int(sizes[s1 - 1])
            items.append((int(step_out[a]), s0, p0, s1, p1, sole))
    for block in np.setdiff1d(np.arange(num_out_blocks), step_out).tolist():
        items.append((block, 0, 0, -1, 0, 1))
    return np.asarray(items, np.int32).reshape(-1, ITEM_COLUMNS)


def shared_items(items: np.ndarray):
    """The shared-item table of a plan: -> (rows [n_items] int32, shared
    [n_shared, 3] int32). An item that shares its output block with others
    stores its window into scratch row ``rows[i]`` (rows numbered in item
    order; -1 for an item alone on its block); ``shared`` lists each block
    with several items as (block, first row, rows), and the kernel's second
    launch sums those rows in a fixed order into the block. ``plan_work``
    emits a block's items one after another, so a block's rows are
    consecutive."""
    items = np.asarray(items).reshape(-1, ITEM_COLUMNS)
    sole = items[:, 5] != 0
    rows = np.where(sole, -1, np.cumsum(~sole) - 1).astype(np.int32)
    shared = []
    for i in np.flatnonzero(~sole).tolist():
        block = int(items[i, 0])
        if shared and shared[-1][0] == block and shared[-1][1] + shared[-1][2] == rows[i]:
            shared[-1][2] += 1
        else:
            shared.append([block, int(rows[i]), 1])
    return rows, np.asarray(shared, np.int32).reshape(-1, 3)


@dataclass(frozen=True)
class WorkPlan:
    """A schedule's work table on its device, for one CTA target: the items
    with their scratch rows [n_items, KERNEL_ITEM_COLUMNS] and the shared
    blocks [n_shared, 3] (:func:`shared_items`)."""

    items: Tensor  # int32 [n_items, KERNEL_ITEM_COLUMNS]
    shared: Tensor  # int32 [n_shared, 3]
    scratch_rows: int  # rows of the scratch windows the shared items store

    @property
    def num_items(self) -> int:
        return self.items.shape[0]

    @property
    def num_shared(self) -> int:
        return self.shared.shape[0]


def work_plan(items: np.ndarray, device) -> WorkPlan:
    """A WorkPlan on ``device`` from :func:`plan_work`'s table."""
    rows, shared = shared_items(items)
    table = np.concatenate([np.asarray(items, np.int32).reshape(-1, ITEM_COLUMNS),
                            rows[:, None]], axis=1)
    return WorkPlan(
        torch.as_tensor(np.ascontiguousarray(table), device=device),
        torch.as_tensor(shared, device=device),
        int(rows.max(initial=-1)) + 1,
    )


def make_plan(sched, target: int) -> WorkPlan:
    """``sched``'s work plan for ``target`` CTAs, made once per schedule
    and target and cached on the schedule (one read of its step table from
    the device the first time). An item holds at least a quarter window of
    entries: its walk then takes at least as many 16-byte trips as zeroing
    and flushing its window."""
    plan = sched.plans.get(int(target))
    if plan is None:
        items = plan_work(
            sched.step_out.cpu().numpy(), sched.step_sizes.cpu().numpy(),
            target, sched.num_out_blocks, min_entries=max(1, sched.window // 4),
        )
        plan = work_plan(items, sched.step_out.device)
        sched.plans[int(target)] = plan
    return plan


def bilinear_pass_plain(
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None
) -> Tensor:
    """The same function in plain PyTorch: one flat ``index_select`` times
    the values, then ``index_add_`` over ``step * W + pos`` (the reference's
    grid pass with one source column)."""
    G = sched.step_out.shape[0]
    v = (sched.vals if vals is None else vals)[:G].reshape(-1)
    flat_in = (
        sched.step_in[:, None].long() * window + sched.in_pos[:G]
    ).reshape(-1)
    flat_out = (
        sched.step_out[:, None].long() * window + sched.out_pos[:G]
    ).reshape(-1)
    out = torch.zeros(num_out_blocks * window, dtype=src.dtype, device=src.device)
    return out.index_add_(0, flat_out, v * src.index_select(0, flat_in))


def check_operands(kernel: str, sched, num_out_blocks: int, window: int, vals):
    """Checks a pass makes before its kernel reads ``sched`` unchecked:
    ``num_out_blocks`` and ``window`` are those the schedule's indices were
    checked against, and the entry arrays share one shape. -> the values."""
    if window != sched.window or num_out_blocks != sched.num_out_blocks:
        raise ValueError(
            f"{kernel}: window {window} and {num_out_blocks} output "
            f"blocks, but the schedule was checked for window {sched.window} "
            f"and {sched.num_out_blocks} output blocks"
        )
    v = sched.vals if vals is None else vals
    if v.shape != sched.in_pos.shape or sched.out_pos.shape != sched.in_pos.shape:
        raise ValueError(f"{kernel}: entry arrays differ in shape")
    return v


def check_cuda_operands(kernel: str, sched, v: Tensor, src: Tensor) -> None:
    """Device, type and contiguity of what a CUDA pass hands the kernel."""
    tensors = {
        "step_in": (sched.step_in, torch.int32),
        "step_sizes": (sched.step_sizes, torch.int32),
        "in_pos": (sched.in_pos, torch.int32),
        "out_pos": (sched.out_pos, torch.int32),
        "vals": (v, torch.float32),
        "src": (src, torch.float32),
    }
    for name, (t, dtype) in tensors.items():
        if t.device != src.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, src on {src.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if sched.step_sizes.shape != sched.step_out.shape:
        raise ValueError(f"{kernel}: step_sizes must be [{sched.num_steps}]")


def vector_loads(sched, v: Tensor) -> bool:
    """Whether the kernel may read entries 4 at a time: rows of a multiple
    of 4 entries, 16-byte aligned."""
    return sched.in_pos.shape[1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (sched.in_pos, sched.out_pos, v)
    )


_sms: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (asked once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def bilinear_pass(
    sched, src: Tensor, num_out_blocks: int, window: int, vals: Tensor = None,
    spill: bool = False, spill_vals: Tensor = None,
) -> Tensor:
    """Apply a schedule to the flat ``src``; -> flat [num_out_blocks * W].

    ``sched`` is a ``_Schedule`` of ``ops/tiled_sparse.py``; ``vals``
    overrides its entry values (the Hessian diagonal squares them).
    ``spill``: add the schedule's spill remainder too, ``spill_vals``
    overriding its values (in the schedule's spill order). ``src``,
    ``num_out_blocks`` and ``window`` must be those the schedule's indices
    were checked against: the kernel reads and adds unchecked."""
    v = check_operands("bilinear_pass", sched, num_out_blocks, window, vals)
    if src.dim() != 1 or src.shape[0] != sched.num_in_blocks * window:
        raise ValueError(
            f"bilinear_pass: src must be flat [{sched.num_in_blocks} * "
            f"{window}], got {tuple(src.shape)}"
        )
    if src.device.type == "cpu":
        out = bilinear_pass_plain(sched, src, num_out_blocks, window, vals)
        return sched.apply_spill(out, src, vals=spill_vals) if spill else out
    if src.device.type != "cuda":
        raise ValueError(f"bilinear_pass: unsupported device {src.device}")
    return launch(sched, src, num_out_blocks, window, v,
                  spill_operands(sched, spill_vals) if spill else None)


# Threads per CTA of K1 (the kernel's kThreads).
THREADS = 512
# How a CTA reads the source windows (the kernel's Mode): copied into shared
# memory step by step, or gathered through L1.
STAGED, GATHERED = 0, 1


def default_mode(sched) -> int:
    """How a pass reads its source windows: where a step's entries read
    the window in order (``sched.ordered_gathers``) a warp's gathers share
    L1 lines, so they go through L1 (``GATHERED``); where they fall at
    random each lane would take an L1 line of its own, so the window is
    copied into shared memory (``STAGED``), where three windows fit."""
    window = sched.window
    stageable = window % 4 == 0 and 3 * 4 * window <= MAX_SHARED_BYTES
    return STAGED if stageable and not sched.ordered_gathers else GATHERED


_occupancy: dict = {}  # (window, vec, mode) -> CTAs per SM


def ctas_per_sm(window: int, vec: bool, mode: int) -> int:
    """Resident CTAs of K1 on one SM at this window (the CUDA occupancy
    calculator, asked once per configuration). Raises when the window does
    not fit shared memory."""
    key = (window, bool(vec), mode)
    if key not in _occupancy:
        if window * 4 * (3 if mode == STAGED else 1) > MAX_SHARED_BYTES:
            raise ValueError(f"bilinear_pass: window {window} exceeds shared memory")
        n = ctypes.c_int()
        _call(0, 0, None, 0, None, None, None, None, None, None, 0, None,
              None, window, int(vec), mode, *spill_pointers(None), n, None)
        _occupancy[key] = n.value
    return _occupancy[key]


@dataclass(frozen=True)
class LaunchConfig:
    """How a pass launches: its work plan, the kernel's resident CTAs per
    SM, 16-byte entry loads, the source-window mode, threads per CTA and
    (K2) members per CTA and member tiles."""

    plan: WorkPlan
    ctas_per_sm: int
    vec: bool
    mode: int
    threads: int
    members_per_cta: int = 1
    tiles: int = 1

    @property
    def ctas(self) -> int:
        return self.plan.num_items * self.tiles


def launch_config(sched, v: Tensor, device: torch.device) -> LaunchConfig:
    """The launch of a pass over ``sched`` with values ``v``: 16-byte entry
    loads where the entry arrays allow them, the schedule's source-window
    mode (:func:`default_mode`), and a plan for every resident CTA slot of
    the card (SMs x resident CTAs per SM). Made once per schedule and load
    width, and cached on the schedule beside its plans."""
    vec = vector_loads(sched, v)
    key = ("k1", vec)
    cfg = sched.plans.get(key)
    if cfg is None:
        mode = default_mode(sched)
        per_sm = ctas_per_sm(sched.window, vec, mode)
        plan = make_plan(sched, sm_count(device) * per_sm)
        cfg = sched.plans[key] = LaunchConfig(plan, per_sm, vec, mode, THREADS)
    return cfg


def launch(
    sched, src: Tensor, num_out_blocks: int, window: int, v: Tensor, spill=None
) -> Tensor:
    """The CUDA launch behind :func:`bilinear_pass`; ``spill``:
    :func:`spill_operands`' (plan, values), or None."""
    check_cuda_operands("bilinear_pass", sched, v, src)
    cfg = launch_config(sched, v, src.device)
    return launch_with(cfg, sched, src, num_out_blocks, window, v, spill)


def launch_with(
    cfg: LaunchConfig, sched, src: Tensor, num_out_blocks: int, window: int, v: Tensor,
    spill=None,
) -> Tensor:
    """Launch K1 over ``sched`` as ``cfg`` says (:func:`launch` passes
    :func:`launch_config`'s; ``tools/pass_ablation.py`` times others) on
    operands :func:`launch` has checked, the spill remainder folded in
    where ``spill`` (:func:`spill_operands`) is given; -> the output."""
    global launches, spill_launches
    n_out = num_out_blocks * window
    out = torch.empty(n_out, dtype=torch.float32, device=src.device)
    scratch = scratch_for(cfg.plan, 1, window, src.device)
    n = ctypes.c_int()
    _call(
        cfg.plan.items.data_ptr(), cfg.plan.num_items,
        cfg.plan.shared.data_ptr(), cfg.plan.num_shared, scratch.data_ptr(),
        sched.step_in.data_ptr(),
        sched.step_sizes.data_ptr(), sched.in_pos.data_ptr(),
        sched.out_pos.data_ptr(), v.data_ptr(), sched.in_pos.shape[1],
        src.data_ptr(), out.data_ptr(), window, int(cfg.vec), cfg.mode,
        *spill_pointers(spill), n, torch.cuda.current_stream(src.device).cuda_stream,
    )
    launches += 1
    spill_launches += spill is not None
    return out


def scratch_for(plan: WorkPlan, members: int, window: int, device) -> Tensor:
    """The scratch windows of a plan's shared items, [rows, members, W]
    (written in full by the pass before its reduction reads them)."""
    return torch.empty(
        max(plan.scratch_rows, 1) * members * window, dtype=torch.float32,
        device=device,
    )


@dataclass(frozen=True)
class SpillPlan:
    """A schedule's spilled entries sorted by output (stably, once per
    schedule), as K1 and K2 fold them into a pass: ``order`` sorts them,
    ``offsets`` [n_slots + 1] bound each output slot's run, ``slots`` are
    the slots (flat output coordinates, ascending), ``map`` gives each
    output element its slot or -1 (the kernels read each column's, one
    thread a column), ``in_pos`` and ``vals`` the sorted entries' source
    coordinates and values; int32 and on the device."""

    order: Tensor
    offsets: Tensor
    slots: Tensor
    map: Tensor
    in_pos: Tensor
    vals: Tensor

    @property
    def num_segments(self) -> int:
        return self.slots.shape[0]


def spill_plan(
    spill_out: Tensor, spill_in: Tensor, spill_vals: Tensor, window: int, num_out_blocks: int
) -> SpillPlan:
    """The :class:`SpillPlan` of a schedule's spill arrays (the sort of
    ``ops/fixed_order.segment_plan``, in the kernels' int32), its map over
    ``num_out_blocks`` windows of ``window``."""
    from photon_ml_tpu_torch.ops.fixed_order import segment_plan

    seg = segment_plan(spill_out)
    slot_map = torch.full((num_out_blocks * window,), -1, dtype=torch.int32,
                          device=spill_out.device)
    slot_map[seg.slots] = torch.arange(seg.slots.shape[0], dtype=torch.int32,
                                       device=spill_out.device)
    return SpillPlan(
        seg.order, seg.offsets.to(torch.int32), seg.slots.to(torch.int32), slot_map,
        spill_in.index_select(0, seg.order).to(torch.int32).contiguous(),
        spill_vals.index_select(0, seg.order).contiguous(),
    )


def spill_operands(sched, spill_vals: Optional[Tensor] = None) -> Optional[Tuple[SpillPlan, Tensor]]:
    """What a pass over ``sched`` hands its kernel to fold the spill
    remainder in: (the schedule's :class:`SpillPlan`, made once and cached
    in ``sched.plans``, the values in its order: ``spill_vals`` sorted by
    it where given), or None for a schedule without spills."""
    if sched.spill_vals.shape[0] == 0:
        return None
    plan = sched.plans.get("spill")
    if plan is None:
        plan = sched.plans["spill"] = spill_plan(
            sched.spill_out, sched.spill_in, sched.spill_vals, sched.window,
            sched.num_out_blocks)
    if spill_vals is None:
        return plan, plan.vals
    return plan, spill_vals.index_select(0, plan.order).contiguous()


def spill_pointers(spill) -> Tuple:
    """The kernels' four spill operands (the slot map, entry offsets,
    source coordinates, values) of :func:`spill_operands`' pair, or four
    nulls."""
    if spill is None:
        return (None,) * 4
    plan, vals = spill
    if vals.dtype != torch.float32 or vals.shape != plan.in_pos.shape:
        raise ValueError("bilinear_pass: spill values must be float32, one a spilled entry")
    return (plan.map.data_ptr(), plan.offsets.data_ptr(), plan.in_pos.data_ptr(),
            vals.data_ptr())


def fma_rn(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` of float32 tensors rounded once, as the card's
    ``__fmaf_rn``, in plain PyTorch: the product is exact in float64, the
    float64 sum's rounding error comes from Knuth's two-sum, and a float64
    sum that lands on a point halfway between two float32 numbers (the only
    place where rounding twice can differ from once) is rounded to the side
    where the exact sum lies."""
    p = a.double() * b.double()
    s = c.double()
    r = p + s
    z = r - p
    err = (p - (r - z)) + (s - z)
    f = r.float()
    above = f.double() > r
    lo = torch.where(above, torch.nextafter(f, torch.full_like(f, -float("inf"))), f)
    hi = torch.where(above, f, torch.nextafter(f, torch.full_like(f, float("inf"))))
    tie = (err != 0) & (r == (lo.double() + hi.double()) * 0.5)
    return torch.where(tie, torch.where(err > 0, hi, lo), f)


def spill_ordered(out: Tensor, src: Tensor, plan: SpillPlan, vals: Optional[Tensor] = None) -> Tensor:
    """The spill remainder in the kernels' order, in plain PyTorch, in
    place over the last axis of a vector or a bank: each slot's sum starts
    at 0 and takes each spilled entry's ``vals * src[in_pos]`` in entry
    order by a fused multiply-add (:func:`fma_rn`), then is added to the
    slot once; slots without a spill are left as they are. A pass with its
    spill folded in gives the bits of the same pass without it followed by
    this. ``vals``: values in the plan's order (default its own). The
    slots' run lengths come to the host in one counted fetch; the sums then
    advance one entry of every run still open at a time, longest runs
    first."""
    from photon_ml_tpu_torch.parallel.overlap import device_get

    if plan.in_pos.shape[0] == 0:
        return out
    (offsets,) = device_get([plan.offsets])
    runs = np.diff(offsets.astype(np.int64))
    order = np.argsort(-runs, kind="stable")  # longest first
    by_length = np.sort(runs)
    open_runs = [len(runs) - int(np.searchsorted(by_length, j, side="right"))
                 for j in range(int(by_length[-1]))]  # runs longer than j
    first = offsets[:-1][order]
    take = torch.as_tensor(np.concatenate([first[:n] + j for j, n in enumerate(open_runs)]),
                           device=out.device)
    v = (plan.vals if vals is None else vals).index_select(0, take)
    x = src.index_select(-1, plan.in_pos.index_select(0, take))
    v = v.expand(x.shape)
    sums = x.new_zeros(x.shape[:-1] + (len(runs),))
    at = 0
    for n in open_runs:
        sums[..., :n] = fma_rn(v[..., at:at + n], x[..., at:at + n], sums[..., :n])
        at += n
    slots = plan.slots.long()[torch.as_tensor(order, device=out.device)]
    out[..., slots] = out[..., slots] + sums
    return out


def _call(*args) -> None:
    lib = _kernel_lib()
    rc = lib.photon_bilinear_pass(*args[:-2], ctypes.byref(args[-2]), args[-1])
    if rc != 0:
        msg = lib.photon_cuda_error_string(rc).decode()
        raise RuntimeError(f"bilinear_pass launch failed: {msg} ({rc})")


def _declare(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.photon_bilinear_pass.restype = i
    lib.photon_bilinear_pass.argtypes = [
        p, i, p, i, p, p, p, p, p, p, i, p, p, i, i, i, p, p, p, p,
        ctypes.POINTER(i), p,
    ]
    lib.photon_cuda_error_string.restype = ctypes.c_char_p
    lib.photon_cuda_error_string.argtypes = [i]


def _kernel_lib():
    return load_kernel_library("bilinear_pass.cu", _declare)


def build_kernel() -> float:
    """Compile the kernel (if its library is older than its sources) and
    load it; -> seconds spent. Raises when ``nvcc`` fails."""
    return timed_build(_kernel_lib)
