"""Tiled sparse GLM data and objective (port of the host side of
``photon_ml_tpu/ops/tiled_sparse.py``).

Entries are binned into (row window x feature window) tiles, windows
``W = S_HI * S_LO`` positions wide. The schedule of each pass (tile
assignment, chunking into steps of ``L`` entries, window-local positions)
is built ONCE on the host per dataset, in the JAX package's exact array
format, and applied on every evaluation by K1, the bilinear pass
(``ops/kernels/bilinear_pass.py``):

- the z-pass walks entries sorted by row block: raw margins ``X . w``;
- the g-pass walks them sorted by feature block: ``X^T . c`` for the
  gradient and each Hessian-vector product, and, over squared values, the
  Hessian diagonal.

Over a coefficient bank ``[G, d]`` (the batched λ-grid) every pass goes
to K2, the grid pass (``ops/kernels/grid_bilinear_pass.py``), which reads
the schedule once for the whole bank; only the source is batched, never
the schedule or its values (the reference's ``custom_vmap`` rule,
``photon_ml_tpu/ops/tiled_sparse.py:1583-1601``).

Tile tails too small for a step are "spilled" to an exact remainder,
which every pass adds to its output: on the card K1 and K2 fold it into the
same launch (``bilinear_pass.SpillPlan``); on the CPU
``_Schedule.apply_spill`` adds it after the plain pass.

On a mesh of ranks a rank builds only its part of the reference's mesh
layouts: its shard of the rows over every feature
(:func:`build_sharded_tiled_batch`, the data-parallel fit) or its (data
shard x feature block) cell (:func:`feature_shard_tiled_batch`, the
feature-sharded fit), resolving the chunk from the global counts as the
reference does.

The schedule builder is the native counting sort of
``native/tile_schedule.cpp`` (compiled with g++ into the port's build
directory and loaded with ctypes), with a numpy builder that is its oracle
and its fallback. With a schedule cache directory configured
(``ops/schedule_cache.py``, ``tile_cache_dir=`` on the trainers) a built
schedule is stored and a stored one loaded in place of the build.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import SparseBatch
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.kernels.bilinear_pass import (
    bilinear_pass,
    gathers_in_order,
    step_sizes,
)
from photon_ml_tpu_torch.ops.kernels.grid_bilinear_pass import grid_bilinear_pass
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext,
    identity_context,
)
from photon_ml_tpu_torch.ops.objective import per_member, squared_norm, sum_partials
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS
from photon_ml_tpu_torch.utils.device import DeviceLike, build_dir, resolve_device

Tensor = torch.Tensor


@dataclass(frozen=True)
class TileParams:
    """Window shape and step width. The defaults and the ``chunk=None``
    sizing rule are the JAX package's, so both build the same schedule."""

    s_hi: int = 128
    s_lo: int = 64
    chunk: Optional[int] = None  # entries per step; None = from the data
    # Tile remainders of at most this many entries go to the spill path;
    # None = chunk // 16, 0 disables spilling.
    spill_cap: Optional[int] = None

    @property
    def window(self) -> int:
        return self.s_hi * self.s_lo

    def resolved_spill_cap(self) -> int:
        if self.spill_cap is not None:
            return self.spill_cap
        return max(0, (self.chunk or 0) // 16)

    def resolved(self, n_entries: int, n_tiles_hint: int) -> "TileParams":
        """Fix ``chunk=None`` from the mean tile occupancy: with spilling
        and at most 4096 entries per tile, mean + 2 sqrt(mean) rounded up
        to a multiple of 128 (capped at 4608); otherwise the nearest power
        of two in [min(1024, W), 4096]."""
        if self.chunk is not None:
            return self
        avg = max(1, n_entries // max(n_tiles_hint, 1))
        lo = min(1024, self.window)
        spilling = self.spill_cap is None or self.spill_cap > 0
        if spilling and avg <= 4096:
            c = int(-(-int(avg + 2.0 * np.sqrt(avg)) // 128) * 128)
            c = max(lo, min(4608, c))
        else:
            c = 1 << int(np.round(np.log2(avg)))
            c = max(lo, min(4096, c))
        return dataclasses.replace(self, chunk=c)


@dataclass
class _Schedule:
    """One pass's static schedule: steps of ``L`` entries sorted by output
    block (the JAX package's ``_Schedule`` arrays, as tensors).

    ``step_sizes`` are the steps' real entry counts (K1 and K2 end a
    step's walk there); ``ordered_gathers`` says whether a step's entries
    read their input window in order (``gathers_in_order``: the kernels
    then read it through L1 rather than copy it); ``plans`` caches K1's and
    K2's CTA work tables (``make_plan``), one per CTA target, on the
    schedule's device, and their launch configurations (``launch_config``). The window and block counts are those the indices
    were checked against; the kernels' wrappers hold their operands to
    them."""

    step_out: Tensor  # int32 [G] output block per step
    step_in: Tensor  # int32 [G] input block per step
    step_init: Tensor  # int32 [G] 1 iff first step of its output block
    out_pos: Tensor  # int32 [G8, L] window-local output position
    in_pos: Tensor  # int32 [G8, L] window-local input position
    vals: Tensor  # float32 [G8, L] (0 for padding slots)
    spill_out: Tensor  # int32 [S] flat output coordinate
    spill_in: Tensor  # int32 [S] flat input coordinate
    spill_vals: Tensor  # float32 [S] (0 for padding)
    step_sizes: Tensor  # int32 [G] real entries of each step
    window: int
    num_out_blocks: int
    num_in_blocks: int
    ordered_gathers: bool = False
    plans: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_steps(self) -> int:
        return self.step_out.shape[0]

    @classmethod
    def from_numpy(
        cls, arrays, *, window: int, num_out_blocks: int, num_in_blocks: int,
        device, companions=(),
    ) -> "_Schedule":
        """Nine schedule arrays (JAX package order) -> a checked schedule
        on ``device``, each step's entries sorted by output slot
        (:func:`sort_steps_by_output`: the order K1 and K2 add in). K1
        indexes shared memory and the source with these arrays unchecked,
        so every index is validated here. ``companions``: more ``[G8, L]``
        entry arrays (the squared values) to sort with the entries; with
        any, -> (schedule, [sorted companions])."""
        (
            step_out, step_in, step_init, o_pos, i_pos, sv,
            sp_out, sp_in, sp_vals,
        ) = (np.asarray(a) for a in arrays)
        _check_schedule(
            step_out, step_in, step_init, o_pos, i_pos, sv,
            sp_out, sp_in, sp_vals, window=window,
            num_out_blocks=num_out_blocks, num_in_blocks=num_in_blocks,
        )

        def t(a, dtype):
            return _to_tensor(a, dtype, device)

        sizes = step_sizes(sv, step_out.shape[0])
        o_pos, i_pos, sv, *more = sort_steps_by_output(
            sizes, window, o_pos, i_pos, sv, *companions
        )
        sched = cls(
            t(step_out, np.int32), t(step_in, np.int32),
            t(step_init, np.int32), t(o_pos, np.int32), t(i_pos, np.int32),
            t(sv, np.float32), t(sp_out, np.int32), t(sp_in, np.int32),
            t(sp_vals, np.float32), t(sizes, np.int32),
            window, num_out_blocks, num_in_blocks,
            gathers_in_order(i_pos, sizes),
        )
        return (sched, more) if companions else sched

    def to(self, device) -> "_Schedule":
        """On ``device``; the schedule itself (with its cached work plans)
        where every tensor is there already."""
        moved = {
            f.name: v.to(device) for f in dataclasses.fields(self)
            if isinstance(v := getattr(self, f.name), Tensor)
        }
        if all(moved[name] is getattr(self, name) for name in moved):
            return self
        return dataclasses.replace(self, plans={}, **moved)

    def apply_spill(
        self, out_flat: Tensor, src_flat: Tensor, vals: Optional[Tensor] = None
    ) -> Tensor:
        """out_flat[spill_out] += spill_vals * src_flat[spill_in], in place
        (the exact remainder completing a pass's partial sums), over the
        last axis, so a bank [G, n] takes it row by row. ``vals``
        overrides the values (the Hessian diagonal squares them). The CPU
        path of every pass: ``index_add_`` adds the entries one by one in
        entry order. On the card a pass folds the remainder into its own
        launch (``bilinear_pass(spill=True)``), so a CUDA tensor raises."""
        if out_flat.device.type != "cpu":
            raise ValueError(
                f"apply_spill: the CPU path only, got {out_flat.device}; on the card "
                "a pass folds the spill in (bilinear_pass(spill=True))"
            )
        if self.spill_vals.shape[0] == 0:
            return out_flat
        v = self.spill_vals if vals is None else vals
        return out_flat.index_add_(
            -1, self.spill_out, v * src_flat.index_select(-1, self.spill_in)
        )


def sort_steps_by_output(sizes: np.ndarray, window: int, *entries: np.ndarray):
    """Each step's real entries (slot < ``sizes[s]``) in order of output
    slot, stably, in every ``[G8, L]`` array of ``entries`` (the first is
    ``out_pos``); padding slots stay at the steps' ends and padding rows as
    they are. The function a schedule computes is unchanged, and so is the
    plain version's order of additions into each output (entry order
    within a slot). K1 and K2 rely on it: a trip's entries for one slot of
    one step are adjacent, so the kernels sum them as one run. Arrays
    already in that order (a z-pass over rows in order) come back as they
    are."""
    o_pos = np.asarray(entries[0])
    S, L = sizes.shape[0], o_pos.shape[1]
    if S == 0 or L == 0:
        return [np.asarray(e) for e in entries]
    # the padding key sorts after every slot; torch sorts and gathers the
    # rows on every host core
    key = torch.from_numpy(
        o_pos[:S].astype(np.int16 if window < np.iinfo(np.int16).max else np.int32)
    )
    key[torch.arange(L)[None, :] >= torch.from_numpy(np.asarray(sizes))[:, None]] = window
    if not bool((key[:, 1:] < key[:, :-1]).any()):
        return [np.asarray(e) for e in entries]
    order = torch.sort(key, dim=1, stable=True).indices
    del key
    out = []
    for e in entries:
        e = np.asarray(e)
        sorted_e = np.empty_like(e)
        rows = np.ascontiguousarray(e[:S])
        if not rows.flags.writeable:  # a cached schedule's mapped arrays
            rows = rows.copy()
        sorted_e[:S] = torch.gather(torch.from_numpy(rows), 1, order).numpy()
        sorted_e[S:] = e[S:]
        out.append(sorted_e)
    return out


def _to_tensor(a, dtype, device) -> Tensor:
    """numpy -> tensor on ``device`` (copied when read-only or strided)."""
    return torch.as_tensor(np.require(a, dtype, ["C", "W"]), device=device)


def _check_schedule(
    step_out, step_in, step_init, o_pos, i_pos, sv, sp_out, sp_in, sp_vals,
    *, window, num_out_blocks, num_in_blocks,
):
    G = step_out.shape[0]
    G8 = o_pos.shape[0]
    if not (step_in.shape == step_init.shape == (G,)):
        raise ValueError("schedule step arrays differ in length")
    if G8 < G or i_pos.shape != o_pos.shape or sv.shape != o_pos.shape:
        raise ValueError("schedule entry arrays do not cover the steps")
    if not (sp_out.shape == sp_in.shape == sp_vals.shape):
        raise ValueError("schedule spill arrays differ in length")
    for name, a, hi in (
        ("step_out", step_out, num_out_blocks),
        ("step_in", step_in, num_in_blocks),
        ("out_pos", o_pos, window),
        ("in_pos", i_pos, window),
        ("spill_out", sp_out, num_out_blocks * window),
        ("spill_in", sp_in, num_in_blocks * window),
    ):
        if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
            raise ValueError(f"schedule {name} out of range [0, {hi})")
    if G and np.any(np.diff(step_out) < 0):
        raise ValueError("schedule steps are not sorted by output block")
    expect_init = np.ones(G, np.int32)
    expect_init[1:] = step_out[1:] != step_out[:-1]
    if not np.array_equal(step_init, expect_init):
        raise ValueError("schedule step_init does not mark block starts")


# ---------------------------------------------------------------------------
# Schedule builders
# ---------------------------------------------------------------------------

_TILE_LIB_LOCK = threading.Lock()
_tile_lib_handle = None  # None = untried, False = unavailable


def _native_source() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "native", "tile_schedule.cpp")


def _tile_lib():
    """ctypes handle to ``native/tile_schedule.cpp``, compiled with g++ into
    the port's build directory at first use; False when the source or the
    compiler is missing (callers then use the numpy builder)."""
    global _tile_lib_handle
    if _tile_lib_handle is not None:
        return _tile_lib_handle
    with _TILE_LIB_LOCK:
        if _tile_lib_handle is not None:
            return _tile_lib_handle
        src = _native_source()
        lib_dir = build_dir()
        lib_path = os.path.join(lib_dir, "libtile_schedule.so")
        try:
            if not (
                os.path.isfile(lib_path)
                and os.path.getmtime(lib_path) >= os.path.getmtime(src)
            ):
                os.makedirs(lib_dir, exist_ok=True)
                # temp path + atomic rename: another process never loads a
                # half-written library
                tmp_path = f"{lib_path}.{os.getpid()}.tmp"
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        src, "-o", tmp_path,
                    ],
                    check=True, capture_output=True,
                )
                os.replace(tmp_path, lib_path)
            lib = ctypes.CDLL(lib_path)
        except (OSError, subprocess.CalledProcessError):
            _tile_lib_handle = False
            return _tile_lib_handle
        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(i64)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        lib.ts_plan.restype = i64
        lib.ts_plan.argtypes = [
            p_i64, p_i64, i64, i64, i64, i64, i64, p_i64, p_i64,
        ]
        lib.ts_fill.restype = i64
        lib.ts_fill.argtypes = [
            p_i64, p_i64, p_f32, i64, i64, i64, i64, i64, i64, i64,
            p_i32, p_i32, p_i32, p_i32, p_i32, p_f32,
            p_i32, p_i32, p_f32,
        ]
        _tile_lib_handle = lib
    return _tile_lib_handle


def _pad_spill_np(sp_out, sp_in, sp_vals):
    """Zero-pad spill arrays to a multiple of 128; padding entries carry
    val 0 at coordinate 0 (inert adds)."""
    s = len(sp_vals)
    target = ((s + 127) // 128) * 128
    if target != s:
        sp_out = np.concatenate([sp_out, np.zeros(target - s, np.int32)])
        sp_in = np.concatenate([sp_in, np.zeros(target - s, np.int32)])
        sp_vals = np.concatenate([sp_vals, np.zeros(target - s, np.float32)])
    return sp_out, sp_in, sp_vals


def _build_schedule_native(
    rows, feats, vals, *, params: TileParams, sort_by_feature_block: bool,
    num_out_blocks: int,
) -> Optional[Tuple[np.ndarray, ...]]:
    """Counting-sort build in C++; None when the library is unavailable or
    the tile space is too large for a counting sort."""
    lib = _tile_lib()
    if not lib:
        return None
    oc, ic = (feats, rows) if sort_by_feature_block else (rows, feats)
    oc = np.ascontiguousarray(oc, dtype=np.int64)
    ic = np.ascontiguousarray(ic, dtype=np.int64)
    v = np.ascontiguousarray(vals, dtype=np.float32)
    n = oc.shape[0]
    L = params.chunk
    win = params.window

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    cap = params.resolved_spill_cap()
    # flat spill coordinates must fit int32 (the numpy builder's bound)
    if cap and n and (
        (int(oc.max()) // win) * win + win >= 2**31
        or (int(ic.max()) // win) * win + win >= 2**31
    ):
        cap = 0
    steps_out = ctypes.c_int64()
    spilled_out = ctypes.c_int64()
    rc = lib.ts_plan(
        p(oc, i64), p(ic, i64), n, win, L, cap, num_out_blocks,
        ctypes.byref(steps_out), ctypes.byref(spilled_out),
    )
    if rc != 0:
        return None
    G = steps_out.value
    S = spilled_out.value
    G8 = ((G + 7) // 8) * 8
    step_out = np.zeros(G, np.int32)
    step_in = np.zeros(G, np.int32)
    step_init = np.zeros(G, np.int32)
    o_pos = np.zeros((G8, L), np.int32)
    i_pos = np.zeros((G8, L), np.int32)
    sv = np.zeros((G8, L), np.float32)
    sp_out = np.zeros(S, np.int32)
    sp_in = np.zeros(S, np.int32)
    sp_vals = np.zeros(S, np.float32)
    rc = lib.ts_fill(
        p(oc, i64), p(ic, i64), p(v, f32), n, win, L, cap,
        num_out_blocks, G, S,
        p(step_out, i32), p(step_in, i32), p(step_init, i32),
        p(o_pos, i32), p(i_pos, i32), p(sv, f32),
        p(sp_out, i32), p(sp_in, i32), p(sp_vals, f32),
    )
    if rc != 0:
        return None
    sp_out, sp_in, sp_vals = _pad_spill_np(sp_out, sp_in, sp_vals)
    return (step_out, step_in, step_init, o_pos, i_pos, sv, sp_out, sp_in, sp_vals)


def _build_schedule_numpy(
    rows, feats, vals, *, params: TileParams, sort_by_feature_block: bool,
    num_out_blocks: int,
) -> Tuple[np.ndarray, ...]:
    """The numpy schedule builder (the native builder's oracle): a stable
    sort by tile, the spill rule, chunking, and one zero-entry init step for
    every output block without data."""
    win = params.window
    L = params.chunk
    if len(rows) and int(rows.max()) < 2**31 and int(feats.max()) < 2**31:
        rows = rows.astype(np.int32, copy=False)
        feats = feats.astype(np.int32, copy=False)
    rb = rows // win
    fb = feats // win
    if sort_by_feature_block:
        key = fb.astype(np.int64) * (int(rb.max(initial=0)) + 1) + rb
        order = np.argsort(key, kind="stable")
        out_blocks, in_blocks = fb[order], rb[order]
        out_pos, in_pos = feats[order] % win, rows[order] % win
    else:
        key = rb.astype(np.int64) * (int(fb.max(initial=0)) + 1) + fb
        order = np.argsort(key, kind="stable")
        out_blocks, in_blocks = rb[order], fb[order]
        out_pos, in_pos = rows[order] % win, feats[order] % win
    v = vals[order]
    n_ent = len(v)
    cap = params.resolved_spill_cap()
    sp_out = np.zeros(0, np.int32)
    sp_in = np.zeros(0, np.int32)
    sp_vals = np.zeros(0, np.float32)

    if n_ent:
        # chunks never cross a tile boundary; the sort key is the tile id
        tile_key = key[order]
        tile_starts = np.nonzero(
            np.concatenate([[True], tile_key[1:] != tile_key[:-1]])
        )[0]
        tile_ends = np.concatenate([tile_starts[1:], [n_ent]])
        sizes_t = tile_ends - tile_starts
        if cap and (
            int(out_blocks.max(initial=0)) * win + win >= 2**31
            or int(in_blocks.max(initial=0)) * win + win >= 2**31
        ):
            cap = 0  # flat spill coordinates must fit int32
        # whole tiny tiles spill; otherwise a small remainder past the last
        # full chunk spills (each tile's tail in stable order)
        full = sizes_t // L
        rem = sizes_t % L
        spill_all = sizes_t <= cap
        spill_tail = (~spill_all) & (rem > 0) & (rem <= cap) & (full >= 1)
        n_spill_t = np.where(spill_all, sizes_t, np.where(spill_tail, rem, 0))
        kept_t = sizes_t - n_spill_t
        n_chunks = -(-kept_t // L)
        if int(n_spill_t.sum()):
            pos_in_tile = np.arange(n_ent) - np.repeat(tile_starts, sizes_t)
            is_spill = pos_in_tile >= np.repeat(kept_t, sizes_t)
            sp_out = (
                out_blocks[is_spill].astype(np.int64) * win + out_pos[is_spill]
            ).astype(np.int32)
            sp_in = (
                in_blocks[is_spill].astype(np.int64) * win + in_pos[is_spill]
            ).astype(np.int32)
            sp_vals = v[is_spill].astype(np.float32)
            keep = ~is_spill
            out_blocks, in_blocks = out_blocks[keep], in_blocks[keep]
            out_pos, in_pos, v = out_pos[keep], in_pos[keep], v[keep]
            n_ent = len(v)
            tile_starts = np.concatenate(
                [[0], np.cumsum(kept_t)[:-1]]
            ).astype(tile_starts.dtype)
            tile_ends = tile_starts + kept_t
        live = n_chunks > 0
        tile_starts, tile_ends = tile_starts[live], tile_ends[live]
        n_chunks = n_chunks[live]
        G_data = int(n_chunks.sum())
        rep_start = np.repeat(tile_starts, n_chunks)
        rep_end = np.repeat(tile_ends, n_chunks)
        first = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
        ordinal = np.arange(G_data) - np.repeat(first, n_chunks)
        chunk_start = rep_start + ordinal * L
        chunk_end = np.minimum(chunk_start + L, rep_end)
        so_data = out_blocks[rep_start].astype(np.int32)
        si_data = in_blocks[chunk_start].astype(np.int32)
        sizes = chunk_end - chunk_start
        entry_step = np.repeat(np.arange(G_data), sizes)
        slot = np.arange(n_ent) - np.repeat(chunk_start, sizes)
    else:
        G_data = 0
        so_data = np.zeros(0, np.int32)
        si_data = np.zeros(0, np.int32)

    # every output block gets at least one step (zero-entry init steps for
    # blocks without data), merged in by a stable sort on the output block
    present = np.zeros(num_out_blocks, bool)
    if G_data:
        present[so_data] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    G = G_data + len(missing)
    so_all = np.concatenate([so_data, missing])
    si_all = np.concatenate([si_data, np.zeros(len(missing), np.int32)])
    perm = np.argsort(so_all, kind="stable")
    step_out = so_all[perm]
    step_in = si_all[perm]
    step_init = np.ones(G, np.int32)
    step_init[1:] = (step_out[1:] != step_out[:-1]).astype(np.int32)

    # entry rows padded to a multiple of 8 (the JAX package's format);
    # padded rows are never run
    G8 = ((G + 7) // 8) * 8
    o_pos = np.zeros((G8, L), np.int32)
    i_pos = np.zeros((G8, L), np.int32)
    sv = np.zeros((G8, L), np.float32)
    if n_ent:
        inv = np.empty(G_data, np.int64)
        inv[perm[perm < G_data].astype(np.int64)] = np.nonzero(perm < G_data)[0]
        dest_row = inv[entry_step]
        o_pos[dest_row, slot] = out_pos
        i_pos[dest_row, slot] = in_pos
        sv[dest_row, slot] = v
    sp_out, sp_in, sp_vals = _pad_spill_np(sp_out, sp_in, sp_vals)
    return (step_out, step_in, step_init, o_pos, i_pos, sv, sp_out, sp_in, sp_vals)


def _build_schedule(
    rows, feats, vals, *, params: TileParams, sort_by_feature_block: bool,
    num_out_blocks: int, digest: Optional[str] = None,
    builders: Optional[Sequence[int]] = None,
) -> Tuple[Tuple[np.ndarray, ...], str]:
    """-> (nine arrays, "native", "numpy" or "cache"). With the schedule
    cache on (``ops/schedule_cache.py``), a stored artifact is loaded in
    place of the build; on a miss a process that is not this key's writer
    waits for the writer's artifact, and after a build only the writer
    stores, as the JAX package's ``_build_schedule_np`` does. ``digest``:
    the content digest of (rows, feats, vals), when the caller has it
    (both passes of one batch share it). ``builders``: the processes that
    build this same schedule (``schedule_cache.is_cache_writer``; None =
    every process)."""
    kw = dict(
        params=params, sort_by_feature_block=sort_by_feature_block,
        num_out_blocks=num_out_blocks,
    )
    cache_dir = schedule_cache.resolve_cache_dir()
    key = None
    writer = False
    if cache_dir is not None:
        if digest is None:
            digest = schedule_cache.content_digest(rows, feats, vals)
        key = schedule_cache.schedule_key(digest, **kw)
        writer = schedule_cache.is_cache_writer(builders)
        cached = schedule_cache.load_schedule(cache_dir, key)
        if cached is None and not writer:
            cached = schedule_cache.wait_and_load(cache_dir, key)
        if cached is not None:
            return cached, "cache"
    t0 = time.perf_counter()
    arrays, builder = _build_schedule_native(rows, feats, vals, **kw), "native"
    if arrays is None:
        arrays, builder = _build_schedule_numpy(rows, feats, vals, **kw), "numpy"
    schedule_cache.record_build_seconds(time.perf_counter() - t0)
    if writer:
        schedule_cache.store_schedule(cache_dir, key, arrays)
    return arrays, builder


# ---------------------------------------------------------------------------
# Tiled batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TiledMeta:
    """Shape metadata: padded row count and dimension (whole windows) and
    the real ones. ``data_shards > 1`` marks one rank's shard of a
    data-parallel layout (:func:`build_sharded_tiled_batch`): ``num_rows``
    are then the shard's padded rows and ``num_real_rows`` the global real
    count, as in the reference's ``_TiledMeta``."""

    params: TileParams
    num_rows: int
    dim: int
    num_real_rows: int
    real_dim: int
    data_shards: int = 1


@dataclass(frozen=True)
class TiledSparseBatch:
    """A sparse batch in tiled form. ``labels/offsets/weights`` live in
    padded row space (weight 0 padding). ``builder`` names what built the
    schedules: "native", "numpy", "cache" (loaded from the schedule
    cache), "mixed" (one pass each way) or "converted"."""

    meta: TiledMeta
    z_sched: _Schedule
    g_sched: _Schedule
    g_vals_sq: Tensor  # [G8, L] squared g-pass values (Hessian diagonal)
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    builder: str = "converted"

    @property
    def params(self) -> TileParams:
        return self.meta.params

    @property
    def num_rows(self) -> int:
        return self.meta.num_rows

    @property
    def dim(self) -> int:
        return self.meta.dim

    @property
    def num_real_rows(self) -> int:
        return self.meta.num_real_rows

    @property
    def real_dim(self) -> int:
        return self.meta.real_dim

    @property
    def num_row_blocks(self) -> int:
        return self.meta.num_rows // self.meta.params.window

    @property
    def num_feat_blocks(self) -> int:
        return self.meta.dim // self.meta.params.window

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def to(self, device) -> "TiledSparseBatch":
        return dataclasses.replace(
            self,
            z_sched=self.z_sched.to(device),
            g_sched=self.g_sched.to(device),
            g_vals_sq=self.g_vals_sq.to(device),
            labels=self.labels.to(device),
            offsets=self.offsets.to(device),
            weights=self.weights.to(device),
        )


def build_tiled_batch(
    rows: np.ndarray,
    feats: np.ndarray,
    vals: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray,
    weights: np.ndarray,
    dim: int,
    *,
    params: TileParams = TileParams(),
    device: DeviceLike = None,
) -> TiledSparseBatch:
    """COO triples + per-row arrays -> tiled batch on ``device``. Entries
    with zero value are dropped."""
    dev = resolve_device(device)
    nz = vals != 0
    rows, feats, vals = rows[nz], feats[nz], vals[nz]
    win = params.window
    n = labels.shape[0]
    n_pad = _whole_windows(n, win)
    d_pad = _whole_windows(dim, win)
    params = params.resolved(len(vals), (n_pad // win) * (d_pad // win))
    return _build_from_coo(
        rows, feats, vals, *_padded_rows(n_pad, labels, offsets, weights),
        meta=TiledMeta(params, n_pad, d_pad, n, dim), device=dev,
    )


def _whole_windows(n: int, win: int) -> int:
    """``n`` rounded up to whole windows (at least one)."""
    return max(((n + win - 1) // win) * win, win)


def _padded_rows(total: int, *arrays) -> list:
    """Row arrays zero-padded (weight 0 = inert) to ``total`` rows."""
    out = []
    for a in arrays:
        padded = np.zeros(total, np.float32)
        padded[: len(a)] = a
        out.append(padded)
    return out


def _build_from_coo(
    rows, feats, vals, labels, offsets, weights, *, meta: TiledMeta, device,
    builders: Optional[Sequence[int]] = None,
) -> TiledSparseBatch:
    """COO triples in the batch's own row and feature space (nonzero
    values) and row arrays padded to ``meta.num_rows`` -> TiledSparseBatch,
    with ``meta.params`` already resolved. The two passes build in parallel
    threads (the native builder and numpy's sorts release the GIL).
    ``builders`` as for :func:`_build_schedule`."""
    win = meta.params.window
    # both passes key off the same COO triple: hash it once, up front
    digest = (
        schedule_cache.content_digest(rows, feats, vals)
        if schedule_cache.resolve_cache_dir() is not None else None
    )
    with ThreadPoolExecutor(2) as pool:
        fz = pool.submit(
            _build_schedule, rows, feats, vals, params=meta.params,
            sort_by_feature_block=False, num_out_blocks=meta.num_rows // win,
            digest=digest, builders=builders,
        )
        fg = pool.submit(
            _build_schedule, rows, feats, vals, params=meta.params,
            sort_by_feature_block=True, num_out_blocks=meta.dim // win,
            digest=digest, builders=builders,
        )
        z_arrays, z_builder = fz.result()
        g_arrays, g_builder = fg.result()
    return tiled_batch_from_arrays(
        z_arrays, g_arrays, g_arrays[5] ** 2, labels, offsets, weights,
        meta=meta, device=device,
        builder=z_builder if z_builder == g_builder else "mixed",
    )


def tiled_batch_from_arrays(
    z_arrays, g_arrays, g_vals_sq, labels, offsets, weights, *,
    meta: TiledMeta, device: DeviceLike = None, builder: str = "converted",
) -> TiledSparseBatch:
    """Numpy schedule arrays of both passes + padded row arrays -> a checked
    TiledSparseBatch on ``device``."""
    dev = resolve_device(device)
    win = meta.params.window
    n_rb, n_fb = meta.num_rows // win, meta.dim // win
    if np.shape(g_vals_sq) != np.shape(g_arrays[5]):
        raise ValueError("g_vals_sq does not match the g-pass entries")
    # both passes side by side (numpy's sorts release the GIL)
    with ThreadPoolExecutor(2) as pool:
        fz = pool.submit(
            _Schedule.from_numpy, z_arrays, window=win, num_out_blocks=n_rb,
            num_in_blocks=n_fb, device=dev,
        )
        fg = pool.submit(
            _Schedule.from_numpy, g_arrays, window=win, num_out_blocks=n_fb,
            num_in_blocks=n_rb, device=dev, companions=(np.asarray(g_vals_sq),),
        )
        z = fz.result()
        g, (g_vals_sq,) = fg.result()
    if any(np.shape(a) != (meta.num_rows,) for a in (labels, offsets, weights)):
        raise ValueError("row arrays must be padded to the row windows")
    lab, off, wgt = (
        _to_tensor(a, np.float32, dev) for a in (labels, offsets, weights)
    )
    return TiledSparseBatch(
        meta=meta, z_sched=z, g_sched=g,
        g_vals_sq=_to_tensor(g_vals_sq, np.float32, dev),
        labels=lab, offsets=off, weights=wgt, builder=builder,
    )


def _sparse_coo(batch: SparseBatch):
    """SparseBatch -> COO triples with zero values and weight-0 (padding)
    rows dropped."""
    indices = batch.indices.cpu().numpy()
    values = batch.values.cpu().numpy()
    weights = batch.weights.cpu().numpy()
    n, k = indices.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    feats = indices.reshape(-1).astype(np.int64)
    vals = values.reshape(-1).astype(np.float32)
    vals = np.where(np.repeat(weights > 0, k), vals, 0.0).astype(np.float32)
    nz = vals != 0
    return rows[nz], feats[nz], vals[nz]


def _row_arrays(batch: SparseBatch):
    return (
        batch.labels.cpu().numpy(), batch.offsets.cpu().numpy(),
        batch.weights.cpu().numpy(),
    )


def tiled_batch_from_sparse(
    batch: SparseBatch, dim: int, *, params: TileParams = TileParams(),
    device: DeviceLike = None,
) -> TiledSparseBatch:
    """SparseBatch (padded rows) -> TiledSparseBatch on ``device``."""
    rows, feats, vals = _sparse_coo(batch)
    return build_tiled_batch(
        rows, feats, vals, *_row_arrays(batch), dim, params=params, device=device,
    )


# The in-memory tiers of ensure_tiled and ensure_tiled_sharded: a caller
# that wraps the SAME indices, values and weights tensors in a fresh
# SparseBatch per call (the GAME coordinate-descent pattern, where only the
# offsets change between sweeps) reuses the schedules and re-pads only the
# row metadata. A hit needs the same tensor objects (held here, so an id
# cannot be recycled while its entry lives) at the same version counter:
# torch bumps ``_version`` on every in-place edit of a tensor or of a view
# of it, so an edited batch misses and is tiled anew. Two separate LRUs of
# two entries each (one per conversion, as in the JAX package), each entry
# pinning a tiled batch on the device.
_TILED_CACHE_MAX = 2
_SHARDED_CACHE_MAX = 2
_tiled_cache = schedule_cache.ScheduleLRU(_TILED_CACHE_MAX)
_sharded_cache = schedule_cache.ScheduleLRU(_SHARDED_CACHE_MAX)
# conversions that built a tiled batch (misses of the in-memory tiers) and
# their host seconds; a run sets them to 0 and reads them
tilings = 0
tiling_seconds = 0.0


def _pad_rows_on_device(t: Tensor, total: int, start: int = 0) -> Tensor:
    """Rows ``[start, start + total)`` of ``t`` zero-padded (weight 0 =
    inert) past its end."""
    out = torch.zeros(total, dtype=torch.float32, device=t.device)
    part = t[start:start + total]
    out[: part.shape[0]] = part
    return out


def _lookup(cache, batch, key_rest):  # photon: entropy(id-keyed tiling memo; identity-checked, never serialized)
    """The in-memory tier: -> (key, the held conversion or None). A stale
    entry of the same tensors (edited since) is dropped."""
    src = (batch.indices, batch.values, batch.weights)
    held = tuple((id(t), t._version) for t in src)
    key = (held,) + key_rest
    hit = cache.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], src)):
        return key, hit[1]
    ids = [i for i, _ in held]
    for k in cache.keys():
        if k != key and [i for i, _ in k[0]] == ids:
            cache.pop(k)  # the same tensors, edited since
    return key, None


def _with_rows(cached: TiledSparseBatch, batch, start: int) -> TiledSparseBatch:
    """A held conversion with ``batch``'s labels, offsets and weights
    (rows ``[start, start + num_rows)``) in its padded row space."""
    rows, dev = cached.meta.num_rows, cached.device
    return dataclasses.replace(
        cached,
        labels=_pad_rows_on_device(batch.labels.to(dev), rows, start),
        offsets=_pad_rows_on_device(batch.offsets.to(dev), rows, start),
        weights=_pad_rows_on_device(batch.weights.to(dev), rows, start),
    )


def _resolved_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _convert(cache, key, batch, build) -> TiledSparseBatch:
    global tilings, tiling_seconds
    t0 = time.perf_counter()
    out = build()
    tilings += 1
    tiling_seconds += time.perf_counter() - t0
    cache.put(key, ((batch.indices, batch.values, batch.weights), out))
    return out


def ensure_tiled(
    batch, dim: int, *, params: Optional[TileParams] = None,
    device: DeviceLike = None,
) -> TiledSparseBatch:
    """Idempotent tiled conversion (the JAX package's ``ensure_tiled``): a
    TiledSparseBatch passes through; a SparseBatch whose indices, values
    and weights an earlier call tiled, unedited since, reuses that
    conversion with its own labels and offsets; any other batch is tiled
    with ``tiled_batch_from_sparse``, whose schedules come from the
    schedule cache when one is configured."""
    if isinstance(batch, TiledSparseBatch):
        return batch
    dev = _resolved_device(device)
    key, cached = _lookup(_tiled_cache, batch, (dim, params, dev))
    if cached is not None:
        return _with_rows(cached, batch, 0)
    return _convert(_tiled_cache, key, batch, lambda: tiled_batch_from_sparse(
        batch, dim, params=params or TileParams(), device=dev
    ))


def ensure_tiled_sharded(
    batch, dim: int, mesh, axis: str = DATA_AXIS, *,
    params: Optional[TileParams] = None,
) -> TiledSparseBatch:
    """Idempotent data-parallel tiled conversion on this rank of ``mesh``
    (the JAX package's ``ensure_tiled_sharded``, the tiled analogue of
    ``parallel.mesh.ensure_data_sharded``): a SparseBatch -> this rank's
    shard of the ``axis``-sharded layout (:func:`build_sharded_tiled_batch`,
    on ``mesh.device``); a TiledSparseBatch laid out for the axis's shard
    count passes through, one laid out for another count is refused. A
    SparseBatch sharing indices, values and weights with an earlier call
    reuses its schedules; only the row metadata is re-padded. The
    schedules' writer among the processes is the lowest rank holding the
    same shard (``ProcessMesh.ranks_sharing``)."""
    n = mesh.size(axis)
    if isinstance(batch, TiledSparseBatch):
        if batch.meta.data_shards != n:
            raise ValueError(
                f"TiledSparseBatch was laid out for {batch.meta.data_shards} "
                f"data shard(s) but the mesh's {axis!r} axis has {n}; "
                "rebuild from the SparseBatch with build_sharded_tiled_batch"
            )
        return batch if batch.device == mesh.device else batch.to(mesh.device)
    index = mesh.index(axis)
    key, cached = _lookup(
        _sharded_cache, batch, (dim, n, index, axis, params, mesh.device)
    )
    if cached is not None:
        return _with_rows(cached, batch, index * cached.meta.num_rows)
    return _convert(_sharded_cache, key, batch, lambda: build_sharded_tiled_batch(
        batch, dim, n, index, params=params or TileParams(), device=mesh.device,
        builders=mesh.ranks_sharing((axis,)),
    ))


def _own_process() -> Tuple[int, ...]:
    from photon_ml_tpu_torch.parallel import multihost

    return (multihost.process_index(),)


def build_sharded_tiled_batch(
    batch: SparseBatch, dim: int, n_shards: int, shard_index: int, *,
    params: TileParams = TileParams(), device: DeviceLike = None,
    builders: Optional[Sequence[int]] = None,
) -> TiledSparseBatch:
    """Shard ``shard_index`` of the reference's data-parallel layout
    (``build_sharded_tiled_batch``): rows split into ``n_shards``
    contiguous ranges of ``R`` rows (whole windows), this range's
    schedules built in its local row space over every feature. ``params``
    resolve from the GLOBAL entry and tile counts, as the reference's do,
    so every shard gets the chunk the reference gives it. ``builders``:
    the processes that build this same shard (the schedule cache's roles;
    default this process alone)."""
    dev = resolve_device(device)
    rows, feats, vals = _sparse_coo(batch)
    win = params.window
    n = batch.num_rows
    R = _whole_windows(-(-n // n_shards), win)
    d_pad = _whole_windows(dim, win)
    params = params.resolved(len(vals), n_shards * (R // win) * (d_pad // win))
    mine = rows // R == shard_index
    local = slice(shard_index * R, (shard_index + 1) * R)
    row_arrays = [a[local] for a in _padded_rows(n_shards * R, *_row_arrays(batch))]
    return _build_from_coo(
        rows[mine] - shard_index * R, feats[mine], vals[mine], *row_arrays,
        meta=TiledMeta(params, R, d_pad, n, dim, data_shards=n_shards),
        device=dev, builders=builders if builders is not None else _own_process(),
    )


@dataclass(frozen=True)
class FeatureShardedTiledMeta:
    """Shapes of the reference's feature-sharded tiled layout; a cell is
    ``rows_per_shard`` rows by ``block_dim`` features."""

    params: TileParams
    rows_per_shard: int  # padded rows per data shard (whole windows)
    block_dim: int  # padded features per model block (whole windows)
    num_real_rows: int
    real_dim: int
    data_shards: int
    model_shards: int

    def cell_meta(self, data_index: int, model_index: int) -> TiledMeta:
        """The TiledMeta of one cell, in its local row and feature space."""
        R, b = self.rows_per_shard, self.block_dim
        return TiledMeta(
            self.params, R, b,
            num_real_rows=int(np.clip(self.num_real_rows - data_index * R, 0, R)),
            real_dim=int(np.clip(self.real_dim - model_index * b, 0, b)),
        )


@dataclass(frozen=True)
class FeatureShardedTiledBatch:
    """ONE rank's cell of the reference's ``FeatureShardedTiledBatch``: the
    entries of data shard ``data_index`` whose features fall in block
    ``model_index``, tiled in the cell's local row and feature space
    (``cell``, a single-shard TiledSparseBatch), with that data shard's
    padded labels, offsets and weights. Global feature f is coefficient
    ``f % block_dim`` of block ``f // block_dim``.

    Its z-pass gives the block's partial margins of the shard's rows (an
    all-reduce over the model group completes them); its g-pass the
    shard's part of the block's gradient (an all-reduce over the data
    group completes it). K1 runs them for a vector, K2 for a bank."""

    meta: FeatureShardedTiledMeta
    cell: TiledSparseBatch
    data_index: int
    model_index: int

    @property
    def block_dim(self) -> int:
        return self.meta.block_dim

    @property
    def labels(self) -> Tensor:
        return self.cell.labels

    @property
    def offsets(self) -> Tensor:
        return self.cell.offsets

    @property
    def weights(self) -> Tensor:
        return self.cell.weights

    def z_pass(self, x_block: Tensor) -> Tensor:
        """Raw partial margins ``[..., rows_per_shard]`` of a block vector
        or bank ``[..., block_dim]``."""
        return tiled_z_pass(self.cell, x_block.contiguous())

    def g_pass(self, c: Tensor) -> Tensor:
        """``X_cell^T c`` ``[..., block_dim]`` of row coefficients ``c``."""
        return tiled_g_pass(self.cell, c)

    def g_sq_pass(self, c: Tensor) -> Tensor:
        """The g-pass over squared values (the Hessian diagonal's S2)."""
        return tiled_g_pass(
            self.cell, c, vals=self.cell.g_vals_sq,
            spill_vals=self.cell.g_sched.spill_vals**2,
        )


def feature_shard_tiled_batch(
    batch: SparseBatch, dim: int, data_shards: int, model_shards: int,
    data_index: int, model_index: int, *,
    params: TileParams = TileParams(), device: DeviceLike = None,
    builders: Optional[Sequence[int]] = None,
) -> Tuple[FeatureShardedTiledBatch, int]:
    """SparseBatch -> (this rank's cell of the reference's
    ``feature_shard_tiled_batch`` layout, block_dim). Every rank calls it
    with the whole batch and builds only its own cell.

    ``block_dim`` is ``ceil(dim / model_shards)`` rounded up to whole
    windows; the sharded coefficient vector has ``model_shards *
    block_dim`` slots. ``params`` resolve from the GLOBAL entry count and
    the tile count of all cells, as the reference's do: a cell resolved
    from its own entries would get another chunk and so another
    schedule. The reference pads every cell's schedule to one shape for
    ``shard_map``; a rank here holds only its own, unpadded. ``builders``:
    the processes that build this same cell (the schedule cache's roles;
    default this process alone)."""
    dev = resolve_device(device)
    rows, feats, vals = _sparse_coo(batch)
    win = params.window
    n = batch.num_rows
    R = _whole_windows(-(-n // data_shards), win)
    block_dim = _whole_windows(-(-dim // model_shards), win)
    params = params.resolved(
        len(vals), data_shards * model_shards * (R // win) * (block_dim // win)
    )
    meta = FeatureShardedTiledMeta(
        params, R, block_dim, n, dim, data_shards, model_shards,
    )
    mine = (rows // R == data_index) & (feats // block_dim == model_index)
    local = slice(data_index * R, (data_index + 1) * R)
    row_arrays = [a[local] for a in _padded_rows(data_shards * R, *_row_arrays(batch))]
    cell = _build_from_coo(
        rows[mine] - data_index * R, feats[mine] - model_index * block_dim,
        vals[mine], *row_arrays, meta=meta.cell_meta(data_index, model_index),
        device=dev, builders=builders if builders is not None else _own_process(),
    )
    return FeatureShardedTiledBatch(meta, cell, data_index, model_index), block_dim


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------


def _pass(sched, src: Tensor, num_out_blocks: int, window: int, vals=None, spill_vals=None):
    """K1 for a vector, K2 for a bank, the schedule's spill remainder
    folded in (``spill_vals`` overriding its values)."""
    run = grid_bilinear_pass if src.dim() == 2 else bilinear_pass
    return run(sched, src, num_out_blocks, window, vals=vals, spill=True, spill_vals=spill_vals)


def tiled_z_pass(batch: TiledSparseBatch, w_padded: Tensor) -> Tensor:
    """Raw row sums [num_rows] (or [G, num_rows]) of X . w, for a
    contiguous ``w_padded`` [dim] (or [G, dim])."""
    return _pass(batch.z_sched, w_padded, batch.num_row_blocks, batch.params.window)


def tiled_g_pass(
    batch: TiledSparseBatch, c_rows: Tensor,
    vals: Optional[Tensor] = None, spill_vals: Optional[Tensor] = None,
) -> Tensor:
    """X^T . c [dim] (or [G, dim]), padded; ``vals`` / ``spill_vals``
    override the values (the Hessian diagonal squares them)."""
    return _pass(
        batch.g_sched, c_rows.contiguous(), batch.num_feat_blocks, batch.params.window,
        vals=vals, spill_vals=spill_vals,
    )


@dataclass(frozen=True)
class TiledGLMObjective:
    """The GLM objective over a TiledSparseBatch: the scatter objective's
    math and method contract (``ops/objective.py``, one vector or a bank,
    ``group`` for a data-parallel shard), with margins and gradients
    computed by K1 (a vector) or K2 (a bank) over the two schedules."""

    loss: object
    dim: int  # real (unpadded) coefficient dimension
    norm: NormalizationContext = dataclasses.field(default_factory=identity_context)
    group: Optional[object] = None

    def _pad(self, w: Tensor, batch: TiledSparseBatch) -> Tensor:
        if w.shape[-1] == batch.dim:
            return w.contiguous()
        return torch.nn.functional.pad(w, (0, batch.dim - w.shape[-1]))


    def margins(self, coef: Tensor, batch: TiledSparseBatch) -> Tensor:
        """z_i = x_eff_i . w_eff + offset_i in padded row space."""
        w_eff = self.norm.effective_coefficients(coef)
        raw = tiled_z_pass(batch, self._pad(w_eff, batch))
        return raw - self.norm.shift_dot(w_eff)[..., None] + batch.offsets

    def value(self, coef: Tensor, batch: TiledSparseBatch, l2_weight=0.0) -> Tensor:
        z = self.margins(coef, batch)
        val = torch.sum(batch.weights * self.loss.value(z, batch.labels), dim=-1)
        (val,) = sum_partials(self.group, val, scalars=1)
        return val + 0.5 * l2_weight * squared_norm(coef)

    def value_and_gradient(
        self, coef: Tensor, batch: TiledSparseBatch, l2_weight=0.0
    ) -> Tuple[Tensor, Tensor]:
        d_in = coef.shape[-1]
        z = self.margins(coef, batch)
        c = batch.weights * self.loss.d1(z, batch.labels)
        value_sum = torch.sum(batch.weights * self.loss.value(z, batch.labels), dim=-1)
        vector_sum = tiled_g_pass(batch, c)[..., :d_in]
        value_sum, prefactor_sum, vector_sum = sum_partials(
            self.group, value_sum, torch.sum(c, dim=-1), vector_sum, scalars=2
        )
        grad = self.norm.unshift_gradient(vector_sum, prefactor_sum)
        value = value_sum + 0.5 * l2_weight * squared_norm(coef)
        return value, grad + per_member(l2_weight, coef) * coef

    def gradient(self, coef: Tensor, batch: TiledSparseBatch, l2_weight=0.0) -> Tensor:
        return self.value_and_gradient(coef, batch, l2_weight)[1]

    def hessian_vector(
        self, coef: Tensor, direction: Tensor, batch: TiledSparseBatch,
        l2_weight=0.0,
    ) -> Tensor:
        """H(w) @ d: two z-passes and one g-pass."""
        d_in = coef.shape[-1]
        d_eff = self.norm.effective_coefficients(direction)
        z = self.margins(coef, batch)
        zd = (
            tiled_z_pass(batch, self._pad(d_eff, batch))
            - self.norm.shift_dot(d_eff)[..., None]
        )
        c = batch.weights * self.loss.d2(z, batch.labels) * zd
        vector_sum = tiled_g_pass(batch, c)[..., :d_in]
        prefactor_sum, vector_sum = sum_partials(
            self.group, torch.sum(c, dim=-1), vector_sum, scalars=1
        )
        hv = self.norm.unshift_gradient(vector_sum, prefactor_sum)
        return hv + per_member(l2_weight, direction) * direction

    def hessian_diagonal(
        self, coef: Tensor, batch: TiledSparseBatch, l2_weight=0.0
    ) -> Tensor:
        """diag(H): the g-pass over squared values (and, with a shift, the
        plain g-pass for S1)."""
        d_in = coef.shape[-1]
        z = self.margins(coef, batch)
        c = batch.weights * self.loss.d2(z, batch.labels)
        diag = tiled_g_pass(
            batch, c, vals=batch.g_vals_sq,
            spill_vals=batch.g_sched.spill_vals**2,
        )[..., :d_in]
        if self.norm.shift is not None:
            s1 = tiled_g_pass(batch, c)[..., :d_in]
            s0, s1, diag = sum_partials(
                self.group, torch.sum(c, dim=-1)[..., None], s1, diag
            )
            diag = diag - 2.0 * self.norm.shift * s1 + self.norm.shift**2 * s0
        else:
            (diag,) = sum_partials(self.group, diag)
        if self.norm.factor is not None:
            diag = diag * self.norm.factor**2
        return diag + per_member(l2_weight, coef)
