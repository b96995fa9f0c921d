"""K1, the tiled bilinear pass, in the PyTorch port: its plain version
against the reference Pallas kernel (interpret mode, ``mxu="highest"``) on
the reference's own schedules, and its CTA work table. The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``.

Tolerance: rtol 1e-5 of the output's largest magnitude plus atol 1e-6.
Both compute in f32 but sum in another order (one-hot matmuls against
index_add_).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import _run_bilinear_pass
from photon_ml_tpu.ops.tiled_sparse import (
    tiled_batch_from_sparse as ref_tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
from tests.torch_parity import (
    assert_close_to_scale,
    both_batches,
    port_tiled_batch,
    random_rows,
)

CASES = {
    "spills": (RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8), 100, 150),
    "no_spills": (RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=0), 100, 150),
    "multi_window": (RefTileParams(s_hi=8, s_lo=4, chunk=16, spill_cap=4), 300, 500),
}


def _problem(name):
    params, n, d = CASES[name]
    rng = np.random.default_rng(7)
    rows, labels = random_rows(rng, n=n, d=d)
    ref_batch, _ = both_batches(rows, labels)
    ref_tb = ref_tiled_batch_from_sparse(ref_batch, d, params=params)
    return rng, params, ref_tb, port_tiled_batch(ref_tb)


def _ref_pass(sched, src_flat, n_out, params, vals=None):
    src = jnp.asarray(src_flat.reshape(-1, params.s_hi, params.s_lo))
    out = _run_bilinear_pass(
        sched, src, n_out, params, vals=vals, interpret=True, mxu="highest"
    )
    return np.asarray(out).reshape(-1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_pass_matches_reference_kernel(name):
    rng, params, ref_tb, tb = _problem(name)
    win = params.window
    w = rng.normal(size=tb.dim).astype(np.float32)
    c = rng.normal(size=tb.num_rows).astype(np.float32)
    passes = [
        ("z", ref_tb.z_sched, tb.z_sched, w, tb.num_row_blocks, None, None),
        ("g", ref_tb.g_sched, tb.g_sched, c, tb.num_feat_blocks, None, None),
        (
            "g_sq", ref_tb.g_sched, tb.g_sched, c, tb.num_feat_blocks,
            ref_tb.g_vals_sq, tb.g_vals_sq,
        ),
    ]
    for label, ref_sched, sched, src, n_out, ref_vals, vals in passes:
        expected = _ref_pass(ref_sched, src, n_out, params, vals=ref_vals)
        got = k1.bilinear_pass(sched, torch.as_tensor(src), n_out, win, vals=vals)
        assert got.shape == (n_out * win,), label
        assert_close_to_scale(got, expected, rtol=1e-5, atol=1e-6)


def test_spills_present_where_asked():
    _, _, _, tb = _problem("spills")
    assert int(torch.count_nonzero(tb.z_sched.spill_vals)) > 0
    _, _, _, tb = _problem("no_spills")
    assert int(torch.count_nonzero(tb.z_sched.spill_vals)) == 0


STEP_OUT = np.array([0, 0, 0, 0, 1, 2, 2, 2, 2, 2, 2, 2, 5], np.int32)
STEP_SIZES = np.array([32, 32, 7, 0, 0, 32, 32, 32, 32, 32, 32, 9, 30], np.int32)
NUM_OUT_BLOCKS = 7  # blocks 3, 4 and 6 have no steps


def _slot_cover(items, sizes):
    """How many items cover each (step, entry) slot of a real entry; and
    check every item stays inside one output block's steps (an item
    without steps has last step = first step - 1)."""
    cover = [np.zeros(n, np.int64) for n in sizes]
    for block, s0, p0, s1, p1, _ in items:
        assert s0 <= s1 or (s1 == s0 - 1 and p0 == p1 == 0)
        for s in range(s0, s1 + 1):
            lo = p0 if s == s0 else 0
            hi = p1 if s == s1 else sizes[s]
            assert 0 <= lo <= hi <= sizes[s]
            cover[s][lo:hi] += 1
    return cover


@pytest.mark.parametrize("target", [1, 3, 8, 40, 200])
def test_segments_cover_each_step_once_within_one_block(target):
    """Every real entry slot in exactly one item, no item crossing an
    output block, cuts inside a step on ENTRY_ALIGN, and as many items as
    the target asks (each block at least one, so blocks without entries,
    or without steps, are written too)."""
    items = k1.plan_work(STEP_OUT, STEP_SIZES, target, NUM_OUT_BLOCKS)
    for cover in _slot_cover(items, STEP_SIZES):
        assert np.all(cover == 1)
    for block, s0, p0, s1, p1, sole in items:
        assert np.all(STEP_OUT[s0 : s1 + 1] == block)
        assert p0 % k1.ENTRY_ALIGN == 0
        assert p1 % k1.ENTRY_ALIGN == 0 or p1 == STEP_SIZES[s1]
        assert sole == (np.count_nonzero(items[:, 0] == block) == 1)
        assert (s1 < s0) == (block not in STEP_OUT)
    assert NUM_OUT_BLOCKS <= len(items) <= target + NUM_OUT_BLOCKS
    assert set(items[:, 0]) == set(range(NUM_OUT_BLOCKS))
    none = k1.plan_work(np.zeros(0, np.int32), np.zeros(0, np.int32), 8, 3)
    assert none.tolist() == [[b, 0, 0, -1, 0, 1] for b in range(3)]


@pytest.mark.parametrize("target", [132, 264, 528, 924])
@pytest.mark.parametrize("shape", ["full_z", "cell_z", "full_g"])
def test_plan_follows_target_and_splits_steps(shape, target):
    """The ads-shape step tables (full: 32 row blocks of 128 steps or 128
    feature blocks of 32; cell: 16 blocks of 64 steps): the item count
    follows the target within one item per block, items hold about equal
    entries, and a block with fewer steps than its items splits steps."""
    n_blocks, steps = {"full_z": (32, 128), "cell_z": (16, 64), "full_g": (128, 32)}[shape]
    rng = np.random.default_rng(target)
    step_out = np.repeat(np.arange(n_blocks, dtype=np.int32), steps)
    sizes = rng.integers(3900, 4225, size=step_out.shape[0]).astype(np.int32)
    items = k1.plan_work(step_out, sizes, target, n_blocks)
    for cover in _slot_cover(items, sizes):
        assert np.all(cover == 1)
    assert abs(len(items) - target) <= n_blocks / 2 + 1
    per_item = [
        sum(min(p1 if s == s1 else sizes[s], sizes[s]) - (p0 if s == s0 else 0)
            for s in range(s0, s1 + 1))
        for _, s0, p0, s1, p1, _ in items
    ]
    assert max(per_item) <= 1.6 * sizes.sum() / target
    if target > step_out.shape[0]:
        assert np.any(items[:, 1] == items[:, 3])  # a step split across CTAs
        assert np.any(items[:, 2] > 0)


def test_plan_respects_min_entries_and_sole_writes():
    """A tiny pass makes no more items than its entries over min_entries;
    an item stores its window (sole) exactly when no other item writes its
    block."""
    items = k1.plan_work(STEP_OUT, STEP_SIZES, 1000, NUM_OUT_BLOCKS, min_entries=128)
    assert len(items) <= -(-int(STEP_SIZES.sum()) // 128) + NUM_OUT_BLOCKS
    for target in (1, 3, 40):
        items = k1.plan_work(STEP_OUT, STEP_SIZES, target, NUM_OUT_BLOCKS)
        writers = np.bincount(items[:, 0], minlength=NUM_OUT_BLOCKS)
        assert np.array_equal(items[:, 5] == 1, writers[items[:, 0]] == 1)
    assert not items[:, 5].all()  # at 40 CTAs block 2 has several items


def test_plans_are_cached_on_the_schedule_and_kept_by_to():
    """A schedule's work plan is made once per target, and moving a batch
    to the device it is on keeps its schedules and plans."""
    _, _, _, tb = _problem("spills")
    plan = k1.make_plan(tb.z_sched, 7)
    assert k1.make_plan(tb.z_sched, 7) is plan
    assert k1.make_plan(tb.z_sched, 8) is not plan
    moved = tb.to("cpu")
    assert moved.z_sched is tb.z_sched and moved.g_sched is tb.g_sched
    assert k1.make_plan(moved.z_sched, 7) is plan


def _emulate(items, sched, src, n_out, window, vals=None):
    """The kernel's work plan in numpy: each item's partial window over its
    entries, stored where the item is its block's only writer and added
    otherwise (into a zeroed output)."""
    v = (sched.vals if vals is None else vals).numpy()
    i_pos, o_pos = sched.in_pos.numpy(), sched.out_pos.numpy()
    step_in, sizes = sched.step_in.numpy(), sched.step_sizes.numpy()
    src = np.asarray(src, np.float64).reshape(-1, src.shape[-1])
    out = np.full((src.shape[0], n_out * window), np.nan)
    shared = {b for b in items[:, 0] if np.count_nonzero(items[:, 0] == b) > 1}
    for b in shared:
        out[:, b * window : (b + 1) * window] = 0.0
    for block, s0, p0, s1, p1, sole in items:
        part = np.zeros((src.shape[0], window))
        for s in range(s0, s1 + 1):
            lo, hi = (p0 if s == s0 else 0), (p1 if s == s1 else sizes[s])
            win = src[:, step_in[s] * window : (step_in[s] + 1) * window]
            np.add.at(part.T, o_pos[s, lo:hi], (v[s, lo:hi] * win[:, i_pos[s, lo:hi]]).T)
        dst = out[:, block * window : (block + 1) * window]
        if sole:
            dst[:] = part
        else:
            dst += part
    return out


@pytest.mark.parametrize("target", [1, 5, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_emulation_matches_plain_and_reference(name, target):
    """The work plan, emulated in numpy, computes the plain version's and
    the reference kernel's pass on the z, g and g_sq passes (every output
    slot written: no NaN left from the uninitialised output)."""
    rng, params, ref_tb, tb = _problem(name)
    win = params.window
    w = rng.normal(size=tb.dim).astype(np.float32)
    c = rng.normal(size=tb.num_rows).astype(np.float32)
    for ref_sched, sched, src, n_out, ref_vals, vals in (
        (ref_tb.z_sched, tb.z_sched, w, tb.num_row_blocks, None, None),
        (ref_tb.g_sched, tb.g_sched, c, tb.num_feat_blocks, None, None),
        (ref_tb.g_sched, tb.g_sched, c, tb.num_feat_blocks, ref_tb.g_vals_sq, tb.g_vals_sq),
    ):
        items = k1.plan_work(sched.step_out.numpy(), sched.step_sizes.numpy(), target, n_out)
        got = _emulate(items, sched, src, n_out, win, vals)[0]
        assert not np.isnan(got).any()
        plain = k1.bilinear_pass(sched, torch.as_tensor(src), n_out, win, vals=vals)
        assert_close_to_scale(got, plain.numpy(), rtol=1e-5, atol=1e-6)
        expected = _ref_pass(ref_sched, src, n_out, params, vals=ref_vals)
        assert_close_to_scale(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block", ["first", "middle", "last"])
def test_plan_writes_blocks_without_steps(block):
    """A schedule without any step for an output block (neither builder
    makes one, ``from_numpy`` takes it): the plan gives the block an item
    without steps, so the emulated kernel writes its window as zeros, and
    the whole pass is the plain version's."""
    from photon_ml_tpu_torch.tools.kernel_cases import schedule_without_block

    rng, params, _, tb = _problem("multi_window")
    win, n_out = params.window, tb.num_row_blocks
    b = {"first": 0, "middle": n_out // 2, "last": n_out - 1}[block]
    sched = schedule_without_block(tb.z_sched, b)
    assert b not in sched.step_out.tolist()
    w = rng.normal(size=tb.dim).astype(np.float32)
    for target in (1, 5, 64):
        items = k1.plan_work(sched.step_out.numpy(), sched.step_sizes.numpy(), target, n_out)
        assert [i[1:5].tolist() for i in items if i[0] == b] == [[0, 0, -1, 0]]
        got = _emulate(items, sched, w, n_out, win)[0]
        assert not np.isnan(got).any()
        assert not got[b * win : (b + 1) * win].any()
        plain = k1.bilinear_pass(sched, torch.as_tensor(w), n_out, win)
        assert_close_to_scale(got, plain.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_real_entries_pass_and_the_padding_nan(name):
    """The card checks' references: the pass over the real entries equals
    the plain version on a finite source (a flat vector and a bank); with
    a NaN at the first slot of a window that a padded step reads, the
    plain version carries it into more outputs than the real entries do,
    and the emulated plan gives the real entries' outputs."""
    from photon_ml_tpu_torch.tools.kernel_cases import (
        nan_at_window_start,
        real_entries_pass,
    )

    rng, params, _, tb = _problem(name)
    win = params.window
    sched, n_out = tb.z_sched, tb.num_row_blocks
    w = torch.as_tensor(rng.normal(size=(3, tb.dim)).astype(np.float32))
    for src in (w[0], w):
        real = real_entries_pass(sched, src, n_out, win)
        plain = torch.stack([
            k1.bilinear_pass_plain(sched, row, n_out, win)
            for row in src.reshape(-1, src.shape[-1])
        ]).reshape(real.shape)
        assert_close_to_scale(real, plain.numpy(), rtol=1e-5, atol=1e-6)
    nan_src, plain, real = nan_at_window_start(sched, w[0], n_out, win)
    assert int(torch.isnan(plain).sum()) > int(torch.isnan(real).sum())
    items = k1.plan_work(sched.step_out.numpy(), sched.step_sizes.numpy(), 5, n_out)
    got = _emulate(items, sched, nan_src.numpy(), n_out, win)[0]
    assert np.array_equal(np.isnan(got), torch.isnan(real).numpy())
    finite = ~np.isnan(got)
    assert_close_to_scale(got[finite], real.numpy()[finite], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_sizes_are_the_builders_chunk_sizes(name):
    """The per-step entry counts derived from the schedule arrays are the
    builder's chunk sizes: the values fill each step from slot 0 (a COO
    value is never 0), and the sizes add up to the entries not spilled."""
    _, params, _, tb = _problem(name)
    for sched in (tb.z_sched, tb.g_sched):
        S = sched.num_steps
        sizes = sched.step_sizes.numpy()
        vals = sched.vals.numpy()[:S]
        assert sizes.shape == (S,) and sizes.max() <= params.chunk
        slot = np.arange(vals.shape[1])
        assert np.array_equal(vals != 0, slot[None, :] < sizes[:, None])
        held = int(np.count_nonzero(vals))
        assert sizes.sum() == held


@pytest.mark.parametrize("by_feature", [False, True])
@pytest.mark.parametrize("spill_cap", [0, 8])
def test_step_sizes_from_both_builders(spill_cap, by_feature):
    """On schedules of the port's numpy and native builders alike, the
    sizes derived from the arrays are the chunk sizes: without spills,
    each tile's entries in chunks of L (a zero-entry step for an output
    block without entries), counted from the COO alone; with spills, the
    two builders agree."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    rng = np.random.default_rng(11)
    n, d, nnz, L, win = 700, 300, 5000, 32, 64
    rows = rng.integers(0, n, nnz)
    rows[(rows >= 128) & (rows < 192)] -= 64  # a row window without entries
    feats = rng.integers(0, d, nnz)
    feats[: nnz // 6] = d - 1
    vals = rng.normal(size=nnz).astype(np.float32)
    params = ts.TileParams(s_hi=8, s_lo=8, chunk=L, spill_cap=spill_cap)
    n_out = -(-(d if by_feature else n) // win)
    kw = dict(params=params, sort_by_feature_block=by_feature, num_out_blocks=n_out)
    got = {}
    for name, build in (("numpy", ts._build_schedule_numpy), ("native", ts._build_schedule_native)):
        arrays = build(rows, feats, vals, **kw)
        assert arrays is not None, f"{name} builder unavailable"
        got[name] = k1.step_sizes(arrays[5], arrays[0].shape[0])
    assert np.array_equal(got["numpy"], got["native"])
    if spill_cap == 0:
        out_b, in_b = ((feats, rows) if by_feature else (rows, feats))
        tiles = np.bincount(
            (out_b // win) * 64 + in_b // win, minlength=n_out * 64
        ).reshape(n_out, 64)
        expected = []
        for b in range(n_out):
            counts = tiles[b][tiles[b] > 0]
            if not len(counts):
                expected.append(0)
            for c in counts:
                expected += [L] * (c // L) + ([c % L] if c % L else [])
        assert np.array_equal(got["numpy"], expected)


@pytest.mark.parametrize("rows_sorted", [True, False])
def test_gathers_in_order_follow_the_rows_order(rows_sorted):
    """Each step's entries are sorted by output slot (the kernels' order of
    additions), the input's order kept within a slot. With random features
    a z-pass reads its feature window at random and a g-pass its row
    window at random too (a few rows a feature), whatever the rows' order;
    where each row holds one feature that rises with the row (a diagonal),
    both passes read their windows in order, in whatever order the rows
    come (the sort by slot puts them in order)."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    rng = np.random.default_rng(5)
    n, d, nnz = 3000, 2000, 60000
    rows = np.sort(rng.integers(0, n, nnz)) if rows_sorted else rng.integers(0, n, nnz)
    params = ts.TileParams(s_hi=8, s_lo=32, chunk=128, spill_cap=0)

    def build(feats):
        return ts.build_tiled_batch(
            rows, feats, rng.normal(size=nnz).astype(np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32),
            np.ones(n, np.float32), d, params=params, device="cpu",
        )

    tb = build(rng.integers(0, d, nnz))
    assert not tb.z_sched.ordered_gathers and not tb.g_sched.ordered_gathers
    assert k1.default_mode(tb.z_sched) == k1.STAGED
    assert k1.default_mode(tb.g_sched) == k1.STAGED
    diagonal = build(rows * (d - 1) // (n - 1))
    assert diagonal.z_sched.ordered_gathers and diagonal.g_sched.ordered_gathers
    assert k1.default_mode(diagonal.g_sched) == k1.GATHERED
    empty = np.zeros((8, 4), np.int32)
    assert not k1.gathers_in_order(empty, np.zeros(0, np.int32))


@pytest.mark.parametrize("bad", ["short_src", "long_src", "few_out_blocks", "window"])
def test_operands_outside_the_checked_schedule_raise(bad):
    _, params, _, tb = _problem("multi_window")
    win, n_out = params.window, tb.num_row_blocks
    src = torch.zeros(tb.dim)
    if bad == "short_src":
        src = src[:-win]
    elif bad == "long_src":
        src = torch.zeros(tb.dim + win)
    elif bad == "few_out_blocks":
        n_out -= 1
    else:
        win //= 2
    with pytest.raises(ValueError, match="bilinear_pass"):
        k1.bilinear_pass(tb.z_sched, src, n_out, win)


def test_unsupported_device_raises():
    _, params, _, tb = _problem("spills")
    src = torch.zeros(tb.dim, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.bilinear_pass(tb.z_sched, src, tb.num_row_blocks, params.window)


@pytest.mark.parametrize("target", [1, 3, 8, 40, 200])
def test_shared_item_table(target):
    """Each item that shares its output block gets a scratch row of its
    own, numbered in item order; each such block is listed once with its
    first row and row count, and its rows are its items, in order."""
    items = k1.plan_work(STEP_OUT, STEP_SIZES, target, NUM_OUT_BLOCKS)
    rows, shared = k1.shared_items(items)
    sole = items[:, 5] == 1
    assert np.all(rows[sole] == -1)
    assert rows[~sole].tolist() == list(range(int((~sole).sum())))
    writers = np.bincount(items[:, 0], minlength=NUM_OUT_BLOCKS)
    assert sorted(shared[:, 0].tolist()) == np.flatnonzero(writers > 1).tolist()
    for block, first, n in shared.tolist():
        mine = np.flatnonzero(items[:, 0] == block)
        assert rows[mine].tolist() == list(range(first, first + n))
    plan = k1.work_plan(items, "cpu")
    assert plan.items.shape == (len(items), k1.KERNEL_ITEM_COLUMNS)
    assert plan.items[:, 6].tolist() == rows.tolist()
    assert plan.scratch_rows == int((~sole).sum())


def _emulate_fixed_order(items, sched, src, n_out, window, vals=None, trip=8):
    """The kernel's order of additions in numpy (float32): each item walks
    its entries ``trip`` at a time, sums each trip's runs of one (step,
    slot) in entry order and adds the sums one step after another; a sole
    item stores its window, and a shared block's windows are summed as
    the second kernel sums them (8 interleaved partial sums in row order,
    then those in order)."""
    v = (sched.vals if vals is None else vals).numpy()
    i_pos, o_pos = sched.in_pos.numpy(), sched.out_pos.numpy()
    step_in, sizes = sched.step_in.numpy(), sched.step_sizes.numpy()
    src = np.asarray(src, np.float32)
    out = np.full(n_out * window, np.nan, np.float32)
    rows, shared = k1.shared_items(items)
    scratch = np.zeros((max(len(rows), 1), window), np.float32)
    for (block, s0, p0, s1, p1, _), row in zip(items, rows):
        entries = [
            (s, e) for s in range(s0, s1 + 1)
            for e in range(p0 if s == s0 else 0, p1 if s == s1 else sizes[s])
        ]
        acc = np.zeros(window, np.float32)
        for t in range(0, len(entries), trip):
            runs = {}
            for s, e in entries[t:t + trip]:
                x = np.float32(v[s, e] * src[step_in[s] * window + i_pos[s, e]])
                key = (s, o_pos[s, e])
                runs[key] = np.float32(runs.get(key, np.float32(0)) + x)
            for (s, slot), x in sorted(runs.items()):
                acc[slot] = np.float32(acc[slot] + x)
        if row < 0:
            out[block * window:(block + 1) * window] = acc
        else:
            scratch[row] = acc
    for block, first, n in shared.tolist():
        # reduce_shared: 8 interleaved partial sums in row order, then those
        parts = np.zeros((8, window), np.float32)
        for r in range(n):
            parts[r % 8] = parts[r % 8] + scratch[first + r]
        total = parts[0].copy()
        for y in range(1, 8):
            total = total + parts[y]
        out[block * window:(block + 1) * window] = total
    return out


@pytest.mark.parametrize("target", [1, 5, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_order_plan(name, target):
    """The fixed-order plan: every real entry is covered once, each step's
    entries are sorted by output slot (their runs adjacent), and the
    kernel's order of additions, emulated, writes every output once and
    gives the plain version's and the reference kernel's pass; twice the
    same bits."""
    rng, params, ref_tb, tb = _problem(name)
    win = params.window
    c = rng.normal(size=tb.num_rows).astype(np.float32)
    for sched in (tb.z_sched, tb.g_sched):
        sizes = sched.step_sizes.numpy()
        o_pos = sched.out_pos.numpy()
        for s in range(sched.num_steps):
            assert np.all(np.diff(o_pos[s, : sizes[s]]) >= 0)
    sched, n_out = tb.g_sched, tb.num_feat_blocks
    items = k1.plan_work(sched.step_out.numpy(), sched.step_sizes.numpy(), target, n_out)
    for cover in _slot_cover(items, sched.step_sizes.numpy()):
        assert np.all(cover == 1)
    got = _emulate_fixed_order(items, sched, c, n_out, win)
    assert not np.isnan(got).any()
    assert np.array_equal(got, _emulate_fixed_order(items, sched, c, n_out, win))
    plain = k1.bilinear_pass(sched, torch.as_tensor(c), n_out, win)
    assert_close_to_scale(got, plain.numpy(), rtol=1e-5, atol=1e-6)
    expected = _ref_pass(ref_tb.g_sched, c, n_out, params)
    assert_close_to_scale(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_against_reference_auto(name, dtype):
    """K1's and K2's plain versions, each with the sorted K3, against the
    JAX package as its own CPU tests run it: float32 through
    ``_bilinear_pass_auto`` in interpret mode, float64 (which the Pallas
    interpreter does not take) through its XLA companion
    ``_grid_bilinear_pass`` under ``jax.enable_x64``; float64 within 1e-12
    and float32 within 1e-6 of the output's scale."""
    import jax

    from photon_ml_tpu.ops.tiled_sparse import _bilinear_pass_auto, _grid_bilinear_pass
    from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2

    rng, params, ref_tb, tb = _problem(name)
    win, n_out = params.window, tb.num_feat_blocks
    wide = dtype == "float64"
    tol = 1e-12 if wide else 1e-6
    bank = rng.normal(size=(2, tb.num_rows)).astype(dtype)
    sched = _wide(tb.g_sched) if wide else tb.g_sched
    with jax.enable_x64(wide):
        ref = ref_tb.g_sched
        if wide:
            ref = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, ref
            )
        x = jnp.asarray(bank)
        if wide:
            raw = _grid_bilinear_pass(
                ref, x.reshape(2, -1, params.s_hi, params.s_lo), n_out, params
            ).reshape(2, -1)
        else:
            raw = jnp.stack([
                _bilinear_pass_auto(
                    ref, x[g].reshape(-1, params.s_hi, params.s_lo), n_out, params,
                    interpret=True, mxu="highest",
                ).reshape(-1)
                for g in range(2)
            ])
        expected = np.stack([np.asarray(ref.apply_spill(raw[g], x[g])) for g in range(2)])
    src = torch.as_tensor(bank)
    grid = sched.apply_spill(k2.grid_bilinear_pass(sched, src, n_out, win), src)
    assert_close_to_scale(grid, expected, rtol=tol, atol=tol)
    for g in range(2):
        one = sched.apply_spill(k1.bilinear_pass(sched, src[g], n_out, win), src[g])
        assert_close_to_scale(one, expected[g], rtol=tol, atol=tol)


def _wide(sched):
    """A schedule with float64 values (the float64 parity runs)."""
    import dataclasses

    return dataclasses.replace(
        sched, vals=sched.vals.double(), spill_vals=sched.spill_vals.double(), plans={}
    )
