"""The spill remainder folded into K1's and K2's output.

A schedule's spilled entries (the tile tails its steps leave out) are
added by the pass itself on the card: the schedule's ``SpillPlan``
(sorted by output once a schedule) maps each output element to its slot,
and the kernels add a slot's sum (from 0, each spilled product in entry
order by a fused multiply-add, then one add to the slot) where they write
its output element once. Its plain form is ``bilinear_pass.spill_ordered``
over ``bilinear_pass.fma_rn``, an exact float32 fused multiply-add in plain
PyTorch (held here to exact rational arithmetic): a fused pass on the card
is bitwise the same pass without its spill followed by it
(``tests/test_torch_cuda_kernels.py``). Here, on the CPU: the plan's
slots and map, the unfused pass followed by ``spill_ordered`` against the CPU
path (the plain pass, then ``index_add_``) and against the JAX package's
pass and ``_Schedule.apply_spill``.

Tolerance: 1e-6 of the output's scale between the two orders of the spill
sums (both float32); against the reference kernel (interpret mode,
``mxu="highest"``) rtol 1e-5 of the output's largest magnitude plus atol
1e-6, as ``tests/test_torch_bilinear_pass.py`` holds the pass.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import _run_bilinear_pass
from photon_ml_tpu.ops.tiled_sparse import (
    tiled_batch_from_sparse as ref_tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.ops import tiled_sparse as ts
from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2
from tests.torch_parity import (
    assert_close_to_scale,
    both_batches,
    port_tiled_batch,
    random_rows,
)

CASES = {
    "spills": (RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8), 100, 150),
    "multi_window": (RefTileParams(s_hi=8, s_lo=4, chunk=16, spill_cap=4), 300, 500),
    "heavy_spills": (RefTileParams(s_hi=4, s_lo=4, chunk=64, spill_cap=60), 200, 90),
}
PASSES = ["z", "g", "g_sq"]


def _problem(name):
    params, n, d = CASES[name]
    rng = np.random.default_rng(11)
    rows, labels = random_rows(rng, n=n, d=d)
    ref_batch, _ = both_batches(rows, labels)
    ref_tb = ref_tiled_batch_from_sparse(ref_batch, d, params=params)
    return rng, params, ref_tb, port_tiled_batch(ref_tb)


def _pass_of(tb, ref_tb, which, rng, members=None):
    """(port schedule, reference schedule, source, output blocks, values,
    spill values, the reference's values) of one pass."""
    shape = () if members is None else (members,)
    if which == "z":
        src = rng.normal(size=shape + (tb.dim,)).astype(np.float32)
        return tb.z_sched, ref_tb.z_sched, src, tb.num_row_blocks, None, None, None
    src = rng.normal(size=shape + (tb.num_rows,)).astype(np.float32)
    if which == "g":
        return tb.g_sched, ref_tb.g_sched, src, tb.num_feat_blocks, None, None, None
    # the port sorts each step's entries by output slot, the reference not
    return (tb.g_sched, ref_tb.g_sched, src, tb.num_feat_blocks, tb.g_vals_sq,
            tb.g_sched.spill_vals ** 2, ref_tb.g_vals_sq)


@pytest.mark.parametrize("which", ["z", "g"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_slot_map_covers_every_slot_once_in_order(name, which):
    """The plan's slots ascend, and its map over the output blocks'
    windows gives each slot's output its index and every other output -1,
    so block b's column i finds its slot at ``map[b * W + i]``, each slot
    in exactly one block; each slot's entries one run, every spilled entry
    in one run, in entry order."""
    _, params, _, tb = _problem(name)
    sched = tb.z_sched if which == "z" else tb.g_sched
    assert sched.spill_out.shape[0] > 0
    plan, vals = k1.spill_operands(sched)
    win, n_blocks = params.window, sched.num_out_blocks
    slots = plan.slots.tolist()
    offsets, order = plan.offsets.tolist(), plan.order.tolist()
    assert all(x < y for x, y in zip(slots, slots[1:]))
    assert 0 <= slots[0] and slots[-1] < n_blocks * win
    assert offsets[0] == 0 and offsets[-1] == len(order) == sched.spill_out.shape[0]
    assert sorted(order) == list(range(len(order)))
    spill_out = sched.spill_out.tolist()
    for i, t in enumerate(slots):
        run = order[offsets[i]:offsets[i + 1]]
        assert run and run == sorted(run) and all(spill_out[e] == t for e in run)
    slot_map = plan.map.tolist()
    assert len(slot_map) == n_blocks * win
    assert [i for i, t in enumerate(slot_map) if t >= 0] == slots
    assert all(slot_map[t] == i for i, t in enumerate(slots))
    assert torch.equal(vals, sched.spill_vals[plan.order])
    assert torch.equal(plan.in_pos.long(), sched.spill_in[plan.order].long())
    assert k1.spill_operands(sched)[0] is plan  # made once a schedule


@pytest.mark.parametrize("members", [None, 3])
@pytest.mark.parametrize("which", PASSES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_unfused_pass_then_spill_ordered_matches_apply_spill(name, which, members):
    """K1 (a vector) or K2 (a bank of 3) without its spill, then
    ``spill_ordered`` (the card's order of the fold), against the pass with
    its spill on the CPU path (the plain pass, then ``apply_spill``'s
    ``index_add_``) and against the JAX package's pass and
    ``_Schedule.apply_spill``."""
    rng, params, ref_tb, tb = _problem(name)
    sched, ref_sched, src, n_out, vals, spill_vals, ref_vals = _pass_of(
        tb, ref_tb, which, rng, members)
    win = params.window
    run = k1.bilinear_pass if members is None else k2.grid_bilinear_pass
    x = torch.as_tensor(src)
    fused_cpu = run(sched, x, n_out, win, vals=vals, spill=True, spill_vals=spill_vals)
    unfused = run(sched, x, n_out, win, vals=vals)
    assert torch.equal(fused_cpu, sched.apply_spill(unfused.clone(), x, vals=spill_vals))
    ordered = k1.spill_ordered(unfused.clone(), x, *k1.spill_operands(sched, spill_vals))
    scale = float(fused_cpu.abs().max())
    np.testing.assert_allclose(ordered.numpy(), fused_cpu.numpy(), rtol=0, atol=1e-6 * scale)
    # slots without a spill keep the unfused pass's bits
    untouched = torch.ones(unfused.shape[-1], dtype=torch.bool)
    untouched[sched.spill_out.long()] = False
    assert torch.equal(ordered[..., untouched], unfused[..., untouched])

    ref_spill = None if spill_vals is None else jnp.asarray(spill_vals.numpy())
    for g, row in enumerate(src.reshape(-1, src.shape[-1])):
        raw = _run_bilinear_pass(
            ref_sched, jnp.asarray(row.reshape(-1, params.s_hi, params.s_lo)), n_out, params,
            vals=ref_vals, interpret=True, mxu="highest",
        ).reshape(-1)
        expected = np.asarray(ref_sched.apply_spill(raw, jnp.asarray(row), vals=ref_spill))
        got = ordered if members is None else ordered[g]
        assert_close_to_scale(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_passes_fold_the_spill_on_the_cpu_path(name):
    """``tiled_z_pass`` and ``tiled_g_pass`` (a vector and a bank, the
    squared values' override too) give the plain pass followed by
    ``apply_spill`` bit for bit on the CPU, and count no spill launch
    there."""
    rng, params, _, tb = _problem(name)
    win = params.window
    counts = lambda: (k1.launches, k1.spill_launches, k2.launches, k2.spill_launches)
    before = counts()
    for shape in ((), (2,)):
        w = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32))
        c = torch.as_tensor(rng.normal(size=shape + (tb.num_rows,)).astype(np.float32))
        plain = k1.bilinear_pass_plain if not shape else k2.grid_bilinear_pass_plain
        z = plain(tb.z_sched, w, tb.num_row_blocks, win)
        assert torch.equal(ts.tiled_z_pass(tb, w), tb.z_sched.apply_spill(z, w))
        g = plain(tb.g_sched, c, tb.num_feat_blocks, win)
        assert torch.equal(ts.tiled_g_pass(tb, c), tb.g_sched.apply_spill(g, c))
        sq = tb.g_sched.spill_vals ** 2
        g_sq = plain(tb.g_sched, c, tb.num_feat_blocks, win, vals=tb.g_vals_sq)
        assert torch.equal(ts.tiled_g_pass(tb, c, vals=tb.g_vals_sq, spill_vals=sq),
                           tb.g_sched.apply_spill(g_sq, c, vals=sq))
    assert counts() == before


@pytest.mark.parametrize("which", ["z", "g"])
def test_apply_spill_is_the_cpu_path_only(which):
    """``_Schedule.apply_spill`` adds the remainder on the CPU alone: off
    the CPU (a meta tensor here, a CUDA tensor on the card) it raises, as
    the card's passes fold the remainder into their own launch."""
    _, _, _, tb = _problem("spills")
    sched = tb.z_sched if which == "z" else tb.g_sched
    n_out = sched.num_out_blocks * sched.window
    n_in = sched.num_in_blocks * sched.window
    with pytest.raises(ValueError, match="CPU path only"):
        sched.apply_spill(torch.empty(n_out, device="meta"), torch.empty(n_in, device="meta"))


def _fma_exact(a, b, c):
    """float32 ``a * b + c`` rounded once to nearest, ties to even, from
    exact rational arithmetic."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    around = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return min(around, key=lambda y: (abs(Fraction(float(y)) - exact),
                                      int(np.array(y).view(np.int32)) & 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_rn_is_a_float32_fused_multiply_add(seed):
    """``fma_rn`` rounds ``a * b + c`` once, as the card's ``__fmaf_rn``:
    on random operands over a wide range of exponents, and where the sum
    in float64 lands exactly halfway between two float32 numbers (rounding
    float64 then float32 would round to even there; the exact sum lies to
    one side)."""
    rng = np.random.default_rng(seed)
    n = 4000
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    c = (rng.normal(size=n) * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    halfway = np.float32([2.0 ** 40 + 2.0 ** 17, -(2.0 ** 40 + 2.0 ** 17), 2.0 ** 40])
    a = np.concatenate([a, np.float32([1 + 2.0 ** -23] * 3)])
    b = np.concatenate([b, np.float32([2.0 ** 16 * (1 - 2.0 ** -23), -(2.0 ** 16) * (1 - 2.0 ** -23),
                                       2.0 ** 16 * (1 + 2.0 ** -23)])])
    c = np.concatenate([c, halfway])
    got = k1.fma_rn(*(torch.as_tensor(t) for t in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.array_equal(twice[-3:].view(np.int32), want[-3:].view(np.int32))
