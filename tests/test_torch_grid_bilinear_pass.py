"""K2, the grid-batched bilinear pass, in the PyTorch port: its plain
version against the reference's ``_grid_bilinear_pass`` (the operator the
reference's ``custom_vmap`` rule swaps in for a coefficient bank) on the
reference's own schedules, and against G calls of K1's plain version. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``.

Tolerance: normwise, 1e-6 of the output's largest magnitude (plus atol
1e-7) against the reference, which computes the same flat gather and
scatter-add in f32; bitwise against K1's plain version, which adds the same
products in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import _grid_bilinear_pass
from photon_ml_tpu.ops.tiled_sparse import (
    tiled_batch_from_sparse as ref_tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2
from tests.test_torch_bilinear_pass import _emulate
from tests.torch_parity import (
    assert_close_to_scale,
    both_batches,
    port_tiled_batch,
    random_rows,
)

CASES = {
    "spills": (RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8), 100, 150),
    "multi_window": (RefTileParams(s_hi=8, s_lo=4, chunk=16, spill_cap=4), 300, 500),
}


def _problem(name):
    params, n, d = CASES[name]
    rng = np.random.default_rng(5)
    rows, labels = random_rows(rng, n=n, d=d)
    ref_batch, _ = both_batches(rows, labels)
    ref_tb = ref_tiled_batch_from_sparse(ref_batch, d, params=params)
    return rng, params, ref_tb, port_tiled_batch(ref_tb)


def _passes(ref_tb, tb, rng, G):
    """(label, ref schedule, port schedule, source bank, output blocks,
    ref values, port values) of the z, g and g_sq passes."""
    w = rng.normal(size=(G, tb.dim)).astype(np.float32)
    c = rng.normal(size=(G, tb.num_rows)).astype(np.float32)
    return [
        ("z", ref_tb.z_sched, tb.z_sched, w, tb.num_row_blocks, None, None),
        ("g", ref_tb.g_sched, tb.g_sched, c, tb.num_feat_blocks, None, None),
        (
            "g_sq", ref_tb.g_sched, tb.g_sched, c, tb.num_feat_blocks,
            ref_tb.g_vals_sq, tb.g_vals_sq,
        ),
    ]


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_grid_pass_matches_reference(name, G):
    rng, params, ref_tb, tb = _problem(name)
    win = params.window
    for label, ref_sched, sched, src, n_out, ref_vals, vals in _passes(
        ref_tb, tb, rng, G
    ):
        expected = np.asarray(_grid_bilinear_pass(
            ref_sched, jnp.asarray(src.reshape(G, -1, params.s_hi, params.s_lo)),
            n_out, params, vals=ref_vals,
        )).reshape(G, -1)
        got = k2.grid_bilinear_pass(sched, torch.as_tensor(src), n_out, win, vals=vals)
        assert got.shape == (G, n_out * win), label
        assert_close_to_scale(got, expected, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_grid_pass_equals_k1_per_member(name, G):
    rng, params, ref_tb, tb = _problem(name)
    win = params.window
    for label, _, sched, src, n_out, _, vals in _passes(ref_tb, tb, rng, G):
        bank = torch.as_tensor(src)
        got = k2.grid_bilinear_pass(sched, bank, n_out, win, vals=vals)
        for g in range(G):
            one = k1.bilinear_pass(sched, bank[g], n_out, win, vals=vals)
            assert torch.equal(got[g], one), (label, g)


def test_bank_spills_add_row_by_row():
    """K3 over a bank: each row gets the remainder of its own source."""
    _, params, _, tb = _problem("spills")
    sched = tb.z_sched
    assert int(torch.count_nonzero(sched.spill_vals)) > 0
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(3, tb.dim)).astype(np.float32))
    out = torch.zeros(3, tb.num_rows)
    sched.apply_spill(out, src)
    for g in range(3):
        one = sched.apply_spill(torch.zeros(tb.num_rows), src[g])
        assert torch.equal(out[g], one)


SLOTS = 132  # an H100's resident CTAs of K2 (132 SMs, one each)


@pytest.mark.parametrize(
    "G,window,blocks,expected",
    [(1, 8192, 32, 1), (4, 8192, 32, 1), (4, 8192, 128, 4), (4, 8192, 16, 1),
     (4, 8192, 64, 2), (9, 8192, 128, 5), (9, 8192, 32, 3), (16, 64, 1, 1),
     (17, 64, 200, 6), (7, 8192, 128, 7), (2, 32768, 4, 1), (4, 16384, 64, 2)],
)
def test_members_per_cta_fit_shared_memory_and_balance(G, window, blocks, expected):
    """As many member tiles as still run in one wave beside one work item
    per output block, and no fewer than the accumulators [GT, W] need to
    fit shared memory (at most 7 members a tile); balanced tiles of one
    size but the last: every member in exactly one tile."""
    gt = k2.members_per_cta(G, window, blocks, SLOTS)
    assert gt == expected
    assert gt * window * 4 <= k1.MAX_SHARED_BYTES
    assert gt <= k2.MAX_MEMBERS_PER_CTA
    n_tiles = -(-G // gt)
    assert (n_tiles - 1) * gt < G <= n_tiles * gt
    cap = min(k2.MAX_MEMBERS_PER_CTA, k1.MAX_SHARED_BYTES // (4 * window))
    assert -(-G // cap) <= n_tiles <= max(-(-G // cap), min(G, SLOTS // blocks))
    assert n_tiles * blocks <= SLOTS or n_tiles == -(-G // cap)  # one wave


def test_members_per_cta_rejects_a_window_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        k2.members_per_cta(1, 65536, 1, SLOTS)


@pytest.mark.parametrize("G,target", [(1, 4), (4, 1), (4, 33), (9, 7)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_emulation_matches_reference_grid_pass(name, G, target):
    """K2's launch grid in numpy: each (work item, member tile) CTA's
    partial windows for its members, stored or added as the plan says;
    equal to the reference's ``_grid_bilinear_pass`` on every pass."""
    rng, params, ref_tb, tb = _problem(name)
    win = params.window
    gt = k2.members_per_cta(G, win, ref_tb.num_row_blocks, SLOTS)
    for label, ref_sched, sched, src, n_out, ref_vals, vals in _passes(
        ref_tb, tb, rng, G
    ):
        items = k1.plan_work(sched.step_out.numpy(), sched.step_sizes.numpy(), target, n_out)
        got = np.full((G, n_out * win), np.nan)
        for g0 in range(0, G, gt):
            tile = slice(g0, min(G, g0 + gt))
            got[tile] = _emulate(items, sched, src[tile], n_out, win, vals)
        assert not np.isnan(got).any(), label
        expected = np.asarray(_grid_bilinear_pass(
            ref_sched, jnp.asarray(src.reshape(G, -1, params.s_hi, params.s_lo)),
            n_out, params, vals=ref_vals,
        )).reshape(G, -1)
        assert_close_to_scale(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["vector", "short", "empty", "few_out_blocks"])
def test_operands_outside_the_checked_schedule_raise(bad):
    _, params, _, tb = _problem("multi_window")
    win, n_out = params.window, tb.num_row_blocks
    src = torch.zeros(2, tb.dim)
    if bad == "vector":
        src = src[0]
    elif bad == "short":
        src = src[:, :-win]
    elif bad == "empty":
        src = src[:0]
    else:
        n_out -= 1
    with pytest.raises(ValueError, match="grid_bilinear_pass"):
        k2.grid_bilinear_pass(tb.z_sched, src, n_out, win)
