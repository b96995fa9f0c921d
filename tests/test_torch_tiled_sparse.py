"""The PyTorch port's tiled layout: schedule builders bitwise against the
reference's numpy builder, and the tiled batch built end to end.

The schedule arrays are the kernel's input format, so both of the port's
builders (numpy and native counting sort) must reproduce the reference's
arrays exactly (bitwise, no tolerance).
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import tiled_sparse as ref_ts
from photon_ml_tpu_torch.ops import tiled_sparse as ts
from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
from tests.torch_parity import both_batches, random_rows

FIELDS = (
    "step_out", "step_in", "step_init", "out_pos", "in_pos", "vals",
    "spill_out", "spill_in", "spill_vals",
)


def _coo(seed, n, d, nnz, empty_row_window=False):
    """Random COO with duplicates, a heavy (intercept-like) feature and,
    optionally, a run of rows without entries (an output block that needs
    a zero-entry init step)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=nnz).astype(np.int64)
    feats = rng.integers(0, d, size=nnz).astype(np.int64)
    feats[: nnz // 5] = d - 1
    if empty_row_window:
        rows = np.where((rows >= 64) & (rows < 128), rows - 64, rows)
    vals = rng.normal(size=nnz).astype(np.float32)
    return rows, feats, vals


def sorted_reference(ref_sched, window, g_vals_sq=None):
    """A reference schedule's arrays by FIELDS name, each step's entries
    sorted by output slot as the port's ``_Schedule.from_numpy`` holds
    them (and ``g_vals_sq`` with them, under that name)."""
    arrays = {name: np.asarray(a) for name, a in zip(FIELDS, ref_sched)}
    sizes = k1.step_sizes(arrays["vals"], arrays["step_out"].shape[0])
    extra = () if g_vals_sq is None else (np.asarray(g_vals_sq),)
    o, i, v, *more = ts.sort_steps_by_output(
        sizes, window, arrays["out_pos"], arrays["in_pos"], arrays["vals"], *extra
    )
    arrays.update(out_pos=o, in_pos=i, vals=v)
    if more:
        arrays["g_vals_sq"] = more[0]
    return arrays


@pytest.fixture
def reference_numpy_builder(monkeypatch):
    """The reference's own numpy builder (its native builder switched off),
    the oracle for both port builders."""
    monkeypatch.setattr(ref_ts, "_build_schedule_native", lambda *a, **k: None)

    def build(rows, feats, vals, **kw):
        return ref_ts._build_schedule_np(rows, feats, vals, **kw)

    return build


CASES = [
    # (params, n rows, dim, nnz, empty_row_window)
    (dict(s_hi=8, s_lo=8, chunk=32, spill_cap=8), 300, 200, 1500, False),
    (dict(s_hi=8, s_lo=8, chunk=32, spill_cap=0), 300, 200, 1500, True),
    (dict(s_hi=8, s_lo=4, chunk=16, spill_cap=None), 500, 700, 4000, True),
    (dict(s_hi=16, s_lo=8, chunk=64, spill_cap=40), 1000, 400, 9000, False),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("by_feature", [False, True])
@pytest.mark.parametrize("builder", ["numpy", "native"])
def test_builders_bitwise_equal_reference(
    reference_numpy_builder, case, by_feature, builder
):
    pkw, n, d, nnz, empty = CASES[case]
    rows, feats, vals = _coo(case, n, d, nnz, empty)
    win = pkw["s_hi"] * pkw["s_lo"]
    n_out = -(-(d if by_feature else n) // win)
    kw = dict(sort_by_feature_block=by_feature, num_out_blocks=n_out)
    expected = reference_numpy_builder(
        rows, feats, vals, params=ref_ts.TileParams(**pkw), **kw
    )
    fn = (
        ts._build_schedule_numpy if builder == "numpy"
        else ts._build_schedule_native
    )
    got = fn(rows, feats, vals, params=ts.TileParams(**pkw), **kw)
    assert got is not None, "native builder unavailable (g++ missing?)"
    assert len(got) == len(expected) == len(FIELDS)
    for name, a, b in zip(FIELDS, got, expected):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_native_builder_is_used():
    rows, feats, vals = _coo(0, 300, 200, 1500)
    _, builder = ts._build_schedule(
        rows, feats, vals, params=ts.TileParams(s_hi=8, s_lo=8, chunk=32),
        sort_by_feature_block=False, num_out_blocks=5,
    )
    assert builder == "native"


@pytest.mark.parametrize("chunk", [None, 32])
def test_tiled_batch_matches_reference(chunk):
    """Whole batch: resolved params, padded shapes, both schedules, squared
    values and row arrays equal the reference's (bitwise)."""
    rng = np.random.default_rng(3)
    d = 150
    rows, labels = random_rows(rng, n=200, d=d)
    weights = rng.uniform(0.5, 2.0, len(rows))
    offsets = rng.normal(size=len(rows))
    ref_batch, batch = both_batches(rows, labels, weights, offsets)
    p = dict(s_hi=8, s_lo=8, chunk=chunk)
    ref_tb = ref_ts.tiled_batch_from_sparse(
        ref_batch, d, params=ref_ts.TileParams(**p)
    )
    tb = ts.tiled_batch_from_sparse(batch, d, params=ts.TileParams(**p), device="cpu")
    assert tb.params.chunk == ref_tb.params.chunk
    assert (tb.num_rows, tb.dim, tb.num_real_rows, tb.real_dim) == (
        ref_tb.num_rows, ref_tb.dim, ref_tb.num_real_rows, ref_tb.real_dim,
    )
    # the port holds each step's entries sorted by output slot (the order
    # its kernels add in): the reference's arrays, so sorted, bitwise
    for pass_name in ("z_sched", "g_sched"):
        expected = sorted_reference(
            getattr(ref_tb, pass_name), tb.params.window,
            ref_tb.g_vals_sq if pass_name == "g_sched" else None,
        )
        for name in FIELDS:
            a = getattr(getattr(tb, pass_name), name).numpy()
            assert np.array_equal(a, expected[name]), (pass_name, name)
        if pass_name == "g_sched":
            assert np.array_equal(tb.g_vals_sq.numpy(), expected["g_vals_sq"])
    for name in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(ref_tb, name)))


def test_schedule_checks_reject_bad_indices():
    rows, feats, vals = _coo(1, 300, 200, 1500)
    params = ts.TileParams(s_hi=8, s_lo=8, chunk=32)
    arrays, _ = ts._build_schedule(
        rows, feats, vals, params=params, sort_by_feature_block=False,
        num_out_blocks=5,
    )
    kw = dict(window=64, num_out_blocks=5, num_in_blocks=4, device="cpu")
    ts._Schedule.from_numpy(arrays, **kw)
    bad = list(arrays)
    bad[4] = arrays[4].copy()
    bad[4][0, 0] = 64  # in_pos past the window
    with pytest.raises(ValueError, match="in_pos"):
        ts._Schedule.from_numpy(bad, **kw)
    bad = list(arrays)
    bad[2] = np.zeros_like(arrays[2])  # step_init no longer marks starts
    with pytest.raises(ValueError, match="step_init"):
        ts._Schedule.from_numpy(bad, **kw)


def test_apply_spill_adds_remainder_in_place():
    sched = ts._Schedule(
        *(torch.zeros(0, dtype=torch.int32) for _ in range(3)),
        *(torch.zeros((0, 4), dtype=t) for t in (torch.int32, torch.int32, torch.float32)),
        torch.tensor([0, 2, 2], dtype=torch.int32),
        torch.tensor([1, 0, 3], dtype=torch.int32),
        torch.tensor([2.0, 3.0, 0.5]),
        torch.zeros(0, dtype=torch.int32),
        window=1, num_out_blocks=3, num_in_blocks=4,
    )
    out = torch.zeros(3)
    src = torch.tensor([1.0, 10.0, 100.0, 1000.0])
    sched.apply_spill(out, src)
    assert out.tolist() == [20.0, 0.0, 503.0]


@pytest.mark.parametrize("members", [0, 3])
def test_sorted_spill_matches_reference_apply_spill(members):
    """The spill remainder in the card's order (each output's spilled
    products summed in entry order, then added once, as K1 and K2 fold it
    into a pass; ``bilinear_pass.spill_ordered``) and in its CPU order, on
    a vector and a bank, against the JAX package's
    ``_Schedule.apply_spill``: within 1e-6 of scale; the CPU order is
    ``index_add_``'s, bitwise. The sort the kernels read covers every
    spilled entry once, its outputs ascending, and its map gives each
    spilled output its slot and every other output -1."""
    import jax.numpy as jnp

    rows, feats, vals = _coo(3, 300, 200, 1500)
    params = dict(s_hi=8, s_lo=8, chunk=32, spill_cap=8)
    arrays, _ = ts._build_schedule(
        rows, feats, vals, params=ts.TileParams(**params),
        sort_by_feature_block=True, num_out_blocks=4,
    )
    ref = ref_ts._Schedule(*[jnp.asarray(a) for a in arrays])
    sched = ts._Schedule.from_numpy(
        arrays, window=64, num_out_blocks=4, num_in_blocks=5, device="cpu"
    )
    assert int(torch.count_nonzero(sched.spill_vals)) > 0
    rng = np.random.default_rng(1)
    shape = (members,) if members else ()
    base = rng.normal(size=shape + (256,)).astype(np.float32)
    src = rng.normal(size=shape + (320,)).astype(np.float32)
    if members:
        expected = np.stack([
            np.asarray(ref.apply_spill(jnp.asarray(base[g]), jnp.asarray(src[g])))
            for g in range(members)
        ])
    else:
        expected = np.asarray(ref.apply_spill(jnp.asarray(base), jnp.asarray(src)))
    got = sched.apply_spill(torch.as_tensor(base).clone(), torch.as_tensor(src))
    plain = torch.as_tensor(base).clone().index_add_(
        -1, sched.spill_out, sched.spill_vals * torch.as_tensor(src).index_select(-1, sched.spill_in)
    )
    assert torch.equal(got, plain)
    from photon_ml_tpu_torch.ops.kernels.bilinear_pass import spill_plan

    plan = spill_plan(sched.spill_out, sched.spill_in, sched.spill_vals, 64, 4)
    assert sorted(plan.order.tolist()) == list(range(sched.spill_out.shape[0]))
    assert int(plan.offsets[-1]) == sched.spill_out.shape[0]
    assert bool((plan.slots[1:] > plan.slots[:-1]).all())
    assert torch.equal(plan.in_pos.long(), sched.spill_in[plan.order].long())
    assert torch.equal(plan.vals, sched.spill_vals[plan.order])
    slot_map = torch.full((4 * 64,), -1, dtype=torch.int32)
    slot_map[plan.slots.long()] = torch.arange(plan.num_segments, dtype=torch.int32)
    assert torch.equal(plan.map, slot_map)
    card_order = k1.spill_ordered(torch.as_tensor(base).clone(), torch.as_tensor(src), plan)
    scale = float(np.abs(expected).max())
    for out in (got, card_order):
        np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-6 * scale)


def test_fixed_order_plan_and_cache():
    """A segment plan groups the sources by output, stably; the cached plan
    is found again for the same unedited tensor and made anew after an
    in-place edit."""
    from photon_ml_tpu_torch.ops import fixed_order

    index = torch.tensor([4, 1, 4, 0, 1, 4])
    plan = fixed_order.segment_plan(index)
    assert plan.order.tolist() == [3, 1, 4, 0, 2, 5]
    assert plan.slots.tolist() == [0, 1, 4] and plan.offsets.tolist() == [0, 1, 3, 6]
    assert fixed_order.cached_plan(index) is fixed_order.cached_plan(index)
    first = fixed_order.cached_plan(index)
    index[0] = 2
    again = fixed_order.cached_plan(index)
    assert again is not first and again.slots.tolist() == [0, 1, 2, 4]
    src = torch.arange(12.0).reshape(2, 6)
    out = fixed_order.segmented_add(torch.zeros(2, 5), src, again)
    assert torch.equal(out, torch.zeros(2, 5).index_add_(-1, index, src))


def test_fixed_order_row_scatter_matches_scatter_add():
    """The random effect's row-wise scatter in its card order
    (``scatter_add_rows``' plan over row * width + index) equals
    ``scatter_add_`` on integer-valued sources, duplicates included."""
    from photon_ml_tpu_torch.ops import fixed_order

    rng = np.random.default_rng(4)
    index = torch.as_tensor(rng.integers(0, 6, size=(3, 4, 5)))
    src = torch.as_tensor(rng.integers(-5, 5, size=(3, 4, 5)).astype(np.float32))
    want = torch.zeros(3, 4, 6).scatter_add_(-1, index, src)
    plan = fixed_order.cached_plan(index, 6)
    got = fixed_order.segmented_add(torch.zeros(3 * 4 * 6), src.reshape(-1), plan)
    assert torch.equal(got.view(3, 4, 6), want)
    assert torch.equal(fixed_order.scatter_add_rows(torch.zeros(3, 4, 6), index, src), want)
