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


@pytest.mark.parametrize("steps_per_cta", [1, 3, 8])
def test_segments_cover_each_step_once_within_one_block(steps_per_cta):
    step_out = np.array([0, 0, 0, 0, 1, 2, 2, 2, 2, 2, 2, 2, 5], np.int32)
    seg = k1.plan_segments(step_out, steps_per_cta)
    covered = np.concatenate([np.arange(a, b) for _, a, b in seg])
    assert np.array_equal(covered, np.arange(len(step_out)))
    for block, a, b in seg:
        assert 0 < b - a <= steps_per_cta
        assert np.all(step_out[a:b] == block)
    assert k1.plan_segments(np.zeros(0, np.int32)).shape == (0, 3)


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
