"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports neither jax nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-5 of the output's largest magnitude plus atol 1e-6.
The kernel sums with float atomics, so its order of additions differs
from the plain version's (and from run to run).
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
from photon_ml_tpu_torch.ops.tiled_sparse import (
    TiledGLMObjective,
    TileParams,
    build_tiled_batch,
)

CASES = {
    "spills": (TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8), 700, 900),
    "no_spills": (TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=0), 700, 900),
    "ads_window": (TileParams(), 20000, 30000),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _close(got, expected):
    g, e = got.cpu().numpy(), expected.cpu().numpy()
    scale = float(np.abs(e).max()) if e.size else 0.0
    np.testing.assert_allclose(g, e, rtol=0.0, atol=1e-6 + 1e-5 * scale)


def _batch(name, device):
    params, n, d = CASES[name]
    rng = np.random.default_rng(3)
    nnz = 12 * n
    rows = rng.integers(0, n, nnz)
    feats = rng.integers(0, d, nnz)
    feats[: nnz // 10] = d - 1  # a heavy column: ragged, long tiles
    vals = rng.normal(size=nnz).astype(np.float32)
    labels = (rng.uniform(size=n) > 0.5).astype(np.float32)
    tb = build_tiled_batch(
        rows, feats, vals, labels, np.zeros(n, np.float32),
        np.ones(n, np.float32), d, params=params, device=device,
    )
    return rng, tb, d


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_bilinear_pass_matches_plain(cuda, name):
    rng, tb, _ = _batch(name, cuda)
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device=cuda)
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device=cuda)
    for sched, src, n_out, vals in (
        (tb.z_sched, w, tb.num_row_blocks, None),
        (tb.g_sched, c, tb.num_feat_blocks, None),
        (tb.g_sched, c, tb.num_feat_blocks, tb.g_vals_sq),
    ):
        before = k1.launches
        got = k1.bilinear_pass(sched, src, n_out, win, vals=vals)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        _close(got, k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals))


@pytest.mark.cuda
def test_objective_on_card_matches_cpu(cuda):
    rng, tb, d = _batch("spills", cuda)
    obj = TiledGLMObjective(losses.LOGISTIC, d)
    w = rng.normal(scale=0.1, size=d).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    cpu_tb = tb.to("cpu")
    for method, args in (
        ("value_and_gradient", (w,)),
        ("hessian_vector", (w, v)),
        ("hessian_diagonal", (w,)),
    ):
        on_card = getattr(obj, method)(
            *(torch.as_tensor(a, device=cuda) for a in args), tb, 0.5
        )
        on_cpu = getattr(obj, method)(*(torch.as_tensor(a) for a in args), cpu_tb, 0.5)
        for x, y in zip(
            on_card if isinstance(on_card, tuple) else (on_card,),
            on_cpu if isinstance(on_cpu, tuple) else (on_cpu,),
        ):
            _close(x, y)


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands(cuda):
    _, tb, _ = _batch("spills", cuda)
    win = tb.params.window
    with pytest.raises(TypeError):
        k1.bilinear_pass(
            tb.z_sched, torch.zeros(tb.dim, dtype=torch.float64, device=cuda),
            tb.num_row_blocks, win,
        )
    with pytest.raises(ValueError):
        k1.bilinear_pass(tb.z_sched, torch.zeros(tb.dim + 1, device=cuda),
                         tb.num_row_blocks, win)
    with pytest.raises(ValueError):
        k1.bilinear_pass(tb.z_sched, torch.zeros(tb.dim - win, device=cuda),
                         tb.num_row_blocks, win)
    with pytest.raises(ValueError):
        k1.bilinear_pass(tb.z_sched, torch.zeros(tb.dim, device=cuda),
                         tb.num_row_blocks - 1, win)
