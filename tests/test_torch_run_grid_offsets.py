"""``GLMOptimizationProblem.run_grid(offsets_bank=)`` (``optim/problem.py``):
member g of the λ-grid solves against its own ``[n]`` offsets, the batch's
offsets ignored, columns short of the padded row count zero-extended; on
the tiled objective the bank's passes are K2 (its plain version here) and
each member's offsets are added to its own margins.

Against the JAX package's ``run_grid(offsets_bank=)`` at G = 4 on the same
inputs (the scatter objective, and the tiled one on the reference's own
schedule): the same iterations and stop reasons, values within rtol 1e-5,
coefficients within 1e-4 of scale (as ``test_torch_grid.py``). Within the
port: a bank whose every row is ``batch.offsets`` gives the plain
``run_grid``'s bits; distinct rows give each member within 1e-5 of scale
of a sequential ``run`` with those offsets; a data mesh cuts each rank's
columns.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.batch import SparseBatch as RefSparseBatch
from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import tiled_batch_from_sparse as ref_tiled
from photon_ml_tpu.optim import config as ref_config
from photon_ml_tpu.optim.problem import create_glm_problem as ref_create_problem
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
from photon_ml_tpu_torch.ops import tiled_sparse as ts
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import _member_offsets, create_glm_problem
from photon_ml_tpu_torch.parallel.mesh import ProcessMesh
from photon_ml_tpu_torch.task import TaskType
from tests.torch_parity import assert_close, assert_close_to_scale, port_tiled_batch

D, N = 48, 500
LAMBDAS = [10.0, 1.0, 0.1, 0.01]
G = len(LAMBDAS)
PARAMS = RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8)


def _arrays(seed=1, k=6):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, D, size=(N, k)).astype(np.int32),
        rng.normal(size=(N, k)).astype(np.float32),
        (rng.uniform(size=N) > 0.5).astype(np.float32),
        (rng.normal(size=N) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2.0, size=N).astype(np.float32),
    )


def _batches(kernel, arrays):
    ref = RefSparseBatch(*(jnp.asarray(a) for a in arrays))
    if kernel == "tiled":
        ref_tb = ref_tiled(ref, D, params=PARAMS)
        return ref_tb, port_tiled_batch(ref_tb)
    return ref, sparse_batch_from_arrays(*arrays, device="cpu")


def _bank(seed=7, columns=N - 13):
    """Distinct offsets per member, ``columns`` short of the rows."""
    return (np.random.default_rng(seed).normal(size=(G, columns)) * 0.5).astype(np.float32)


def _problems(kernel, opt="LBFGS", tol=1e-5):
    ref = ref_create_problem(
        RefTaskType.LOGISTIC_REGRESSION, D, kernel=kernel,
        config=ref_config.OptimizerConfig(ref_config.OptimizerType(opt), tolerance=tol),
        regularization=ref_config.RegularizationContext(ref_config.RegularizationType.L2),
    )
    ours = create_glm_problem(
        TaskType.LOGISTIC_REGRESSION, D, kernel=kernel, compute_variances=True,
        config=OptimizerConfig(OptimizerType(opt), tolerance=tol),
        regularization=RegularizationContext(RegularizationType.L2),
    )
    return ref, ours


@pytest.mark.parametrize("opt,tol", [("LBFGS", 1e-5), ("TRON", 1e-4)])
@pytest.mark.parametrize("kernel", ["scatter", "tiled"])
def test_offsets_bank_matches_reference(kernel, opt, tol):
    ref_batch, batch = _batches(kernel, _arrays())
    bank = _bank()
    ref_problem, problem = _problems(kernel, opt, tol)
    _, want = ref_problem.run_grid(ref_batch, LAMBDAS, offsets_bank=jnp.asarray(bank))
    variances, got = problem.run_grid(batch, LAMBDAS, offsets_bank=torch.as_tensor(bank))
    assert got.iterations == [int(i) for i in want.iterations]
    assert got.reason == [int(r) for r in want.reason]
    assert_close(got.value, want.value, rtol=1e-5)
    assert_close_to_scale(got.coefficients, want.coefficients, rtol=1e-4)
    assert variances.shape == (G, D) and torch.isfinite(variances).all()


@pytest.mark.parametrize("kernel", ["scatter", "tiled"])
def test_repeated_offsets_are_the_plain_grid_bitwise(kernel):
    _, batch = _batches(kernel, _arrays(2))
    _, problem = _problems(kernel)
    plain_var, plain = problem.run_grid(batch, LAMBDAS)
    rows = batch.offsets.shape[0]
    bank = batch.offsets.expand(G, rows).clone()
    var, got = problem.run_grid(batch, LAMBDAS, offsets_bank=bank)
    for a, b in ((got.coefficients, plain.coefficients), (got.value, plain.value),
                 (var, plain_var)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert got.iterations == plain.iterations and got.reason == plain.reason


@pytest.mark.parametrize("kernel", ["scatter", "tiled"])
def test_each_member_is_a_fit_with_its_offsets(kernel):
    """Distinct rows: member g within 1e-5 of scale of ``run`` at λ_g on
    the batch carrying row g's offsets (zero-extended)."""
    arrays = _arrays(3)
    _, batch = _batches(kernel, arrays)
    _, problem = _problems(kernel, tol=1e-9)
    problem = dataclasses.replace(
        problem, config=OptimizerConfig(max_iter=300, tolerance=1e-9))
    bank = _bank(8)
    _, got = problem.run_grid(batch, LAMBDAS, offsets_bank=torch.as_tensor(bank))
    for g, lam in enumerate(LAMBDAS):
        row = np.zeros(N, np.float32)
        row[: bank.shape[1]] = bank[g]
        one = sparse_batch_from_arrays(*arrays[:3], row, arrays[4], device="cpu")
        if kernel == "tiled":
            one = ts.ensure_tiled(one, D, params=ts.TileParams(8, 8, 32, 8), device="cpu")
        coef, res = problem.run(one, reg_weight=lam)
        assert_close_to_scale(got.coefficients[g], coef.means, rtol=1e-5)


def test_mesh_takes_each_shard_s_columns():
    """On a data mesh of 3 each rank's ``[G, rows]`` are its shard's
    columns of the bank zero-extended to every shard's rows."""
    batch = sparse_batch_from_arrays(*(a[:40] for a in _arrays(4)), device="cpu")
    bank = torch.arange(G * 100, dtype=torch.float32).reshape(G, 100)
    for index in range(3):
        mesh = ProcessMesh((3,), ("data",), index, (index,), {"data": None}, None,
                           torch.device("cpu"))
        got = _member_offsets(bank, batch, G, mesh)
        want = torch.nn.functional.pad(bank, (0, 120 - 100))[:, index * 40:(index + 1) * 40]
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match=r"offsets_bank must be \[4, n\]"):
        _member_offsets(bank[:3], batch, G, None)
    with pytest.raises(ValueError, match="101 columns for 40 rows"):
        _member_offsets(torch.zeros(G, 101), batch, G, None)
