"""The batched λ-grid in the PyTorch port against the reference:
``train_grid_batched`` / ``GLMOptimizationProblem.run_grid`` in both
packages on the same inputs (the scatter objective, and the tiled one on
the reference's own schedule, where the reference's vmap runs its exact
f32 grid pass and the port its plain K2), for L-BFGS and TRON with L2 and
OWL-QN with elastic net; with a box, a normalization, offsets and
variances. Then the port's own contracts: a converged member freezes bit
for bit, the host fetches do not grow with G, and no bank pass goes
through K1.

Expected values come from calling the reference directly, never from its
grid-vs-sequential tests (those sit at the edge of their envelopes). Each
case stops on a convergence tolerance of 1e-5 to 1e-3, not the default
1e-7: at |f| ~ 400 the default's function-change test compares differences
of about one f32 ulp, and near the optimum TRON's accept test and the box
and orthant projections branch on rounding, so two f32 programs that sum
in another order part there. Before that point they agree: the same
iterations and stop reason per member, values within rtol 1e-5,
coefficients and variances within 1e-4 of their largest magnitude
(tighter than the reference's own grid envelopes, atol 1e-3 for L-BFGS
and TRON and 5e-3 for elastic net).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu import training as ref_training
from photon_ml_tpu.data.batch import SparseBatch as RefSparseBatch
from photon_ml_tpu.ops.normalization import NormalizationContext as RefNorm
from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import (
    tiled_batch_from_sparse as ref_tiled_batch_from_sparse,
)
from photon_ml_tpu.optim import config as ref_config
from photon_ml_tpu.optim.common import BoxConstraints as RefBox
from photon_ml_tpu.optim.problem import create_glm_problem as ref_create_problem
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu_torch import training
from photon_ml_tpu_torch.convert import (
    coefficient_bank_from_reference,
    normalization_from_reference,
)
from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
from photon_ml_tpu_torch.ops import tiled_sparse as ts
from photon_ml_tpu_torch.optim import common, lbfgs
from photon_ml_tpu_torch.optim.common import BoxConstraints
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.task import TaskType
from tests.torch_parity import assert_close, assert_close_to_scale, port_tiled_batch

D = 48
LAMBDAS = [10.0, 1.0, 0.1, 0.01]
TOL = 1e-5  # the port-only tests' convergence tolerance
PARAMS = RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8)


def _arrays(seed, n=500, k=6):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, D, size=(n, k)).astype(np.int32),
        rng.normal(size=(n, k)).astype(np.float32),
        (rng.uniform(size=n) > 0.5).astype(np.float32),
        (rng.normal(size=n) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2.0, size=n).astype(np.float32),
    )


def _batches(seed, kernel):
    """-> (reference batch, port batch) of weighted rows with offsets, as a
    SparseBatch or, for the tiled kernel, the reference's tiled batch and
    the same schedule carried into the port."""
    arrays = _arrays(seed)
    ref = RefSparseBatch(*(jnp.asarray(a) for a in arrays))
    if kernel == "tiled":
        ref_tb = ref_tiled_batch_from_sparse(ref, D, params=PARAMS)
        return ref_tb, port_tiled_batch(ref_tb)
    return ref, sparse_batch_from_arrays(*arrays, device="cpu")


def _extras(seed):
    """(reference kwargs, port kwargs): a box, a shift/factor
    normalization with an intercept slot, and variances."""
    rng = np.random.default_rng(seed)
    factor = rng.uniform(0.5, 2.0, D).astype(np.float32)
    shift = (rng.normal(size=D) * 0.1).astype(np.float32)
    factor[-1], shift[-1] = 1.0, 0.0
    lo, hi = np.full(D, -0.3, np.float32), np.full(D, 0.3, np.float32)
    ref = dict(
        normalization=RefNorm(jnp.asarray(factor), jnp.asarray(shift)),
        box=RefBox(jnp.asarray(lo), jnp.asarray(hi)),
        compute_variances=True, intercept_index=D - 1,
    )
    port = dict(
        normalization=normalization_from_reference(factor, shift, device="cpu"),
        box=BoxConstraints(torch.as_tensor(lo), torch.as_tensor(hi)),
        compute_variances=True, intercept_index=D - 1,
    )
    return ref, port


CASES = {
    # name: (optimizer, regularization, alpha, with box/normalization/
    # variances, convergence tolerance)
    "lbfgs_l2": ("LBFGS", "L2", None, False, 1e-5),
    "tron_l2": ("TRON", "L2", None, False, 1e-4),
    "owlqn_elastic_net": ("LBFGS", "ELASTIC_NET", 0.5, False, 1e-5),
    "lbfgs_l2_box_norm_variances": ("LBFGS", "L2", None, True, 1e-3),
    "owlqn_elastic_net_box_norm_variances": ("LBFGS", "ELASTIC_NET", 0.5, True, 1e-4),
}


@pytest.mark.parametrize("kernel", ["scatter", "tiled"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_matches_reference(name, kernel):
    opt, reg, alpha, extras, tol = CASES[name]
    ref_batch, batch = _batches(1, kernel)
    ref_kw, port_kw = _extras(2) if extras else ({}, {})
    common_kw = dict(
        regularization_weights=LAMBDAS, elastic_net_alpha=alpha,
        tolerance=tol, kernel=kernel,
    )
    ref_models, ref_results = ref_training.train_grid_batched(
        ref_batch, RefTaskType.LOGISTIC_REGRESSION, D,
        optimizer_type=ref_config.OptimizerType(opt),
        regularization_type=ref_config.RegularizationType(reg),
        **common_kw, **ref_kw,
    )
    models, results = training.train_grid_batched(
        batch, TaskType.LOGISTIC_REGRESSION, D,
        optimizer_type=OptimizerType(opt),
        regularization_type=RegularizationType(reg), device="cpu",
        **common_kw, **port_kw,
    )
    assert list(models) == list(ref_models) == sorted(LAMBDAS, reverse=True)
    iterations = set()
    for lam in LAMBDAS:
        r, ref_r = results[lam], ref_results[lam]
        assert (r.iterations, r.reason) == (
            int(ref_r.iterations), int(ref_r.reason)
        ), lam
        assert r.tracker.count == int(ref_r.tracker.count), lam
        iterations.add(r.iterations)
        assert_close(r.value, ref_r.value, rtol=1e-5)
        assert_close_to_scale(
            models[lam].coefficients.means, ref_models[lam].coefficients.means,
            rtol=1e-4,
        )
        assert_close_to_scale(
            r.tracker.values[: r.tracker.count],
            np.asarray(ref_r.tracker.values)[: r.tracker.count], rtol=1e-5,
        )
        if extras:
            assert_close_to_scale(
                models[lam].coefficients.variances,
                ref_models[lam].coefficients.variances, rtol=1e-4,
            )
            assert float(models[lam].coefficients.means.abs().max()) > 0
    if opt == "LBFGS":  # members stop at different trips: freeze is exercised
        assert len(iterations) > 1


def test_run_grid_from_a_reference_bank():
    """``initial`` as a [G, d] bank carried over from the reference, and
    the bank's own OptResult (leading grid axis), against the reference's
    run_grid."""
    ref_batch, batch = _batches(3, "scatter")
    G = len(LAMBDAS)
    bank = (np.random.default_rng(4).normal(size=(G, D)) * 0.1).astype(np.float32)
    ref_problem = ref_create_problem(
        RefTaskType.LOGISTIC_REGRESSION, D,
        config=ref_config.OptimizerConfig(tolerance=1e-4),
        regularization=ref_config.RegularizationContext(ref_config.RegularizationType.L2),
    )
    kw = dict(
        config=OptimizerConfig(tolerance=1e-4),
        regularization=RegularizationContext(RegularizationType.L2),
    )
    problem = create_glm_problem(TaskType.LOGISTIC_REGRESSION, D, **kw)
    _, ref_result = ref_problem.run_grid(ref_batch, LAMBDAS, initial=jnp.asarray(bank))
    initial = coefficient_bank_from_reference(bank, device="cpu").means
    variances, result = problem.run_grid(batch, LAMBDAS, initial=initial)
    assert variances is None
    assert result.coefficients.shape == (G, D)
    assert result.iterations == [int(i) for i in ref_result.iterations]
    assert result.reason == [int(r) for r in ref_result.reason]
    assert result.reason_name == [
        result.member(g).reason_name for g in range(G)
    ] == [common.CONVERGENCE_REASON_NAMES[int(r)] for r in ref_result.reason]
    assert_close(result.value, ref_result.value, rtol=1e-5)
    assert_close_to_scale(result.coefficients, ref_result.coefficients, rtol=1e-4)
    with pytest.raises(ValueError, match="bank"):
        coefficient_bank_from_reference(bank[0])


def _pushed_memory(G, skip, frozen_after, trips=6, m=4, d=16):
    """An L-BFGS memory of G members after ``trips`` pushes of seeded
    pairs: member ``skip`` gets a pair with y.s < 0 (the cautious update
    drops it) on every third trip; member ``frozen_after`` stops being
    active after that many trips. Also -> each member's pairs as a list,
    oldest first, kept by hand."""
    rng = np.random.default_rng(9)
    mem = lbfgs._Memory.empty(G, m, d, torch.zeros(1))
    pairs = [[] for _ in range(G)]
    for trip in range(trips):
        s = torch.as_tensor(rng.normal(size=(G, d)).astype(np.float32))
        y = s * torch.as_tensor(rng.uniform(0.5, 2.0, size=(G, d)).astype(np.float32))
        if skip is not None and trip % 3 == 2:
            y[skip] = -y[skip]
        active = torch.ones(G, dtype=torch.bool)
        if frozen_after is not None and trip >= frozen_after:
            active[frozen_after] = False
        ys = (s * y).sum(dim=1)
        keep = (ys > 1e-10) & active
        mem.push(s, y, 1.0 / ys, keep, keep.tolist())
        for k in range(G):
            if keep[k]:
                pairs[k] = (pairs[k] + [(s[k], y[k])])[-m:]
    return mem, pairs


@pytest.mark.parametrize(
    "skip,frozen_after", [(None, None), (1, None), (None, 2), (1, 2)]
)
def test_two_loop_slot_views_match_gathers(skip, frozen_after):
    """The memory's host counts follow the pairs each member kept; the
    two-loop direction of each member of the bank (slot views while the
    members agree, per-member gathers once one skips a pair or freezes)
    equals the classic recursion over that member's own pairs, and
    forcing gathers on the bank changes nothing. Tolerance: rtol 1e-5,
    atol 1e-6 (f32 sums of another shape)."""
    G, d = 3, 16
    mem, pairs = _pushed_memory(G, skip, frozen_after, d=d)
    assert mem.length == [len(p) for p in pairs]
    assert mem.uniform() == (skip is None and frozen_after is None)
    g = torch.as_tensor(np.random.default_rng(10).normal(size=(G, d)).astype(np.float32))
    bank = lbfgs._two_loop_direction(g, mem)
    mem.uniform = lambda: False
    assert_close(lbfgs._two_loop_direction(g, mem), bank, rtol=1e-5, atol=1e-6)
    for k in range(G):
        q, alphas = g[k], []
        for s, y in reversed(pairs[k]):
            a = torch.dot(s, q) / torch.dot(y, s)
            q = q - a * y
            alphas.append(a)
        s, y = pairs[k][-1]
        r = torch.dot(s, y) / torch.dot(y, y) * q
        for (s, y), a in zip(pairs[k], reversed(alphas)):
            r = r + (a - torch.dot(y, r) / torch.dot(y, s)) * s
        assert_close(bank[k], -r, rtol=1e-5, atol=1e-6)


def _freeze_problem(max_iter):
    return create_glm_problem(
        TaskType.LOGISTIC_REGRESSION, D,
        config=OptimizerConfig(OptimizerType.LBFGS, max_iter=max_iter, tolerance=1e-9),
        regularization=RegularizationContext(RegularizationType.L2),
    )


def test_converged_member_is_bit_stable():
    """The reference's TestFreezeSemantics set-up on the port: member 0
    (heavy regularization) converges in a few trips, member 1 keeps the
    loop running. Runs whose only difference is how long member 1 runs
    agree BITWISE on member 0."""
    _, batch = _batches(5, "scatter")
    grid = [1000.0, 1e-6]
    _, short = _freeze_problem(10).run_grid(batch, grid)
    _, long = _freeze_problem(60).run_grid(batch, grid)
    it0 = short.iterations[0]
    assert it0 < 10 and long.iterations[1] > it0
    assert long.iterations[0] == it0 and long.reason[0] == short.reason[0]
    assert torch.equal(short.coefficients[0], long.coefficients[0])
    assert torch.equal(short.value[0], long.value[0])
    assert torch.equal(short.grad_norm[0], long.grad_norm[0])
    assert short.tracker.count[0] == long.tracker.count[0] == it0 + 1
    assert torch.equal(
        short.tracker.values[0, : it0 + 1], long.tracker.values[0, : it0 + 1]
    )


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_fetches_do_not_grow_with_the_grid(opt):
    """A grid of 4 copies of one λ makes exactly as many host fetches as
    a grid of that λ alone and as the sequential fit of it; its members
    are the single fit's, bit for bit (each bank row is computed alone)."""
    _, batch = _batches(6, "scatter")
    problem = create_glm_problem(
        TaskType.LOGISTIC_REGRESSION, D,
        config=OptimizerConfig(OptimizerType(opt), max_iter=30, tolerance=TOL),
        regularization=RegularizationContext(RegularizationType.L2),
    )
    counts = []
    for grid in ([1.0], [1.0] * 4):
        common.host_fetches = 0
        _, result = problem.run_grid(batch, grid)
        counts.append(common.host_fetches)
        if len(grid) == 1:
            one = result
    common.host_fetches = 0
    _, seq = problem.run(batch, reg_weight=1.0)
    counts.append(common.host_fetches)
    assert counts[0] == counts[1] == counts[2] > 0
    for g in range(4):
        assert torch.equal(result.coefficients[g], one.coefficients[0])
    assert result.iterations == one.iterations * 4 == [seq.iterations] * 4


def test_grid_result_scalars_is_one_fetch():
    _, batch = _batches(7, "scatter")
    _, results = training.train_grid_batched(
        batch, TaskType.LOGISTIC_REGRESSION, D,
        regularization_type=RegularizationType.L2,
        regularization_weights=LAMBDAS, tolerance=TOL, device="cpu",
    )
    common.host_fetches = 0
    scalars = training.grid_result_scalars(results)
    assert common.host_fetches == 1
    assert set(scalars) == set(LAMBDAS)
    for lam, (iters, value, reason) in scalars.items():
        assert iters == results[lam].iterations >= 1
        assert value == float(results[lam].value) and np.isfinite(value)
        assert reason == results[lam].reason != common.NOT_CONVERGED


def test_no_bank_pass_goes_through_k1(monkeypatch):
    """Every data pass of a bank goes to K2: K1's wrapper is never called
    during a tiled grid fit (TRON: value, gradient, Hv; variances: Hdiag)."""
    _, tb = _batches(8, "tiled")

    def no_k1(*args, **kwargs):
        raise AssertionError("K1 called on the bank path")

    monkeypatch.setattr(ts, "bilinear_pass", no_k1)
    calls = []
    real_k2 = ts.grid_bilinear_pass

    def counted_k2(*args, **kwargs):
        calls.append(1)
        return real_k2(*args, **kwargs)

    monkeypatch.setattr(ts, "grid_bilinear_pass", counted_k2)
    models, _ = training.train_grid_batched(
        tb, TaskType.LOGISTIC_REGRESSION, D,
        optimizer_type=OptimizerType.TRON,
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0, 0.1], max_iter=2, compute_variances=True,
        kernel="tiled", device="cpu",
    )
    assert calls and all(
        m.coefficients.variances is not None for m in models.values()
    )


RGM_TABLE = [
    dict(mode="sequential", num_weights=4, dim=1000),
    dict(mode="batched", num_weights=4, dim=1000),
    dict(mode="auto", num_weights=4, dim=1000),
    dict(mode="auto", num_weights=1, dim=1000),
    dict(mode="auto", num_weights=4, dim=1 << 20, memory_budget_bytes=1 << 20),
    dict(mode="auto", num_weights=9, dim=1 << 20),
    dict(mode="auto", num_weights=10, dim=1 << 20),
    dict(mode="auto", num_weights=30, dim=1 << 20, optimizer_type="TRON"),
    dict(mode="auto", num_weights=4, dim=1 << 20, history=40),
    dict(mode="auto", num_weights=4, dim=1000, streaming=True),
    dict(mode="batched", num_weights=4, dim=1000, streaming=True),
    dict(mode="eager", num_weights=4, dim=1000),
]


def _call(fn, optimizer_enum, **kw):
    if "optimizer_type" in kw:
        kw["optimizer_type"] = optimizer_enum(kw["optimizer_type"])
    try:
        return fn(kw.pop("mode"), **kw)
    except ValueError as e:
        return ("ValueError", str(e).split(";")[0].split(":")[0])


@pytest.mark.parametrize("case", range(len(RGM_TABLE)))
def test_resolve_grid_mode_matches_reference(case):
    kw = RGM_TABLE[case]
    expected = _call(ref_training.resolve_grid_mode, ref_config.OptimizerType, **kw)
    got = _call(training.resolve_grid_mode, OptimizerType, **kw)
    assert got == expected


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
@pytest.mark.parametrize("G,dim,history", [(1, 10, 10), (4, 1 << 20, 10), (9, 1000, 3)])
def test_grid_bank_bytes_matches_reference(opt, G, dim, history):
    assert training.grid_bank_bytes(
        G, dim, OptimizerType(opt), history
    ) == ref_training.grid_bank_bytes(G, dim, ref_config.OptimizerType(opt), history)
    assert training.DEFAULT_GRID_MEMORY_BUDGET == ref_training.DEFAULT_GRID_MEMORY_BUDGET
