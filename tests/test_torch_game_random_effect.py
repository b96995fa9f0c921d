"""The port's random-effect solves (``game/random_effect.py``) against the
JAX package's on the same buckets: every solver kind (sparse L-BFGS,
dense, dual-space Newton, their ``_id`` forms, OWL-QN with L1, TRON), the
variances, the scores and the densification.

Tolerances: float32 bank rows within 1e-4 of the bank's max-abs (the two
packages sum in other orders); in float64 (the reference under
``jax_enable_x64``) the same per-entity iterations and stop reasons and
rows within 1e-9; variances within 1e-5 relative; scores within 1e-6 of
their max-abs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game import RandomEffectOptimizationProblem as RefProblem
from photon_ml_tpu.game import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.game import score_random_effect as ref_score
from photon_ml_tpu.game.random_effect import _bucket_solver
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import OptimizerType as RefOptType
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu_torch.game import (
    RandomEffectDataConfiguration,
    RandomEffectOptimizationProblem,
    build_random_effect_dataset,
    score_random_effect,
)
from photon_ml_tpu_torch.game.random_effect import densify, densify_compare
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from torch_game_cases import both_datasets, make_records
from torch_parity import assert_close, assert_close_to_scale

# (layout, optimizer, regularization, alpha, kind the layout resolves to)
CASES = {
    "sparse_lbfgs": ("sparse", "LBFGS", "L2", None, "sparse"),
    "sparse_owlqn_l1": ("sparse", "LBFGS", "L1", None, "sparse"),
    "sparse_tron": ("sparse", "TRON", "L2", None, "sparse"),
    "dense_owlqn_elastic": ("dense", "LBFGS", "ELASTIC_NET", 0.5, "dense"),
    "dense_tron": ("dense", "TRON", "L2", None, "dense"),
    "newton": ("dense", "LBFGS", "L2", None, "newton"),
}


def _problems(case, max_iter=60, tol=1e-6):
    layout, opt, reg, alpha, _ = CASES[case]
    ref = RefProblem(
        REF_LOGISTIC, RefOptConfig(RefOptType(opt), max_iter=max_iter, tolerance=tol),
        RefReg(RefRegType(reg), alpha), reg_weight=1.0, layout=layout,
    )
    port = RandomEffectOptimizationProblem(
        LOGISTIC, OptimizerConfig(OptimizerType(opt), max_iter=max_iter, tolerance=tol),
        RegularizationContext(RegularizationType(reg), alpha), reg_weight=1.0, layout=layout,
    )
    return ref, port


def _re_datasets(seed=5, n=240, n_users=9, **kw):
    ref_ds, port_ds = both_datasets(make_records(seed, n=n, n_users=n_users, dup_every=7))
    ref = ref_build_re(ref_ds, RefREConfig("userId", "userShard", **kw))
    port = build_random_effect_dataset(port_ds, RandomEffectDataConfiguration("userId", "userShard", **kw))
    return ref_ds, port_ds, ref, port


def _identity_view(red):
    """The dataset with every bucket as an ``identity_indices`` bucket
    (indices the tiled arange, values the dense rows: the MF latent
    view's layout), from the same numpy arrays for both packages."""
    D = red.local_dim
    buckets = []
    for b in red.buckets:
        E, S, _ = b.indices.shape
        X = np.zeros((E, S, D), np.float32)
        np.add.at(X, (np.arange(E)[:, None, None], np.arange(S)[None, :, None], b.indices), b.values)
        buckets.append(dataclasses.replace(
            b, indices=np.broadcast_to(np.arange(D, dtype=np.int32), (E, S, D)).copy(),
            values=X, identity_indices=True,
        ))
    return dataclasses.replace(red, buckets=buckets)


# every kind, and the _id form of each dense kind
BANK_CASES = [(c, False) for c in sorted(CASES)] + [
    (c, True) for c in sorted(CASES) if CASES[c][0] == "dense"
]


def _entity_objectives64(bank, red, l1, l2):
    """Each entity's objective at its bank row, in float64 from its
    definition (weighted logistic loss over its active rows + l1|c| +
    l2/2 c^2)."""
    bank = np.asarray(bank, np.float64)
    out = np.zeros(red.num_entities)
    for b in red.buckets:
        c = bank[b.entity_codes]
        z = (b.values * np.take_along_axis(
            c[:, None, :].repeat(b.indices.shape[1], 1), b.indices, axis=2)).sum(-1) + b.offsets
        loss = np.logaddexp(0.0, z) - b.labels * z
        out[b.entity_codes] = (b.weights * loss).sum(-1) + l1 * np.abs(c).sum(-1) + 0.5 * l2 * (c * c).sum(-1)
    return out


# Rows within 1e-4 of the max-abs where the stop test reads the gradient
# (L-BFGS, Newton). TRON and OWL-QN can stop on the function change, and in
# float32 a change below the objective's rounding (1e-6 relative) leaves the
# row undetermined by ~sqrt(2e-6 / l2) = 1.4e-3 along a flat direction: their
# rows are held to 5e-4 of the max-abs and each entity's float64 objective
# to 1e-6 relative (the float64 test holds all kinds to 1e-9 with the same
# iterations).
ROW_RTOL = {"sparse_lbfgs": 1e-4, "newton": 1e-4}


@pytest.mark.parametrize("case,identity", BANK_CASES)
def test_update_bank_matches_reference_f32(case, identity):
    _, _, ref_red, port_red = _re_datasets()
    if identity:
        ref_red, port_red = _identity_view(ref_red), _identity_view(port_red)
    # a stop test at f32 rounding: both packages run to the optimum, so the
    # rows compare the optima rather than where each stop test tripped
    ref_p, port_p = _problems(case, max_iter=100, tol=1e-9)
    want_kind = CASES[case][4] + ("_id" if identity else "")
    for b in port_red.buckets:
        assert port_p._bucket_kind(b, port_red.local_dim) == want_kind
        assert ref_p._bucket_kind(b, ref_red.local_dim) == want_kind
    E, D = ref_red.num_entities, ref_red.local_dim
    ref_bank, ref_tr = ref_p.update_bank(jnp.zeros((E, D), jnp.float32), ref_red)
    port_bank, port_tr = port_p.update_bank(torch.zeros(E, D), port_red)
    assert_close_to_scale(port_bank, np.asarray(ref_bank), rtol=ROW_RTOL.get(case, 5e-4))
    l1, l2 = port_p.regularization.split(port_p.reg_weight)
    assert_close(
        _entity_objectives64(port_bank.numpy(), port_red, l1, l2),
        _entity_objectives64(np.asarray(ref_bank), ref_red, l1, l2), rtol=1e-6,
    )
    assert port_tr.num_entities == ref_tr.num_entities == E
    assert sum(port_tr.reason_counts.values()) == E


def test_residual_offsets_and_deferred_tracker():
    """Offsets from a residual vector, gathered per bucket on the device,
    and a tracker whose one fetch waits for its first read."""
    ref_ds, port_ds, ref_red, port_red = _re_datasets()
    ref_p, port_p = _problems("newton")
    resid = np.random.default_rng(0).normal(size=ref_ds.num_rows).astype(np.float32) * 0.3
    E, D = ref_red.num_entities, ref_red.local_dim
    ref_bank, ref_tr = ref_p.update_bank(jnp.zeros((E, D)), ref_red, residual_offsets=jnp.asarray(resid))
    common.host_fetches = 0
    port_bank, port_tr = port_p.update_bank(
        torch.zeros(E, D), port_red, residual_offsets=torch.as_tensor(resid), defer_tracker=True,
    )
    before = common.host_fetches
    assert port_tr.iterations_max == ref_tr.iterations_max
    assert common.host_fetches == before + 1  # the tracker's one fetch
    assert_close_to_scale(port_bank, np.asarray(ref_bank), rtol=1e-4)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solvers_take_the_same_iterations_in_f64(case, x64):
    """Per bucket, the reference's solver program and the port's solve:
    identical iterations and reasons per entity, rows within 1e-9."""
    _, _, ref_red, port_red = _re_datasets(seed=6)
    ref_p, port_p = _problems(case, max_iter=40, tol=1e-7)
    kind = CASES[case][4]
    layout, opt, reg, alpha, _ = CASES[case]
    solvers = _bucket_solver(
        REF_LOGISTIC, RefOptConfig(RefOptType(opt), max_iter=40, tolerance=1e-7),
        RefReg(RefRegType(reg), alpha),
    )
    l1, l2 = port_p.regularization.split(1.0)
    D = ref_red.local_dim
    for rb, pb in zip(ref_red.buckets, port_red.buckets):
        E = rb.num_entities
        ref_c, ref_it, ref_rs = getattr(solvers, kind)(
            jnp.zeros((E, D), jnp.float64), jnp.asarray(rb.indices), jnp.asarray(rb.values, jnp.float64),
            jnp.asarray(rb.labels, jnp.float64), jnp.asarray(rb.offsets, jnp.float64),
            jnp.asarray(rb.weights, jnp.float64), jnp.float64(l1), jnp.float64(l2),
        )
        bank = torch.zeros(E, D, dtype=torch.float64)
        ix, v, lab, off, w, _ = port_p._bucket_inputs(pb, bank, None)
        c, it, rs = port_p._solve(kind, bank, ix, v, lab, off, w, l1, l2)
        np.testing.assert_array_equal(np.asarray(it).reshape(-1), np.asarray(ref_it))
        np.testing.assert_array_equal(np.asarray(rs).reshape(-1), np.asarray(ref_rs))
        assert_close(c, np.asarray(ref_c), rtol=0, atol=1e-9)


def test_bank_variances_and_with_variances():
    ref_ds, port_ds, ref_red, port_red = _re_datasets()
    ref_p, port_p = _problems("sparse_lbfgs")
    E, D = ref_red.num_entities, ref_red.local_dim
    bank = np.random.default_rng(1).normal(size=(E, D)).astype(np.float32) * 0.2
    ref_v = np.asarray(ref_p.bank_variances(jnp.asarray(bank), ref_red))
    port_v = port_p.bank_variances(torch.as_tensor(bank), port_red)
    assert_close(port_v, ref_v, rtol=1e-5)
    ref_bank, _, ref_var = ref_p.update_bank(jnp.zeros((E, D)), ref_red, with_variances=True)
    port_bank, _, port_var = port_p.update_bank(torch.zeros(E, D), port_red, with_variances=True)
    # variances at each package's own solution; the solutions agree to 1e-4
    assert_close(port_var, np.asarray(ref_var), rtol=1e-3)
    assert_close(port_var, port_p.bank_variances(port_bank, port_red), rtol=1e-5)


@pytest.mark.parametrize("cap", [None, 6])
def test_score_random_effect(cap):
    """Active and passive rows, scored by the [n, k] gather."""
    _, _, ref_red, port_red = _re_datasets(active_data_upper_bound=cap)
    bank = np.random.default_rng(2).normal(size=(ref_red.num_entities, ref_red.local_dim))
    bank = bank.astype(np.float32)
    ref_s = np.asarray(ref_score(jnp.asarray(bank), ref_red))
    port_s = score_random_effect(torch.as_tensor(bank), port_red)
    assert_close_to_scale(port_s, ref_s, rtol=1e-6)
    assert np.count_nonzero(port_s.numpy()[: ref_red.row_entity_codes.shape[0]]) > 0


def _compare_and_reduce(ix, v, D):
    """The reference's ``_densify`` formula in numpy."""
    return (v[..., None] * (ix[..., None] == np.arange(D))).sum(axis=2, dtype=np.float32)


def test_densify_by_scatter():
    """Bitwise equal to the compare-and-reduce on rows without a duplicate
    index, within 1e-6 relative on rows with one; padding adds zero."""
    _, _, _, port_red = _re_datasets()
    D = port_red.local_dim
    dup_rows = 0
    for b in port_red.buckets:
        ix = torch.as_tensor(b.indices).long()
        v = torch.as_tensor(b.values)
        got = densify(ix, v, D)
        plain = densify_compare(ix, v, D, chunk=3)
        oracle = _compare_and_reduce(b.indices, b.values, D)
        live = b.values != 0
        srt = np.sort(np.where(live, b.indices, -1 - np.arange(b.indices.shape[-1])), axis=-1)
        dup = (srt[..., 1:] == srt[..., :-1]).any(axis=-1)  # [E, S]
        dup_rows += int(dup.sum())
        g, p = got.numpy(), plain.numpy()
        np.testing.assert_array_equal(g[~dup], p[~dup])
        np.testing.assert_array_equal(g[~dup], oracle[~dup])
        np.testing.assert_allclose(g[dup], p[dup], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g[dup], oracle[dup], rtol=1e-6, atol=1e-7)
    assert dup_rows > 0  # the fixture has rows with a duplicate index


def test_dense_budget_sees_the_itemsize():
    _, _, _, port_red = _re_datasets()
    b = port_red.buckets[0]
    E, S, _ = b.indices.shape
    need = (E * S * port_red.local_dim + E * S * S) * 4
    fits = RandomEffectOptimizationProblem(
        LOGISTIC, OptimizerConfig(), RegularizationContext(RegularizationType.L2),
        reg_weight=1.0, dense_bytes_budget=need,
    )
    tight = dataclasses.replace(fits, dense_bytes_budget=need - 1)
    assert fits._bucket_kind(b, port_red.local_dim) == "newton"
    assert tight._bucket_kind(b, port_red.local_dim) == "sparse"


def test_mesh_waits_for_its_item():
    """The mesh path is ported (tests/test_torch_residual_routing.py): a
    ProcessMesh is taken, anything else is refused."""
    from photon_ml_tpu_torch.parallel.mesh import entity_mesh

    with pytest.raises(TypeError, match="ProcessMesh"):
        RandomEffectOptimizationProblem(
            LOGISTIC, OptimizerConfig(), RegularizationContext(), mesh=object()
        )
    mesh = entity_mesh(1, device="cpu")
    assert RandomEffectOptimizationProblem(
        LOGISTIC, OptimizerConfig(), RegularizationContext(), mesh=mesh
    ).mesh is mesh
