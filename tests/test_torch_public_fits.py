"""The reference's public fit entry points in the port
(``parallel/distributed.py``) on gloo CPU ranks, against the same-named
functions of the JAX package on its virtual CPU devices, on the same
inputs made with numpy from a seed:

- the sparse layout's ``feature_sharded_sparse_fit`` / ``_fit_tron`` /
  ``_fit_owlqn`` / ``_value_and_grad`` / ``_hessian_vector`` on 1 x 2 and
  2 x 2 (data, model) meshes;
- the tiled ``feature_sharded_tiled_fit`` and ``_tron`` on the reference's
  own cells (K1's plain version), the reference in interpret mode;
- the dense ``feature_sharded_value_and_grad`` and ``feature_sharded_fit``;
- ``data_parallel_value_and_grad`` and ``data_parallel_fit_lbfgs`` on a
  2 x 1 data mesh.

Each thin function is bitwise ``feature_sharded_glm_fit`` on the same cell
(and ``data_parallel_fit_lbfgs`` bitwise ``GLMOptimizationProblem.run`` on
the mesh), every rank returns the same bits, and a dense fit repeats
bitwise. Tolerances: fits stop at 1e-6 (TRON at 1e-4); float32 the same
stop reasons, values within rtol 1e-5 and coefficients within 1e-5 of
scale; one evaluation (value, gradient, Hv) within 1e-5 of scale; float64
(dense and data-parallel, the binding check) the same iterations and stop
reasons and coefficients within 1e-9 of scale. Rank functions live in
``tests/torch_surface_cases.py`` (no JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops.objective import GLMObjective as RefObjective
from photon_ml_tpu.parallel import distributed as ref_dist
from photon_ml_tpu.parallel.mesh import make_mesh as ref_make_mesh
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
from tests.torch_mesh_cases import D, planted_problem
from tests.torch_parity import assert_close_to_scale
from tests.torch_surface_cases import (
    data_parallel_rank,
    dense_entry_rank,
    sparse_entry_rank,
    tiled_entry_rank,
)

AXES = (DATA_AXIS, MODEL_AXIS)
# TRON stops on the function change: at 1e-6 a float32 fit may stop an
# iteration before or after the reference's, so it stops at 1e-4 (as in
# test_torch_feature_sharded.py)
L2, L1, TOL, TRON_TOL = 0.5, 0.1, 1e-6, 1e-4
TIMEOUT_S = 240.0
OBJ = RefObjective(ref_losses.LOGISTIC, D)


def _ref_mesh(shape, axes=AXES):
    return ref_make_mesh(shape, axes, devices=jax.devices()[: int(np.prod(shape))])


def _ref_result(res):
    return dict(coefficients=np.asarray(res.coefficients), value=float(res.value),
                iterations=int(res.iterations), reason=int(res.reason))


def _hold(got, want, *, coef_rtol, value_rtol):
    assert got["iterations"] > 0 and want["iterations"] > 0
    np.testing.assert_allclose(got["value"], want["value"], rtol=value_rtol)
    assert_close_to_scale(got["coefficients"], want["coefficients"], rtol=coef_rtol)


def _ranks_agree(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key]["coefficients"], ranks[0][key]["coefficients"])
        assert r[key]["iterations"] == ranks[0][key]["iterations"]


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=["1x2", "2x2"])
def sparse_runs(request):
    shape = request.param
    rows, labels, weights = planted_problem()
    ranks = spawn_mesh(sparse_entry_rank, shape, AXES, device="cpu", timeout_s=TIMEOUT_S,
                       args=(rows, labels, weights, D, L2, L1, TOL, TRON_TOL))
    mesh = _ref_mesh(shape)
    sharded, block_dim = ref_dist.feature_shard_sparse_batch(
        ref_make_sparse(rows, labels, weights=weights), D, shape[1], rows_multiple=shape[0])
    d_pad = shape[1] * block_dim
    w0 = jnp.zeros(d_pad)
    l1_mask = jnp.ones(d_pad).at[D - 1].set(0.0)
    ref = {
        "lbfgs": ref_dist.feature_sharded_sparse_fit(OBJ, mesh, tol=TOL)(w0, sharded, L2),
        "tron": ref_dist.feature_sharded_sparse_fit_tron(OBJ, mesh, tol=TRON_TOL)(
            w0, sharded, L2),
        "owlqn": ref_dist.feature_sharded_sparse_fit_owlqn(OBJ, mesh, tol=TOL)(
            w0, sharded, L2, L1, l1_mask),
    }
    ref = {k: _ref_result(v) for k, v in ref.items()}
    vg = ranks[0]["vg"]
    w, d = jnp.asarray(vg["w"]), jnp.asarray(vg["d"])
    value, grad = ref_dist.feature_sharded_sparse_value_and_grad(OBJ, mesh)(w, sharded, L2)
    hv = ref_dist.feature_sharded_sparse_hessian_vector(OBJ, mesh)(w, d, sharded, L2)
    ref["vg"] = dict(value=float(value), grad=np.asarray(grad), hv=np.asarray(hv))
    return ranks, ref


@pytest.mark.parametrize("name", ["lbfgs", "tron", "owlqn"])
def test_sparse_fits_match_reference(sparse_runs, name):
    ranks, ref = sparse_runs
    _ranks_agree(ranks, name)
    for r in ranks:
        assert r[name]["same_as_general"]
    assert ranks[0][name]["reason"] == ref[name]["reason"]
    _hold(ranks[0][name], ref[name], coef_rtol=1e-5, value_rtol=1e-5)


def test_sparse_value_grad_and_hv_match_reference(sparse_runs):
    ranks, ref = sparse_runs
    for r in ranks:
        np.testing.assert_allclose(r["vg"]["value"], ref["vg"]["value"], rtol=1e-5)
        assert_close_to_scale(r["vg"]["grad"], ref["vg"]["grad"], rtol=1e-5)
        assert_close_to_scale(r["vg"]["hv"], ref["vg"]["hv"], rtol=1e-5)
        np.testing.assert_array_equal(r["vg"]["grad"], ranks[0]["vg"]["grad"])


def _ref_tiled_layout(shape):
    from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
    from photon_ml_tpu.ops.tiled_sparse import feature_shard_tiled_batch as ref_fstb

    rows, labels, weights = planted_problem()
    mesh = _ref_mesh(shape)
    sharded, _ = ref_fstb(
        ref_make_sparse(rows, labels, weights=weights), D, *shape,
        params=RefTileParams(s_hi=4, s_lo=8, chunk=16, spill_cap=8), mesh=mesh,
    )
    layout = (
        dataclasses.asdict(sharded.meta), [np.asarray(a) for a in sharded.z_sched],
        [np.asarray(a) for a in sharded.g_sched], np.asarray(sharded.labels),
        np.asarray(sharded.offsets), np.asarray(sharded.weights),
    )
    return mesh, sharded, layout


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tiled_fits_match_reference(shape):
    mesh, sharded, layout = _ref_tiled_layout(shape)
    ranks = spawn_mesh(tiled_entry_rank, shape, AXES, device="cpu", timeout_s=TIMEOUT_S,
                       args=(layout, D, L2, TOL, TRON_TOL))
    w0 = jnp.zeros(shape[1] * sharded.meta.block_dim)
    ref = {
        "lbfgs": ref_dist.feature_sharded_tiled_fit(
            OBJ, mesh, sharded.meta, tol=TOL, interpret=True)(w0, sharded, L2),
        "tron": ref_dist.feature_sharded_tiled_fit_tron(
            OBJ, mesh, sharded.meta, tol=TRON_TOL, interpret=True)(w0, sharded, L2),
    }
    for name, res in ref.items():
        want = _ref_result(res)
        _ranks_agree(ranks, name)
        for r in ranks:
            assert r[name]["same_as_general"]
        assert ranks[0][name]["reason"] == want["reason"]
        _hold(ranks[0][name], want, coef_rtol=1e-5, value_rtol=1e-5)
    for r in ranks:
        assert r["refused"] == "the cell's layout is not the one the fit was built for"


def _dense_arrays(dtype, n=60, d=12, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ w_true))).astype(float)
    return [a.astype(dtype) for a in (x, y, rng.normal(size=n) * 0.1, rng.uniform(0.5, 2, n))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_dense_feature_sharded_matches_reference(shape, dtype):
    """The dense layout: the rows padded to the data axis, the features
    split over the model axis; float64 the same iterations as the
    reference's and coefficients within 1e-9 of scale."""
    x, y, off, wt = _dense_arrays(dtype)
    tol, max_iter = (1e-9, 100) if dtype == "float64" else (TOL, 50)
    ranks = spawn_mesh(dense_entry_rank, shape, AXES, device="cpu", timeout_s=TIMEOUT_S,
                       args=(x, y, off, wt, L2, tol, max_iter))
    mesh = _ref_mesh(shape)
    with jax.enable_x64(dtype == "float64"):
        obj = RefObjective(ref_losses.LOGISTIC, x.shape[1])
        w = jnp.asarray(np.linspace(-0.2, 0.2, x.shape[1]), dtype)
        arrs = [jnp.asarray(a) for a in (x, y, off, wt)]
        l2 = np.dtype(dtype).type(L2)
        value, grad = ref_dist.feature_sharded_value_and_grad(obj, mesh)(w, *arrs, l2)
        res = ref_dist.feature_sharded_fit(obj, mesh, tol=tol, max_iter=max_iter)(
            jnp.zeros_like(w), *arrs, l2)
        want = _ref_result(res)
        value, grad = float(value), np.asarray(grad)
    rtol = 1e-9 if dtype == "float64" else 1e-5
    _ranks_agree(ranks, "fit")
    for r in ranks:
        assert r["repeat"]
        np.testing.assert_allclose(r["value"], value, rtol=rtol)
        assert_close_to_scale(r["grad"], grad, rtol=rtol)
    got = ranks[0]["fit"]
    assert got["reason"] == want["reason"]
    if dtype == "float64":
        assert got["iterations"] == want["iterations"]
        _hold(got, want, coef_rtol=1e-9, value_rtol=1e-12)
    else:
        _hold(got, want, coef_rtol=1e-5, value_rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_data_parallel_matches_reference(dtype):
    rows, labels, weights = planted_problem()
    tol = 1e-9 if dtype == "float64" else TOL
    mesh = _ref_mesh((2,), (DATA_AXIS,))
    with jax.enable_x64(dtype == "float64"):
        batch = ref_make_sparse(rows, labels, weights=weights, dtype=np.dtype(dtype))
        arrays = [np.asarray(a) for a in batch]
        w = jnp.asarray(np.linspace(-0.3, 0.3, D), dtype)
        l2 = np.dtype(dtype).type(L2)
        value, grad = ref_dist.data_parallel_value_and_grad(OBJ, mesh)(w, batch, l2)
        want = _ref_result(ref_dist.data_parallel_fit_lbfgs(OBJ, mesh, tol=tol)(
            jnp.zeros_like(w), batch, l2))
        value, grad = float(value), np.asarray(grad)
    ranks = spawn_mesh(data_parallel_rank, (2,), (DATA_AXIS,), device="cpu",
                       timeout_s=TIMEOUT_S, args=(arrays, D, L2, tol))
    rtol = 1e-9 if dtype == "float64" else 1e-5
    _ranks_agree(ranks, "fit")
    for r in ranks:
        np.testing.assert_allclose(r["value"], value, rtol=rtol)
        assert_close_to_scale(r["grad"], grad, rtol=rtol)
    got = ranks[0]["fit"]
    assert got["reason"] == want["reason"]
    if dtype == "float64":
        assert got["iterations"] == want["iterations"]
        _hold(got, want, coef_rtol=1e-9, value_rtol=1e-12)
    else:
        _hold(got, want, coef_rtol=1e-5, value_rtol=1e-5)
        for r in ranks:
            assert r["same_as_problem"]
        _ranks_agree(ranks, "tiled")
        _hold(ranks[0]["tiled"], want, coef_rtol=1e-5, value_rtol=1e-5)
