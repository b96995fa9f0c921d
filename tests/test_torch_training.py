"""The PyTorch port's optimizers and its whole training slice against the
JAX package.

Optimizers: the port's L-BFGS and TRON against the reference's on the same
scatter objective (f32 on both sides): same iteration count and stop
reason, coefficients within rtol 1e-4 of their largest magnitude (the
reference's fused XLA reductions sum in another order, and the difference
compounds over iterations).

Slice: ``train_generalized_linear_model(kernel="tiled")`` in both packages
on the same tiled schedule: the port's plain K1 on the CPU against the
reference's Pallas kernel in interpret mode. The reference's training path
builds its tiled objective with the default ``mxu="bf16x2w"`` (~1e-5
relative error per pass) where the port computes in plain f32, so
coefficients and variances are held at rtol 1e-4 of their largest
magnitude (not the 1e-5 of the kernel-level tests, which call
``mxu="highest"``), values at rtol 1e-4 and the AUC at 1e-4 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.evaluation.metrics import area_under_roc_curve as ref_auc
from photon_ml_tpu.models.glm import compute_margins as ref_compute_margins
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops.normalization import NormalizationType as RefNT
from photon_ml_tpu.ops.normalization import (
    build_normalization as ref_build_normalization,
)
from photon_ml_tpu.ops.objective import GLMObjective as RefGLMObjective
from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import (
    tiled_batch_from_sparse as ref_tiled_batch_from_sparse,
)
from photon_ml_tpu.optim import config as ref_config
from photon_ml_tpu.optim.lbfgs import minimize_lbfgs as ref_minimize_lbfgs
from photon_ml_tpu.optim.tron import minimize_tron as ref_minimize_tron
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu.training import (
    train_generalized_linear_model as ref_train,
)
from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
from photon_ml_tpu_torch.models.glm import compute_margins
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationType,
    build_normalization,
)
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.optim.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optim.tron import minimize_tron
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model
from tests.torch_parity import (
    assert_close,
    assert_close_to_scale,
    both_batches,
    port_tiled_batch,
    random_rows,
)

D = 150
L2 = 0.5


def _data(n=300, seed=21):
    rng = np.random.default_rng(seed)
    rows, labels = random_rows(rng, n=n, d=D)
    return both_batches(rows, labels, rng.uniform(0.5, 2.0, n))


# -- optimizers ---------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["lbfgs", "tron"])
def test_optimizer_matches_reference(optimizer):
    ref_batch, batch = _data(n=200)
    ref_obj = RefGLMObjective(ref_losses.LOGISTIC, D)
    obj = GLMObjective(losses.LOGISTIC, D)
    calls = {"vg": 0}

    def vg(w):
        calls["vg"] += 1
        return obj.value_and_gradient(w, batch, L2)

    w0 = torch.zeros(D)
    common.host_fetches = 0
    if optimizer == "lbfgs":
        ref = jax.jit(lambda w: ref_minimize_lbfgs(
            lambda v: ref_obj.value_and_gradient(v, ref_batch, L2), w, max_iter=8,
        ))(jnp.zeros(D))
        got = minimize_lbfgs(vg, w0, max_iter=8)
        # one fetch for the initial gradient test, one per line-search
        # trial (every evaluation after the first), one per iteration
        assert common.host_fetches == 1 + (calls["vg"] - 1) + got.iterations
    else:
        ref = jax.jit(lambda w: ref_minimize_tron(
            lambda v: ref_obj.value_and_gradient(v, ref_batch, L2),
            lambda v, d: ref_obj.hessian_vector(v, d, ref_batch, L2),
            w, max_iter=4,
        ))(jnp.zeros(D))
        got = minimize_tron(
            vg, lambda w, d: obj.hessian_vector(w, d, batch, L2), w0, max_iter=4
        )
    assert got.iterations == int(ref.iterations)
    assert got.reason == int(ref.reason)
    assert got.tracker.count == int(ref.tracker.count)
    assert_close_to_scale(got.coefficients, ref.coefficients, rtol=1e-4)
    assert_close(got.value, ref.value, rtol=1e-5)


def test_lbfgs_stops_on_zero_gradient():
    got = minimize_lbfgs(lambda w: (torch.dot(w, w), 2 * w), torch.zeros(3))
    assert got.reason == common.GRADIENT_WITHIN_TOLERANCE
    assert got.iterations == 0


def test_lbfgs_respects_box():
    box = common.BoxConstraints(torch.full((2,), -0.5), torch.full((2,), 0.5))
    target = torch.tensor([2.0, -3.0])

    def vg(w):
        d = w - target
        return torch.dot(d, d), 2 * d

    got = minimize_lbfgs(vg, torch.zeros(2), box=box, max_iter=50)
    assert got.coefficients.tolist() == [0.5, -0.5]


# -- the slice ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiled_pair():
    ref_batch, batch = _data()
    ref_tb = ref_tiled_batch_from_sparse(
        ref_batch, D, params=RefTileParams(s_hi=8, s_lo=8, chunk=32)
    )
    return ref_batch, batch, ref_tb, port_tiled_batch(ref_tb)


SLICES = {
    "lbfgs_grid": dict(
        optimizer_type="LBFGS", regularization_weights=[0.1, 1.0],
        max_iter=6, compute_variances=True,
    ),
    "tron": dict(
        optimizer_type="TRON", regularization_weights=[1.0], max_iter=3,
        compute_variances=False,
    ),
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_matches_reference(tiled_pair, name):
    ref_batch, batch, ref_tb, tb = tiled_pair
    cfg = dict(SLICES[name])
    opt = cfg.pop("optimizer_type")
    ref_models, ref_results = ref_train(
        ref_tb, RefTaskType.LOGISTIC_REGRESSION, D,
        optimizer_type=ref_config.OptimizerType(opt),
        regularization_type=ref_config.RegularizationType.L2,
        kernel="tiled", **cfg,
    )
    models, results = train_generalized_linear_model(
        tb, TaskType.LOGISTIC_REGRESSION, D,
        optimizer_type=OptimizerType(opt),
        regularization_type=RegularizationType.L2,
        kernel="tiled", device="cpu", **cfg,
    )
    assert list(models) == list(ref_models)  # lambdas, descending
    for lam in ref_models:
        ref_r, r = ref_results[lam], results[lam]
        assert r.reason_name == ref_r.reason_name, lam
        assert r.iterations == int(ref_r.iterations), lam
        assert_close(r.value, ref_r.value, rtol=1e-4)
        means = models[lam].coefficients.means
        assert_close_to_scale(
            means, ref_models[lam].coefficients.means, rtol=1e-4
        )
        if cfg["compute_variances"]:
            assert_close_to_scale(
                models[lam].coefficients.variances,
                ref_models[lam].coefficients.variances, rtol=1e-4,
            )
        auc = area_under_roc_curve(
            compute_margins(means, batch), batch.labels, batch.weights
        )
        ref_a = ref_auc(
            ref_compute_margins(ref_models[lam].coefficients.means, ref_batch),
            ref_batch.labels, ref_batch.weights,
        )
        assert_close(auc, ref_a, rtol=0.0, atol=1e-4)
        assert float(auc) > 0.6  # the fit learned something


def test_scatter_and_tiled_paths_agree(tiled_pair):
    """The port's two objective paths give the same fit (both f32)."""
    _, batch, _, tb = tiled_pair
    common_kw = dict(
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0], max_iter=5, device="cpu",
    )
    m_scatter, _ = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, D, kernel="scatter", **common_kw
    )
    m_tiled, _ = train_generalized_linear_model(
        tb, TaskType.LOGISTIC_REGRESSION, D, kernel="tiled", **common_kw
    )
    assert_close_to_scale(
        m_tiled[1.0].coefficients.means, m_scatter[1.0].coefficients.means,
        rtol=1e-4,
    )


def test_normalized_scatter_fit_matches_reference():
    """Scatter path with STANDARDIZATION and an intercept: the fit runs in
    the normalized space and the model comes back in the original space
    (the intercept absorbs -shift . (factor * w)). Both sides f32; same
    tolerance as the optimizer tests."""
    ref_batch, batch = _data(n=200, seed=5)
    rng = np.random.default_rng(6)
    mean = rng.normal(scale=0.1, size=D).astype(np.float32)
    std = rng.uniform(0.5, 1.5, D).astype(np.float32)
    mx = np.abs(rng.normal(size=D)).astype(np.float32)
    ref_norm = ref_build_normalization(
        RefNT.STANDARDIZATION, mean=mean, std=std, max_magnitude=mx,
        intercept_index=D - 1,
    )
    norm = build_normalization(
        NormalizationType.STANDARDIZATION, mean=torch.as_tensor(mean),
        std=torch.as_tensor(std), max_magnitude=torch.as_tensor(mx),
        intercept_index=D - 1,
    )
    kw = dict(regularization_weights=[1.0], max_iter=6, intercept_index=D - 1)
    ref_models, ref_results = ref_train(
        ref_batch, RefTaskType.LOGISTIC_REGRESSION, D,
        regularization_type=ref_config.RegularizationType.L2,
        normalization=ref_norm, **kw,
    )
    models, results = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, D,
        regularization_type=RegularizationType.L2, normalization=norm,
        device="cpu", **kw,
    )
    assert results[1.0].reason == int(ref_results[1.0].reason)
    assert_close_to_scale(
        models[1.0].coefficients.means, ref_models[1.0].coefficients.means,
        rtol=1e-4,
    )
