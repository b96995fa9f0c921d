"""OWL-QN (L1 and elastic net) in the PyTorch port against the reference's
``minimize_owlqn`` and ``train_generalized_linear_model``: the optimizer on
the same scatter objective, with the intercept exempt from the penalty and
with a box, and the whole sequential trainer for L1 and elastic net.

Both sides run f32. The convergence tolerance is 1e-5 (not the default
1e-7, whose function-change test at |f| ~ 100 compares differences of one
f32 ulp and so flips on rounding): the same iteration count and stop
reason, values within rtol 1e-5 and coefficients within 1e-4 of their
largest magnitude (the two sum in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops.objective import GLMObjective as RefGLMObjective
from photon_ml_tpu.optim import config as ref_config
from photon_ml_tpu.optim.common import BoxConstraints as RefBox
from photon_ml_tpu.optim.lbfgs import minimize_owlqn as ref_minimize_owlqn
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu.training import train_generalized_linear_model as ref_train
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.factory import make_optimizer
from photon_ml_tpu_torch.optim.lbfgs import minimize_owlqn
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model
from tests.torch_parity import (
    assert_close,
    assert_close_to_scale,
    both_batches,
    random_rows,
)

D = 120
TOL = 1e-5


def _data(seed=31, n=200):
    rng = np.random.default_rng(seed)
    rows, labels = random_rows(rng, n=n, d=D)
    return both_batches(rows, labels, rng.uniform(0.5, 2.0, n))


def _mask():
    mask = np.ones(D, np.float32)
    mask[D - 1] = 0.0  # the intercept
    return mask


@pytest.mark.parametrize("boxed", [False, True])
@pytest.mark.parametrize("l1", [0.5, 4.0])
def test_owlqn_matches_reference(l1, boxed):
    ref_batch, batch = _data()
    ref_obj = RefGLMObjective(ref_losses.LOGISTIC, D)
    obj = GLMObjective(losses.LOGISTIC, D)
    l2 = 0.25
    kw = dict(max_iter=30, tol=TOL)
    ref_box = box = None
    if boxed:
        ref_box = RefBox(jnp.full(D, -0.2), jnp.full(D, 0.2))
        box = common.BoxConstraints(torch.full((D,), -0.2), torch.full((D,), 0.2))
    ref = jax.jit(lambda w: ref_minimize_owlqn(
        lambda v: ref_obj.value_and_gradient(v, ref_batch, l2), w, l1,
        l1_mask=jnp.asarray(_mask()), box=ref_box, **kw,
    ))(jnp.zeros(D))
    got = minimize_owlqn(
        lambda v: obj.value_and_gradient(v, batch, l2), torch.zeros(D), l1,
        l1_mask=torch.as_tensor(_mask()), box=box, **kw,
    )
    assert got.iterations == int(ref.iterations)
    assert got.reason == int(ref.reason)
    assert got.tracker.count == int(ref.tracker.count)
    assert_close(got.value, ref.value, rtol=1e-5)
    assert_close(got.grad_norm, ref.grad_norm, rtol=1e-3, atol=1e-4)
    assert_close_to_scale(got.coefficients, ref.coefficients, rtol=1e-4)
    # the same exact zeros: the orthant projection lands on 0.0 exactly
    ref_zero = np.asarray(ref.coefficients) == 0.0
    assert ref_zero.sum() > 0
    assert np.array_equal(got.coefficients.numpy() == 0.0, ref_zero)
    assert float(got.coefficients[D - 1]) != 0.0  # the intercept is exempt


@pytest.mark.parametrize("reg", ["L1", "ELASTIC_NET"])
def test_sequential_trainer_matches_reference(reg):
    ref_batch, batch = _data(seed=32)
    alpha = 0.5 if reg == "ELASTIC_NET" else None
    kw = dict(
        regularization_weights=[4.0, 1.0], elastic_net_alpha=alpha,
        intercept_index=D - 1, max_iter=25, tolerance=TOL,
    )
    ref_models, ref_results = ref_train(
        ref_batch, RefTaskType.LOGISTIC_REGRESSION, D,
        regularization_type=ref_config.RegularizationType(reg), **kw,
    )
    models, results = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, D,
        regularization_type=RegularizationType(reg), device="cpu", **kw,
    )
    assert list(models) == list(ref_models)
    for lam in ref_models:
        r, ref_r = results[lam], ref_results[lam]
        assert r.iterations == int(ref_r.iterations), lam
        assert r.reason == int(ref_r.reason), lam
        assert_close(r.value, ref_r.value, rtol=1e-5)
        assert_close_to_scale(
            models[lam].coefficients.means, ref_models[lam].coefficients.means,
            rtol=1e-4,
        )
        means = models[lam].coefficients.means
        assert int((means == 0.0).sum()) > 0 and float(means[D - 1]) != 0.0


def test_factory_routes_l1_to_owlqn_and_rejects_tron():
    """(LBFGS, L1) runs OWL-QN: the same result as calling it directly;
    TRON with any L1 is refused (OptimizerFactory.scala:49-86)."""
    _, batch = _data(seed=33)
    obj = GLMObjective(losses.LOGISTIC, D)

    def vg(w):
        return obj.value_and_gradient(w, batch, 0.0)

    optimize = make_optimizer(
        OptimizerConfig(max_iter=10, tolerance=TOL),
        RegularizationContext(RegularizationType.L1),
    )
    got = optimize(vg, torch.zeros(D), l1_weight=2.0)
    direct = minimize_owlqn(vg, torch.zeros(D), 2.0, max_iter=10, tol=TOL)
    assert torch.equal(got.coefficients, direct.coefficients)
    with pytest.raises(ValueError, match="TRON"):
        make_optimizer(
            OptimizerConfig(OptimizerType.TRON),
            RegularizationContext(RegularizationType.ELASTIC_NET, 0.5),
        )


def test_pseudo_gradient_matches_reference():
    """Andrew & Gao's pseudo-gradient on every sign case (bitwise: the
    same elementwise f32 arithmetic)."""
    from photon_ml_tpu.optim.lbfgs import _pseudo_gradient as ref_pg
    from photon_ml_tpu_torch.optim.lbfgs import _pseudo_gradient

    w = np.array([1.0, -1.0, 0.0, 0.0, 0.0, 2.0], np.float32)
    g = np.array([0.3, 0.3, -2.0, 2.0, 0.5, -1.0], np.float32)
    l1 = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    expected = np.asarray(ref_pg(jnp.asarray(w), jnp.asarray(g), jnp.asarray(l1)))
    got = _pseudo_gradient(torch.as_tensor(w), torch.as_tensor(g), torch.as_tensor(l1))
    assert np.array_equal(got.numpy(), expected)
