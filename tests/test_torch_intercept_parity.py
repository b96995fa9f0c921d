"""Fits with an intercept: the port against the JAX package on the CPU.

On the card two identical fits with an intercept part by up to a few
percent of the coefficients' max-abs (K1's and K2's float atomics sum in
any order on an ill-conditioned path). This file is the second witness.
The fixture: planted-model logistic rows made with numpy from a seed, 2^12
rows x 2^10 features, 16 nonzeros a row, the intercept appended as the
last column the way ``io/input_format.py`` appends it; the λ path [10, 1];
L-BFGS at convergence tolerance 1e-7; the scatter objective in both
packages.

- In float64 (both packages' L-BFGS over their ``GLMObjective`` on a
  float64 copy of the rows; the reference under ``jax.enable_x64``): the
  warm-started path and the batched bank take the same iterations and stop
  for the same reasons in both packages, with coefficients within 1e-9 of
  their max-abs and objectives within 1e-12 relative. So the intercept
  fit is the same fit.
- In float32, through ``train_generalized_linear_model`` and
  ``train_grid_batched``: the same stop reasons, and at each λ the
  objective within 1e-6 relative, both as each optimizer reports it and
  computed in float64 from its definition at each package's final
  coefficients. The coefficients themselves are not held here: at
  tolerance 1e-7 the stop test and the last line searches compare
  differences of one or two f32 ulps of the objective, which the two
  packages round in another summation order, so a fit can stop one
  iteration apart or take another last step along the flat, intercept-led
  direction (on this fixture 2.4e-4 of max-abs at λ = 1 after 23 iterates
  that agree within 4e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops.objective import GLMObjective as RefGLMObjective
from photon_ml_tpu.optim.config import OptimizerType as RefOptimizerType
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.lbfgs import minimize_lbfgs as ref_minimize_lbfgs
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu.training import train_generalized_linear_model as ref_train
from photon_ml_tpu.training import train_grid_batched as ref_train_grid
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.optim.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model, train_grid_batched
from tests.torch_parity import both_batches, to_np

N, D, K = 1 << 12, 1 << 10, 16
DIM = D + 1  # the intercept is column D
LAMBDAS = [10.0, 1.0]
TOL = 1e-7


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(2024)
    w_true = (0.5 * rng.normal(size=D)).astype(np.float32)
    rows, labels = [], []
    for _ in range(N):
        ix = rng.choice(D, size=K, replace=False)
        vs = rng.normal(size=K).astype(np.float32)
        z = float(vs @ w_true[ix]) + 0.3
        labels.append(float(rng.uniform() < 1.0 / (1.0 + np.exp(-z))))
        rows.append((ix.tolist() + [D], vs.tolist() + [1.0]))
    return both_batches(rows, labels)


def objective64(batch, means, lam) -> float:
    """The L2-regularized logistic objective in float64, from its
    definition: sum_i w_i (log(1 + e^z_i) - y_i z_i) + lam/2 |means|^2."""
    w = torch.as_tensor(np.array(means), dtype=torch.float64)
    z = (batch.values.double() * w[batch.indices.long()]).sum(1) + batch.offsets.double()
    y, wt = batch.labels.double(), batch.weights.double()
    return float((wt * (torch.nn.functional.softplus(z) - y * z)).sum() + 0.5 * lam * (w @ w))


# -- float64: the same fit ----------------------------------------------------


def _ref_fits64(ref_batch, mode):
    """{lambda: (iterations, reason, value, coefficients)} of the
    reference's L-BFGS in float64: warm-started λ to λ, or one vmapped
    bank of cold starts."""
    f64 = jnp.float64
    with jax.enable_x64(True):
        b = ref_batch._replace(**{
            k: jnp.asarray(np.asarray(getattr(ref_batch, k)), f64)
            for k in ("values", "labels", "offsets", "weights")
        })
        obj = RefGLMObjective(ref_losses.LOGISTIC, DIM)

        def fit(w0, l2):
            return ref_minimize_lbfgs(
                lambda w: obj.value_and_gradient(w, b, l2), w0, tol=TOL, max_iter=100
            )

        out = {}
        if mode == "sequential":
            w = jnp.zeros(DIM, f64)
            for lam in LAMBDAS:
                r = jax.jit(fit)(w, f64(lam))
                out[lam] = (int(r.iterations), int(r.reason), float(r.value),
                            np.asarray(r.coefficients))
                w = r.coefficients
        else:
            r = jax.jit(jax.vmap(fit))(
                jnp.zeros((len(LAMBDAS), DIM), f64), jnp.asarray(LAMBDAS, f64)
            )
            for i, lam in enumerate(LAMBDAS):
                out[lam] = (int(r.iterations[i]), int(r.reason[i]), float(r.value[i]),
                            np.asarray(r.coefficients[i]))
        return out


def _port_fits64(port_batch, mode):
    b = dataclasses.replace(port_batch, **{
        k: getattr(port_batch, k).double() for k in ("values", "labels", "offsets", "weights")
    })
    obj = GLMObjective(losses.LOGISTIC, DIM)
    out = {}
    if mode == "sequential":
        w = torch.zeros(DIM, dtype=torch.float64)
        for lam in LAMBDAS:
            r = minimize_lbfgs(lambda x: obj.value_and_gradient(x, b, lam), w, tol=TOL)
            out[lam] = (r.iterations, r.reason, float(r.value), to_np(r.coefficients))
            w = r.coefficients
    else:
        l2 = torch.tensor(LAMBDAS, dtype=torch.float64)
        r = minimize_lbfgs(
            lambda x: obj.value_and_gradient(x, b, l2),
            torch.zeros(len(LAMBDAS), DIM, dtype=torch.float64), tol=TOL,
        )
        for i, lam in enumerate(LAMBDAS):
            out[lam] = (r.iterations[i], r.reason[i], float(r.value[i]),
                        to_np(r.coefficients[i]))
    return out


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_float64_intercept_fits_are_the_same(batches, mode):
    ref_batch, port_batch = batches
    ref, port = _ref_fits64(ref_batch, mode), _port_fits64(port_batch, mode)
    for lam in LAMBDAS:
        r_it, r_reason, r_value, r_w = ref[lam]
        p_it, p_reason, p_value, p_w = port[lam]
        assert p_w.dtype == r_w.dtype == np.float64
        assert (p_it, p_reason) == (r_it, r_reason), lam
        np.testing.assert_allclose(p_w, r_w, rtol=0, atol=1e-9 * np.abs(r_w).max())
        assert abs(p_value - r_value) <= 1e-12 * abs(r_value), lam


# -- float32 through the trainers: the same objective -------------------------


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_float32_intercept_trainers_reach_the_same_objective(batches, mode):
    ref_batch, port_batch = batches
    ref_fn, port_fn = (
        (ref_train, train_generalized_linear_model) if mode == "sequential"
        else (ref_train_grid, train_grid_batched)
    )
    ref_models, ref_results = ref_fn(
        ref_batch, RefTaskType.LOGISTIC_REGRESSION, DIM,
        optimizer_type=RefOptimizerType.LBFGS, regularization_type=RefRegType.L2,
        regularization_weights=LAMBDAS, tolerance=TOL, intercept_index=D,
    )
    models, results = port_fn(
        port_batch, TaskType.LOGISTIC_REGRESSION, DIM,
        optimizer_type=OptimizerType.LBFGS, regularization_type=RegularizationType.L2,
        regularization_weights=LAMBDAS, tolerance=TOL, intercept_index=D, device="cpu",
    )
    for lam in LAMBDAS:
        assert results[lam].reason == int(ref_results[lam].reason), lam
        r_value, p_value = float(ref_results[lam].value), float(results[lam].value)
        assert abs(p_value - r_value) <= 1e-6 * abs(r_value), lam
        r64 = objective64(port_batch, ref_models[lam].means, lam)
        p64 = objective64(port_batch, models[lam].means, lam)
        assert abs(p64 - r64) <= 1e-6 * abs(r64), (lam, p64, r64)
