"""The PyTorch port's elementwise and small modules against the reference:
the four pointwise losses (margins up to +-50), normalization, the padded
sparse batch ops, model scoring and the evaluation metrics.

Tolerance: rtol 1e-6 with atol 1e-6 for elementwise f32 functions (both
sides evaluate the same stable forms; exp and log1p may differ in the last
ulp); rtol 1e-5 of the largest magnitude for reductions (another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.evaluation import metrics as ref_metrics
from photon_ml_tpu.models.glm import compute_margins as ref_compute_margins
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops import normalization as ref_norm
from photon_ml_tpu.data.batch import sparse_dot as ref_sparse_dot
from photon_ml_tpu.data.batch import sparse_scatter_add as ref_sparse_scatter_add
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.data.batch import sparse_dot, sparse_scatter_add
from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import compute_margins, create_model
from photon_ml_tpu_torch.ops import losses, normalization
from photon_ml_tpu_torch.task import TaskType
from tests.torch_parity import (
    assert_close,
    assert_close_to_scale,
    both_batches,
    random_rows,
)

LOSSES = ["LOGISTIC", "LINEAR", "POISSON", "SMOOTHED_HINGE"]


def _margins_labels(name):
    rng = np.random.default_rng(5)
    z = np.concatenate([
        np.array([-50.0, -20.0, -1.0, 0.0, 1e-3, 1.0, 20.0, 50.0]),
        rng.normal(scale=3.0, size=200),
    ]).astype(np.float32)
    if name in ("LOGISTIC", "SMOOTHED_HINGE"):
        y = (rng.uniform(size=z.shape) > 0.5).astype(np.float32)
    elif name == "POISSON":
        z = np.clip(z, -50.0, 20.0)  # keeps y * z and e^z well inside f32
        y = rng.poisson(2.0, size=z.shape).astype(np.float32)
    else:
        y = rng.normal(size=z.shape).astype(np.float32)
    return z, y


@pytest.mark.parametrize("name", LOSSES)
def test_pointwise_loss_matches_reference(name):
    ref, port = getattr(ref_losses, name), getattr(losses, name)
    z, y = _margins_labels(name)
    jz, jy, tz, ty = jnp.asarray(z), jnp.asarray(y), torch.as_tensor(z), torch.as_tensor(y)
    assert port.has_hessian == ref.has_hessian
    for fn in ("value", "d1", "d2"):
        got = getattr(port, fn)(tz, ty)
        assert torch.isfinite(got).all(), fn
        assert_close(got, getattr(ref, fn)(jz, jy), rtol=1e-6, atol=1e-6)
    assert_close(port.mean(tz), ref.mean(jz), rtol=1e-6, atol=1e-6)


def test_loss_for_task_covers_every_task():
    for task in TaskType:
        assert losses.loss_for_task(task).name == ref_losses.loss_for_task(
            ref_losses.TaskType(task.value)
        ).name


@pytest.mark.parametrize("kind", list(normalization.NormalizationType))
def test_build_normalization_matches_reference(kind):
    rng = np.random.default_rng(2)
    mean = rng.normal(size=12).astype(np.float32)
    std = np.abs(rng.normal(size=12)).astype(np.float32)
    std[3] = 0.0
    mx = np.abs(rng.normal(size=12)).astype(np.float32)
    mx[4] = 0.0
    ref = ref_norm.build_normalization(
        ref_norm.NormalizationType(kind.value), mean=mean, std=std,
        max_magnitude=mx, intercept_index=11,
    )
    got = normalization.build_normalization(
        kind, mean=torch.as_tensor(mean), std=torch.as_tensor(std),
        max_magnitude=torch.as_tensor(mx), intercept_index=11,
    )
    for field in ("factor", "shift"):
        r, g = getattr(ref, field), getattr(got, field)
        assert (r is None) == (g is None), field
        if r is not None:
            assert_close(g, r, rtol=1e-7)
    w = rng.normal(size=12).astype(np.float32)
    assert_close(
        got.intercept_adjustment(torch.as_tensor(w)),
        ref.intercept_adjustment(jnp.asarray(w)), rtol=1e-5, atol=1e-6,
    )


def _batches():
    rng = np.random.default_rng(9)
    rows, labels = random_rows(rng, n=60, d=40)
    ref, port = both_batches(
        rows, labels, rng.uniform(0.5, 2.0, 60), rng.normal(size=60)
    )
    return rng, ref, port


def test_sparse_batch_ops_match_reference():
    rng, ref, port = _batches()
    assert port.indices.shape == ref.indices.shape
    assert np.array_equal(port.indices.numpy(), np.asarray(ref.indices))
    w = rng.normal(size=40).astype(np.float32)
    c = rng.normal(size=port.num_rows).astype(np.float32)
    assert_close_to_scale(
        sparse_dot(port, torch.as_tensor(w)), ref_sparse_dot(ref, jnp.asarray(w)),
        rtol=1e-5, atol=1e-6,
    )
    assert_close_to_scale(
        sparse_scatter_add(port, torch.as_tensor(c), 40),
        ref_sparse_scatter_add(ref, jnp.asarray(c), 40), rtol=1e-5, atol=1e-6,
    )
    assert_close_to_scale(
        compute_margins(torch.as_tensor(w), port),
        ref_compute_margins(jnp.asarray(w), ref), rtol=1e-5, atol=1e-6,
    )


def test_model_prediction():
    _, _, port = _batches()
    model = create_model(TaskType.LOGISTIC_REGRESSION, Coefficients(torch.ones(40)))
    pred = model.predict_class(port)
    assert set(pred.unique().tolist()) <= {0.0, 1.0}
    with pytest.raises(ValueError):
        create_model(TaskType.LINEAR_REGRESSION, Coefficients(torch.ones(40))).predict_class(port)


@pytest.mark.parametrize("ties", [False, True])
def test_metrics_match_reference(ties):
    rng = np.random.default_rng(4)
    n = 500
    scores = rng.normal(size=n).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)  # many tied scores
    labels = (rng.uniform(size=n) > 0.4).astype(np.float32)
    weights = rng.uniform(0.0, 2.0, n).astype(np.float32)
    weights[:20] = 0.0  # padding rows
    j = [jnp.asarray(a) for a in (scores, labels, weights)]
    t = [torch.as_tensor(a) for a in (scores, labels, weights)]
    assert_close(
        metrics.area_under_roc_curve(*t), ref_metrics.area_under_roc_curve(*j),
        rtol=1e-5,
    )
    assert_close(
        metrics.root_mean_squared_error(*t),
        ref_metrics.root_mean_squared_error(*j), rtol=1e-5,
    )
    for fn in ("mean_pointwise_loss", "total_pointwise_loss"):
        assert_close(
            getattr(metrics, fn)(losses.LOGISTIC, *t),
            getattr(ref_metrics, fn)(ref_losses.LOGISTIC, *j), rtol=1e-5,
        )


def test_auc_degenerate_is_nan():
    t = torch.tensor([0.1, 0.2]), torch.ones(2), torch.ones(2)
    assert torch.isnan(metrics.area_under_roc_curve(*t))


def test_convert_carries_coefficients_and_normalization():
    means = np.arange(4, dtype=np.float32)
    c = convert.coefficients_from_reference(means, means * 2, device="cpu")
    assert c.dim == 4 and c.variances.tolist() == [0.0, 2.0, 4.0, 6.0]
    assert convert.coefficients_from_reference(means, device="cpu").variances is None
    n = convert.normalization_from_reference(factor=means, device="cpu")
    assert n.shift is None and n.factor.tolist() == means.tolist()
    assert convert.normalization_from_reference(device="cpu").is_identity
