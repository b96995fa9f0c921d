"""The port's diagnostics (``diagnostics/diagnostics.py``) and report
rendering (``diagnostics/reporting.py``) against the JAX package's.

One model is fitted by the reference (planted logistic rows with an
intercept from ``tests/torch_mesh_cases.py``, λ = 1) and handed to both
packages with the same coefficients. Each diagnostic's numbers are held
within 1e-4 relative (absolute below 1e-6); the bootstrap and the fitting
curves draw the same resamples and portions (the row weights each refit
gets are bitwise equal), and each package refits with its own trainer.
The same logical document renders to the same HTML and text in both.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
from photon_ml_tpu.diagnostics import diagnostics as ref_diag
from photon_ml_tpu.diagnostics import reporting as ref_reporting
from photon_ml_tpu.models.coefficients import Coefficients as RefCoefficients
from photon_ml_tpu.models.glm import create_model as ref_create_model
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu.training import train_generalized_linear_model as ref_train
from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.diagnostics import diagnostics as diag
from photon_ml_tpu_torch.diagnostics import reporting
from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import compute_margins, create_model
from photon_ml_tpu_torch.optim.config import RegularizationType
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model
from tests.torch_mesh_cases import D, planted_problem

LAM = 1.0


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    rows, labels, weights = planted_problem(8)
    ref_batch = ref_make_sparse_batch(rows, labels, weights=weights)
    port_batch = make_sparse_batch(rows, labels, weights=weights, device="cpu")
    rows_t, labels_t, weights_t = planted_problem(9)
    ref_test = ref_make_sparse_batch(rows_t, labels_t, weights=weights_t)
    port_test = make_sparse_batch(rows_t, labels_t, weights=weights_t, device="cpu")
    models, _ = ref_train(ref_batch, RefTaskType.LOGISTIC_REGRESSION, D,
                          regularization_type=RefRegType.L2, regularization_weights=[LAM],
                          intercept_index=D - 1)
    means = np.asarray(models[LAM].means)
    ref_model = ref_create_model(RefTaskType.LOGISTIC_REGRESSION, RefCoefficients(means))
    port_model = create_model(TaskType.LOGISTIC_REGRESSION,
                              Coefficients(torch.as_tensor(means.copy())))
    return ref_batch, port_batch, ref_test, port_test, ref_model, port_model


def test_hosmer_lemeshow_matches_reference(case):
    ref_batch, port_batch, _, _, ref_model, port_model = case
    for bins in (10, 4):
        want = ref_diag.hosmer_lemeshow_diagnostic(ref_model, ref_batch, num_bins=bins)
        got = diag.hosmer_lemeshow_diagnostic(port_model, port_batch, num_bins=bins)
        assert got.degrees_of_freedom == want.degrees_of_freedom
        close([got.chi_square, got.p_value], [want.chi_square, want.p_value])
        assert [sorted(b) for b in got.bins] == [sorted(b) for b in want.bins]
        close([[b[k] for k in sorted(b)] for b in got.bins],
              [[b[k] for k in sorted(b)] for b in want.bins])


def test_hosmer_lemeshow_is_for_logistic_models(case):
    _, port_batch, _, _, _, port_model = case
    linear = create_model(TaskType.LINEAR_REGRESSION, port_model.coefficients)
    with pytest.raises(ValueError, match="logistic"):
        diag.hosmer_lemeshow_diagnostic(linear, port_batch)


@pytest.mark.parametrize("max_samples", [2000, 50])
def test_kendall_tau_matches_reference(case, max_samples):
    ref_batch, port_batch, _, _, ref_model, port_model = case
    want = ref_diag.kendall_tau_diagnostic(ref_model, ref_batch, max_samples=max_samples)
    got = diag.kendall_tau_diagnostic(port_model, port_batch, max_samples=max_samples)
    close([got.tau, got.p_value], [want.tau, want.p_value])
    assert got.message == want.message


def test_feature_importance_matches_reference(case):
    _, _, _, _, ref_model, port_model = case
    rng = np.random.default_rng(1)
    mean, var = rng.normal(size=D), rng.uniform(0, 2, size=D)
    want = ref_diag.feature_importance_diagnostic(ref_model, mean, var, top_k=15)
    got = diag.feature_importance_diagnostic(port_model, mean, var, top_k=15)
    for g, w in ((got.expected_magnitude, want.expected_magnitude),
                 (got.variance_magnitude, want.variance_magnitude)):
        assert [i for i, _ in g] == [i for i, _ in w]
        close([v for _, v in g], [v for _, v in w])


def _recording(train):
    """(train_fn, the row weights each refit got)."""
    seen = []

    def fn(batch):
        seen.append(np.asarray(batch.weights.cpu() if torch.is_tensor(batch.weights)
                               else batch.weights).copy())
        return train(batch)

    return fn, seen


def _ref_train_fn(batch):
    models, _ = ref_train(batch, RefTaskType.LOGISTIC_REGRESSION, D,
                          regularization_type=RefRegType.L2, regularization_weights=[LAM],
                          tolerance=1e-4, intercept_index=D - 1)
    return models[LAM]


def _port_train_fn(batch):
    models, _ = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, D, regularization_type=RegularizationType.L2,
        regularization_weights=[LAM], tolerance=1e-4, intercept_index=D - 1, device="cpu")
    return models[LAM]


def _auc(model, batch):
    if torch.is_tensor(batch.labels):
        return {"AUC": float(area_under_roc_curve(
            compute_margins(model.means, batch), batch.labels, batch.weights))}
    from photon_ml_tpu.evaluation.metrics import area_under_roc_curve as ref_auc
    from photon_ml_tpu.models.glm import compute_margins as ref_margins

    return {"AUC": float(ref_auc(ref_margins(model.means, batch), batch.labels, batch.weights))}


def test_bootstrap_matches_reference(case):
    ref_batch, port_batch, _, _, _, _ = case
    ref_fn, ref_seen = _recording(_ref_train_fn)
    fn, seen = _recording(_port_train_fn)
    want = ref_diag.bootstrap_training_diagnostic(
        ref_batch, ref_fn, lambda m: _auc(m, ref_batch), num_samples=4, seed=3, top_k=6)
    got = diag.bootstrap_training_diagnostic(
        port_batch, fn, lambda m: _auc(m, port_batch), num_samples=4, seed=3, top_k=6)
    assert len(seen) == len(ref_seen) == 4
    for a, b in zip(seen, ref_seen):
        assert a.tobytes() == b.tobytes()  # the same resamples
    assert got.num_samples == want.num_samples
    scale = np.abs(want.coefficient_intervals).max()
    np.testing.assert_allclose(got.coefficient_intervals, want.coefficient_intervals,
                               rtol=0, atol=1e-4 * scale)
    assert sorted(got.metrics_distribution) == sorted(want.metrics_distribution)
    for k, v in want.metrics_distribution.items():
        close(got.metrics_distribution[k], v)
    assert [i for i, _, _ in got.important_features] == [i for i, _, _ in want.important_features]


def test_fitting_curves_match_reference(case):
    ref_batch, port_batch, ref_test, port_test, _, _ = case
    ref_fn, ref_seen = _recording(_ref_train_fn)
    fn, seen = _recording(_port_train_fn)
    want = ref_diag.fitting_diagnostic(ref_batch, ref_test, ref_fn, _auc, num_portions=4, seed=2)
    got = diag.fitting_diagnostic(port_batch, port_test, fn, _auc, num_portions=4, seed=2)
    for a, b in zip(seen, ref_seen):
        assert a.tobytes() == b.tobytes()  # the same portions
    assert got.portions == want.portions and got.message == want.message
    for curves, ref_curves in ((got.train_metrics, want.train_metrics),
                               (got.test_metrics, want.test_metrics)):
        assert sorted(curves) == sorted(ref_curves)
        for k, v in ref_curves.items():
            close(curves[k], v)


def _document(mod):
    return mod.Document("T <&>", [
        mod.Chapter("one", [mod.Section("s", [
            mod.Text("a < b"),
            mod.Table(["x", "y"], [["1", "2"], ["3"], ["4", "5", "6"]], caption="c"),
            mod.LinePlot([0.0, 0.5, 1.0], [("up", [0.1, float("nan"), 0.9]), ("flat", [1, 1, 1])],
                         title="p", x_label="x", y_label="y"),
            mod.LinePlot([], [], title="empty"),
        ])]),
        mod.Chapter("two", []),
    ])


def test_reports_render_as_the_reference(tmp_path):
    assert reporting.render_html(_document(reporting)) == \
        ref_reporting.render_html(_document(ref_reporting))
    assert reporting.render_text(_document(reporting)) == \
        ref_reporting.render_text(_document(ref_reporting))
    reporting.write_html_report(_document(reporting), str(tmp_path / "r" / "report.html"))
    reporting.write_text_report(_document(reporting), str(tmp_path / "r" / "report.txt"))
    assert (tmp_path / "r" / "report.html").read_text() == \
        ref_reporting.render_html(_document(ref_reporting))
    assert (tmp_path / "r" / "report.txt").read_text() == \
        ref_reporting.render_text(_document(ref_reporting))
