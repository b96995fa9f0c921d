"""Model diagnostics: bootstrap CIs, Hosmer-Lemeshow, Kendall-tau,
feature importance, fitting curves (port of
``photon_ml_tpu/diagnostics/diagnostics.py``).

Reference: photon-ml .../diagnostics/** —
- bootstrap/BootstrapTrainingDiagnostic.scala:1-149 + BootstrapTraining
  .scala:46-99 (resample + train + per-coefficient CoefficientSummary CIs),
- hl/HosmerLemeshowDiagnostic.scala:1-97 (decile-binned chi^2 calibration
  for logistic models),
- independence/KendallTauAnalysis.scala:1-131 (prediction/error rank
  independence),
- featureimportance/* (|w_j|-based mean/variance importance),
- fitting/FittingDiagnostic.scala:1-131 (learning curves on 10%%..100%%
  portions).

Each diagnostic returns a plain-Python report consumed by
``diagnostics/reporting.py`` (logical -> HTML). The refits run through
the caller's ``train_fn`` (on the card, the tiled objective and K1); the
statistics are host numpy and scipy over the model's predictions, with the
reference's seeded draws (``numpy.random.default_rng``), so both packages
resample the same rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from scipy import stats as scipy_stats

from photon_ml_tpu_torch.data.batch import SparseBatch as Batch
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, compute_means
from photon_ml_tpu_torch.task import TaskType


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _with_weights(batch: Batch, weights: np.ndarray) -> Batch:
    """``batch`` with new row weights (float32, on the batch's device)."""
    w = torch.as_tensor(weights.astype(np.float32), device=batch.weights.device)
    return dataclasses.replace(batch, weights=w)


# ---------------------------------------------------------------------------
# Bootstrap
# ---------------------------------------------------------------------------


@dataclass
class BootstrapReport:
    num_samples: int
    # per-coefficient: (mean, std, lo, hi) at the requested confidence
    coefficient_intervals: np.ndarray  # [d, 4]
    metrics_distribution: Dict[str, Tuple[float, float]]  # name -> (mean, std)
    important_features: List[Tuple[int, float, float]]  # (index, mean, std)


def bootstrap_training_diagnostic(
    batch: Batch,
    train_fn: Callable[[Batch], GeneralizedLinearModel],
    metrics_fn: Callable[[GeneralizedLinearModel], Dict[str, float]],
    *,
    num_samples: int = 10,
    confidence: float = 0.95,
    seed: int = 0,
    top_k: int = 10,
) -> BootstrapReport:
    """Resample rows WITH replacement (as weight multipliers — static
    shapes), retrain, aggregate per-coefficient summaries
    (BootstrapTrainingDiagnostic; resampling via multinomial row weights is
    the weighted-bootstrap equivalent of RDD.sample(true, 1.0))."""
    rng = np.random.default_rng(seed)
    weights = _np(batch.weights)
    real = weights > 0
    coefs = []
    metric_values: Dict[str, List[float]] = {}
    for b in range(num_samples):
        counts = rng.multinomial(real.sum(), real / real.sum())
        resampled = _with_weights(batch, weights * counts)
        model = train_fn(resampled)
        coefs.append(_np(model.means))
        for k, v in metrics_fn(model).items():
            metric_values.setdefault(k, []).append(v)
    coefs = np.stack(coefs)  # [B, d]
    alpha = (1.0 - confidence) / 2.0
    lo = np.quantile(coefs, alpha, axis=0)
    hi = np.quantile(coefs, 1.0 - alpha, axis=0)
    mean = coefs.mean(axis=0)
    std = coefs.std(axis=0, ddof=1) if num_samples > 1 else np.zeros_like(mean)
    intervals = np.stack([mean, std, lo, hi], axis=1)
    importance = np.abs(mean)
    order = np.argsort(-importance)[:top_k]
    return BootstrapReport(
        num_samples=num_samples,
        coefficient_intervals=intervals,
        metrics_distribution={
            k: (float(np.mean(v)), float(np.std(v)))
            for k, v in metric_values.items()
        },
        important_features=[(int(i), float(mean[i]), float(std[i])) for i in order],
    )


# ---------------------------------------------------------------------------
# Hosmer-Lemeshow
# ---------------------------------------------------------------------------


@dataclass
class HosmerLemeshowReport:
    chi_square: float
    degrees_of_freedom: int
    p_value: float
    bins: List[Dict[str, float]]  # per bin: count, expected_pos, observed_pos


def hosmer_lemeshow_diagnostic(
    model: GeneralizedLinearModel,
    batch: Batch,
    *,
    num_bins: int = 10,
) -> HosmerLemeshowReport:
    """Decile-of-risk calibration chi^2 for logistic models
    (HosmerLemeshowDiagnostic.scala:1-97)."""
    if model.task != TaskType.LOGISTIC_REGRESSION:
        raise ValueError("Hosmer-Lemeshow applies to logistic regression only")
    probs = _np(model.mean(batch))
    labels = _np(batch.labels)
    weights = _np(batch.weights)
    real = weights > 0
    probs, labels, weights = probs[real], labels[real], weights[real]
    order = np.argsort(probs)
    probs, labels, weights = probs[order], labels[order], weights[order]
    cum_w = np.cumsum(weights)
    total = cum_w[-1]
    edges = np.searchsorted(cum_w, np.linspace(0, total, num_bins + 1)[1:-1])
    idx = np.split(np.arange(len(probs)), edges)
    chi2 = 0.0
    bins = []
    used_bins = 0
    for bucket in idx:
        if len(bucket) == 0:
            continue
        w = weights[bucket]
        cnt = w.sum()
        obs = (labels[bucket] * w).sum()
        exp = (probs[bucket] * w).sum()
        denom = exp * (1.0 - exp / max(cnt, 1e-12))
        if denom > 1e-12:
            chi2 += (obs - exp) ** 2 / denom
        used_bins += 1
        bins.append({
            "count": float(cnt),
            "observed_pos": float(obs),
            "expected_pos": float(exp),
            "mean_prob": float((probs[bucket] * w).sum() / max(cnt, 1e-12)),
        })
    dof = max(used_bins - 2, 1)
    p = float(scipy_stats.chi2.sf(chi2, dof))
    return HosmerLemeshowReport(
        chi_square=float(chi2), degrees_of_freedom=dof, p_value=p, bins=bins
    )


# ---------------------------------------------------------------------------
# Kendall tau
# ---------------------------------------------------------------------------


@dataclass
class KendallTauReport:
    tau: float
    p_value: float
    message: str


def kendall_tau_diagnostic(
    model: GeneralizedLinearModel,
    batch: Batch,
    *,
    max_samples: int = 2000,
    seed: int = 0,
) -> KendallTauReport:
    """Rank correlation between predictions and residual errors
    (KendallTauAnalysis.scala:1-131): material correlation flags a
    systematically mis-specified model."""
    preds = _np(compute_means(model.task, model.means, batch))
    labels = _np(batch.labels)
    real = _np(batch.weights) > 0
    preds, labels = preds[real], labels[real]
    errors = labels - preds
    if len(preds) > max_samples:
        sel = np.random.default_rng(seed).choice(
            len(preds), size=max_samples, replace=False
        )
        preds, errors = preds[sel], errors[sel]
    tau, p = scipy_stats.kendalltau(preds, errors)
    msg = (
        "prediction/error ranks look independent"
        if p > 0.05
        else "prediction and error ranks are correlated — check model fit"
    )
    return KendallTauReport(tau=float(tau), p_value=float(p), message=msg)


# ---------------------------------------------------------------------------
# Feature importance
# ---------------------------------------------------------------------------


@dataclass
class FeatureImportanceReport:
    # (feature index, importance) sorted descending
    expected_magnitude: List[Tuple[int, float]]
    variance_magnitude: List[Tuple[int, float]]


def feature_importance_diagnostic(
    model: GeneralizedLinearModel,
    feature_means: np.ndarray,
    feature_variances: np.ndarray,
    *,
    top_k: int = 20,
) -> FeatureImportanceReport:
    """|w_j * E[x_j]| and |w_j| * sd(x_j) importances
    (featureimportance/ExpectedMagnitudeFeatureImportanceDiagnostic and
    VarianceFeatureImportanceDiagnostic)."""
    w = _np(model.means)
    exp_imp = np.abs(w * feature_means)
    var_imp = np.abs(w) * np.sqrt(np.maximum(feature_variances, 0.0))
    def top(arr):
        order = np.argsort(-arr)[:top_k]
        return [(int(i), float(arr[i])) for i in order]
    return FeatureImportanceReport(top(exp_imp), top(var_imp))


# ---------------------------------------------------------------------------
# Fitting / learning curves
# ---------------------------------------------------------------------------


@dataclass
class FittingReport:
    portions: List[float]
    train_metrics: Dict[str, List[float]]
    test_metrics: Dict[str, List[float]]
    message: str


def fitting_diagnostic(
    batch: Batch,
    test_batch: Batch,
    train_fn: Callable[[Batch], GeneralizedLinearModel],
    metrics_fn: Callable[[GeneralizedLinearModel, Batch], Dict[str, float]],
    *,
    num_portions: int = 10,
    seed: int = 0,
) -> FittingReport:
    """Train on growing data portions, record train/test metric curves
    (FittingDiagnostic.scala:1-131). Portions are weight masks, keeping
    shapes static."""
    rng = np.random.default_rng(seed)
    w0 = _np(batch.weights)
    real_idx = np.nonzero(w0 > 0)[0]
    perm = rng.permutation(real_idx)
    portions = [p / num_portions for p in range(1, num_portions + 1)]
    train_curves: Dict[str, List[float]] = {}
    test_curves: Dict[str, List[float]] = {}
    for p in portions:
        take = perm[: max(1, int(len(perm) * p))]
        mask = np.zeros_like(w0)
        mask[take] = 1.0
        sub = _with_weights(batch, w0 * mask)
        model = train_fn(sub)
        for k, v in metrics_fn(model, sub).items():
            train_curves.setdefault(k, []).append(v)
        for k, v in metrics_fn(model, test_batch).items():
            test_curves.setdefault(k, []).append(v)
    gaps = {
        k: abs(train_curves[k][-1] - test_curves[k][-1])
        for k in train_curves
        if k in test_curves
    }
    message = (
        "learning curves converge — more data unlikely to help"
        if all(g < 0.05 for g in gaps.values())
        else "train/test gap persists — consider more data or regularization"
    )
    return FittingReport(
        portions=portions,
        train_metrics=train_curves,
        test_metrics=test_curves,
        message=message,
    )
