"""The driver's diagnose stage and its HTML report (port of
``photon_ml_tpu/diagnostics/report.py``).

Reference: photon-ml Driver.scala:525-552 (per-model diagnostics over the
lambda grid) and :618-638 (the report written to
<output>/model-diagnostics).

The bootstrap and fitting-curve refits train with the driver's kernel
choice on the driver's device: on the card that is the tiled objective, so
every refit runs K1. The batch is tiled once (through the driver's
schedule cache) and each refit swaps only its row weights in. A refit that
fails fails the run. A streamed training set is never in memory: the
row-level sections (calibration and Kendall without validation data,
bootstrap, fitting curves) run on the reservoir sample that the streamed
summary pass drew, the bounded-memory stand-in for the reference's
RDD-wide diagnose passes.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from photon_ml_tpu_torch.diagnostics.diagnostics import (
    bootstrap_training_diagnostic,
    feature_importance_diagnostic,
    fitting_diagnostic,
    hosmer_lemeshow_diagnostic,
    kendall_tau_diagnostic,
)
from photon_ml_tpu_torch.diagnostics.reporting import (
    Chapter,
    Document,
    LinePlot,
    Section,
    Table,
    Text,
    write_html_report,
    write_text_report,
)
from photon_ml_tpu_torch.ops.schedule_cache import cache_scope
from photon_ml_tpu_torch.ops.tiled_sparse import ensure_tiled
from photon_ml_tpu_torch.optim.problem import resolve_kernel
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model


def _trainer(driver, lam: float, train_batch):
    """``train_fn(batch) -> model`` at ``lam`` for the refits: the driver's
    problem settings, kernel and device. A tiled kernel tiles the driver's
    batch (``train_batch``) once; each refit hands the trainer that tiled
    batch with the refit's row weights (padded to the tiled row space)."""
    p = driver.params
    data = driver._data
    tiled = None
    if resolve_kernel(p.kernel, driver.device) == "tiled":
        with cache_scope(p.tile_cache_dir):
            tiled = ensure_tiled(train_batch, data.num_features, device=driver.device)

    def train_fn(batch):
        if tiled is not None:
            w = torch.zeros_like(tiled.weights)
            w[: batch.weights.shape[0]] = batch.weights
            batch = dataclasses.replace(tiled, weights=w)
        models, _ = train_generalized_linear_model(
            batch, p.task, data.num_features,
            optimizer_type=p.optimizer_type,
            regularization_type=p.regularization_type,
            regularization_weights=[lam],
            elastic_net_alpha=p.elastic_net_alpha,
            max_iter=p.max_num_iterations,
            tolerance=p.tolerance,
            normalization=driver._norm,
            intercept_index=data.intercept_index,
            kernel=p.kernel,
            device=driver.device,
        )
        return models[lam]

    return train_fn


def run_glm_diagnostics(driver) -> None:
    """Diagnose the trained lambda grid and write the HTML report (and its
    text twin). ``driver`` is a GLMDriver after train() (and validate(),
    when a validation directory was given)."""
    p = driver.params
    data = driver._data
    summary = driver._summary
    batch = data.batch if data.batch is not None else getattr(driver, "_stream_sample", None)
    if batch is None:
        raise ValueError(
            "diagnostics need an in-memory batch or a streamed reservoir "
            "sample; run preprocess() with a diagnostic mode set"
        )
    vdata = getattr(driver, "_validation_data", None)
    doc = Document(title=f"Photon ML diagnostics — {p.job_name}")

    def feature_name(i: int) -> str:
        key = data.index_map.get_feature_name(i)
        return key.replace("\t", " / ") if key else str(i)

    # -- per-lambda model diagnostics -------------------------------------
    # the feature summary's moments, fetched once through the counted seam
    mean, variance = overlap.device_get((summary.mean, summary.variance))
    for lam, model in driver.models.items():
        chapter = Chapter(title=f"Model lambda={lam}")
        imp = feature_importance_diagnostic(model, mean, variance)
        chapter.sections.append(
            Section(
                "Feature importance",
                [
                    Table(
                        ["feature", "|w * E[x]|"],
                        [[feature_name(i), f"{v:.5g}"] for i, v in imp.expected_magnitude[:10]],
                        caption="expected-magnitude importance",
                    ),
                    Table(
                        ["feature", "|w| * sd(x)"],
                        [[feature_name(i), f"{v:.5g}"] for i, v in imp.variance_magnitude[:10]],
                        caption="variance importance",
                    ),
                ],
            )
        )
        eval_batch = vdata.batch if vdata is not None else batch
        if p.task == TaskType.LOGISTIC_REGRESSION:
            hl = hosmer_lemeshow_diagnostic(model, eval_batch)
            chapter.sections.append(
                Section(
                    "Hosmer-Lemeshow calibration",
                    [
                        Text(
                            f"chi^2 = {hl.chi_square:.4g} with "
                            f"{hl.degrees_of_freedom} dof, p = {hl.p_value:.4g}"
                        ),
                        Table(
                            ["bin count", "observed+", "expected+", "mean p"],
                            [
                                [f"{b['count']:.0f}", f"{b['observed_pos']:.1f}",
                                 f"{b['expected_pos']:.1f}", f"{b['mean_prob']:.3f}"]
                                for b in hl.bins
                            ],
                        ),
                        LinePlot(
                            x=[b["mean_prob"] for b in hl.bins],
                            series=[
                                ("observed rate",
                                 [b["observed_pos"] / max(b["count"], 1e-9) for b in hl.bins]),
                                ("expected rate",
                                 [b["expected_pos"] / max(b["count"], 1e-9) for b in hl.bins]),
                            ],
                            title="calibration", x_label="predicted", y_label="rate",
                        ),
                    ],
                )
            )
        kt = kendall_tau_diagnostic(model, eval_batch)
        chapter.sections.append(
            Section(
                "Prediction-error independence (Kendall tau)",
                [Text(f"tau = {kt.tau:.4g}, p = {kt.p_value:.4g}: {kt.message}")],
            )
        )
        doc.chapters.append(chapter)

    # -- bootstrap and fitting curves on the selected model ---------------
    best_lambda = (
        driver.best_lambda if driver.best_lambda is not None else sorted(driver.models)[0]
    )
    train_fn = _trainer(driver, best_lambda, batch)

    def metrics_fn(model, b=None):
        return driver._metrics_for(model, b if b is not None else batch)

    boot = bootstrap_training_diagnostic(
        batch, train_fn, lambda m: metrics_fn(m), num_samples=5
    )
    boot_chapter = Chapter("Bootstrap analysis")
    boot_chapter.sections.append(
        Section(
            f"Bootstrap ({boot.num_samples} resamples, lambda={best_lambda})",
            [
                Table(
                    ["metric", "mean", "std"],
                    [[k, f"{m:.5g}", f"{s:.3g}"]
                     for k, (m, s) in boot.metrics_distribution.items()],
                ),
                Table(
                    ["feature", "coef mean", "coef std"],
                    [[data.index_map.get_feature_name(i) or str(i), f"{m:.5g}", f"{s:.3g}"]
                     for i, m, s in boot.important_features],
                    caption="top coefficients across bootstrap replicates",
                ),
            ],
        )
    )
    doc.chapters.append(boot_chapter)

    if vdata is not None:
        fit = fitting_diagnostic(
            batch, vdata.batch, train_fn, lambda m, b: metrics_fn(m, b), num_portions=5
        )
        metric0 = next(iter(fit.train_metrics))
        doc.chapters.append(
            Chapter(
                "Fitting analysis",
                [
                    Section(
                        "Learning curves",
                        [
                            Text(fit.message),
                            LinePlot(
                                x=fit.portions,
                                series=[
                                    (f"train {metric0}", fit.train_metrics[metric0]),
                                    (f"test {metric0}", fit.test_metrics[metric0]),
                                ],
                                title=f"{metric0} vs training portion",
                                x_label="portion", y_label=metric0,
                            ),
                        ],
                    )
                ],
            )
        )

    out_dir = os.path.join(p.output_dir, "model-diagnostics")
    write_html_report(doc, os.path.join(out_dir, "report.html"))
    write_text_report(doc, os.path.join(out_dir, "report.txt"))
    driver.logger.info("diagnostics report written to %s", os.path.join(out_dir, "report.html"))
