"""Validation gates: the promotion decision between "trained" and
"serving" (port of ``photon_ml_tpu/registry/gates.py``).

A retrain loop that auto-publishes MUST be unable to ship a model that
is worse than what is already serving — bad labels, a broken join, a
drifted feature pipeline all produce models that converge fine and
score garbage. The gates compare the CANDIDATE against its PARENT on a
held-out stream and produce one named terminal verdict:

- ``PASS`` — every gate held; the candidate may commit.
- ``AUC_REGRESSION`` / ``RMSE_REGRESSION`` — holdout quality moved
  against the parent past the configured margin (streamed accumulators
  from ``evaluation/streaming.py``; the holdout is never materialized).
- ``COEF_NORM_BLOWUP`` — the coefficient norm grew past
  ``max_coef_norm_ratio``x the parent's: the classic exploding-fit
  signature of label leakage or a collapsed regularizer.
- ``PREDICTION_DRIFT`` — mean |candidate - parent| margin on the
  holdout beyond ``max_prediction_drift``: the candidate scores a
  DIFFERENT function even where quality metrics look fine (fast
  detector for feature-pipeline skew).

The verdict (and every per-gate measurement) is recorded verbatim in
the registry manifest; a non-PASS verdict makes
``ModelRegistry.publish`` refuse the candidate — a failed gate is a
terminal, named, auditable outcome, not a warning.

Precision: the AUC and drift accumulators are float64 numpy on the host,
as in the reference. The RMSE branch's mean transform runs in float32 on
the chunk's device (the card in the drivers), so a mean-space RMSE may
differ from the reference's in the last float32 bits of each mean
(held to 1e-6 relative in the tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # torch stays out of the registry's import path
    from photon_ml_tpu_torch.utils.device import DeviceLike

__all__ = ["GateConfig", "GateReport", "evaluate_gates", "coef_norm_gate"]

# chunk protocol: (candidate_margins, parent_margins, labels, weights)
ChunkStream = Iterable[Tuple[object, object, object, object]]


def _host64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


@dataclass(frozen=True)
class GateConfig:
    """Thresholds. Margins are ABSOLUTE deltas against the parent's
    measured value (relative thresholds turn degenerate when the parent
    metric sits near 0)."""

    max_auc_drop: float = 0.005
    max_rmse_increase: float = 0.01
    max_coef_norm_ratio: float = 10.0
    max_prediction_drift: Optional[float] = None  # None = gate off
    min_holdout_rows: int = 1

    def as_dict(self) -> Dict[str, object]:
        return {
            "max_auc_drop": self.max_auc_drop,
            "max_rmse_increase": self.max_rmse_increase,
            "max_coef_norm_ratio": self.max_coef_norm_ratio,
            "max_prediction_drift": self.max_prediction_drift,
            "min_holdout_rows": self.min_holdout_rows,
        }


@dataclass
class GateReport:
    """The manifest-recorded outcome: one named verdict + the per-gate
    measurements that produced it."""

    verdict: str
    checks: Dict[str, Dict[str, object]]
    config: Dict[str, object]

    @property
    def passed(self) -> bool:
        return self.verdict == "PASS"

    def as_dict(self) -> Dict[str, object]:
        return {
            "verdict": self.verdict,
            "checks": self.checks,
            "config": self.config,
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "GateReport":
        return GateReport(
            verdict=str(d.get("verdict", "")),
            checks=dict(d.get("checks", {})),
            config=dict(d.get("config", {})),
        )


def coef_norm_gate(
    candidate_norm: float, parent_norm: float, config: GateConfig
) -> Dict[str, object]:
    """The coefficient-sanity check, separable from the holdout pass so
    drivers can run it on whatever norm their model family defines
    (GLM: ||means||2; GAME: FE norm + RE bank norm)."""
    # an exactly-zero parent norm (fresh intercept-only parent) gates on
    # an absolute bound instead of a ratio of zero
    if parent_norm <= 0.0:
        passed = bool(np.isfinite(candidate_norm))
        ratio = float("inf") if candidate_norm > 0 else 1.0
    else:
        ratio = float(candidate_norm / parent_norm)
        passed = bool(
            np.isfinite(candidate_norm)
            and ratio <= config.max_coef_norm_ratio
        )
    return {
        "passed": passed,
        "candidate_norm": float(candidate_norm),
        "parent_norm": float(parent_norm),
        "ratio": ratio,
        "threshold": config.max_coef_norm_ratio,
    }


def evaluate_gates(
    chunks: ChunkStream,
    task,
    *,
    config: Optional[GateConfig] = None,
    candidate_norm: Optional[float] = None,
    parent_norm: Optional[float] = None,
    device: DeviceLike = None,
) -> GateReport:
    """Run the full gate set over one streamed pass of the holdout.

    ``chunks`` yields ``(candidate_margins, parent_margins, labels,
    weights)`` per chunk (numpy arrays or tensors) — the caller owns
    scoring (GLM margins, GAME total scores), this owns the accumulators
    and the verdict. The first failing gate in severity order names the
    verdict; every check's measurement is recorded either way.
    ``device``: where the RMSE branch's mean transform runs for host
    chunks (a tensor chunk keeps its own device); only that branch
    resolves it.
    """
    import torch

    from photon_ml_tpu_torch.evaluation.streaming import (
        StreamingAUC,
        StreamingRMSE,
    )
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.parallel import overlap
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.utils.device import resolve_device

    config = config or GateConfig()
    loss = loss_for_task(task)
    use_auc = task in (
        TaskType.LOGISTIC_REGRESSION,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
    )
    use_rmse = task in (
        TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION,
    )
    cand_auc, par_auc = StreamingAUC(), StreamingAUC()
    cand_rmse, par_rmse = StreamingRMSE(), StreamingRMSE()
    drift_sum = 0.0
    w_sum = 0.0
    rows = 0
    for cand_m, par_m, labels, weights in chunks:
        cm, pm = _host64(cand_m), _host64(par_m)
        y, w = _host64(labels), _host64(weights)
        rows += int(cm.shape[0])
        if use_auc:
            cand_auc.update(cm, y, w)
            par_auc.update(pm, y, w)
        if use_rmse:
            dev = (
                cand_m.device if torch.is_tensor(cand_m)
                else resolve_device(device)
            )

            def f32(a):
                return torch.as_tensor(a, dtype=torch.float32, device=dev)

            # mean-space transform runs on the device; ONE counted fetch
            # brings both models' predictions back per chunk
            mean_c, mean_p = overlap.device_get(
                (loss.mean(f32(cm)), loss.mean(f32(pm)))
            )
            cand_rmse.update(mean_c, y, w)
            par_rmse.update(mean_p, y, w)
        drift_sum += float(np.sum(w * np.abs(cm - pm)))
        w_sum += float(np.sum(w))

    checks: Dict[str, Dict[str, object]] = {}
    verdict = "PASS"

    def fail(name: str) -> None:
        nonlocal verdict
        if verdict == "PASS":
            verdict = name

    if rows < config.min_holdout_rows:
        checks["holdout"] = {
            "passed": False,
            "rows": rows,
            "threshold": config.min_holdout_rows,
        }
        fail("EMPTY_HOLDOUT")
    if candidate_norm is not None and parent_norm is not None:
        checks["coef_norm"] = coef_norm_gate(
            candidate_norm, parent_norm, config
        )
        if not checks["coef_norm"]["passed"]:
            fail("COEF_NORM_BLOWUP")
    if use_auc and rows:
        c, p = cand_auc.result(), par_auc.result()
        ok = bool(
            np.isnan(p) or (
                not np.isnan(c) and c >= p - config.max_auc_drop
            )
        )
        checks["auc"] = {
            "passed": ok,
            "candidate": float(c),
            "parent": float(p),
            "max_drop": config.max_auc_drop,
        }
        if not ok:
            fail("AUC_REGRESSION")
    if use_rmse and rows:
        c, p = cand_rmse.result(), par_rmse.result()
        ok = bool(c <= p + config.max_rmse_increase)
        checks["rmse"] = {
            "passed": ok,
            "candidate": float(c),
            "parent": float(p),
            "max_increase": config.max_rmse_increase,
        }
        if not ok:
            fail("RMSE_REGRESSION")
    if config.max_prediction_drift is not None and w_sum > 0:
        drift = drift_sum / w_sum
        ok = bool(drift <= config.max_prediction_drift)
        checks["prediction_drift"] = {
            "passed": ok,
            "mean_abs_margin_delta": float(drift),
            "threshold": config.max_prediction_drift,
        }
        if not ok:
            fail("PREDICTION_DRIFT")
    return GateReport(
        verdict=verdict, checks=checks, config=config.as_dict()
    )


def glm_gate_chunks(
    candidate_means,
    parent_means,
    paths,
    fmt,
    index_map,
    nnz_width: int,
    *,
    device: DeviceLike = None,
) -> ChunkStream:
    """GLM chunk adapter: stream the holdout once, scoring BOTH models
    per chunk on ``device`` (the chunk is staged once; two margin
    computations share it, and one fetch brings both margins, the labels
    and the weights back)."""
    import torch

    from photon_ml_tpu_torch.io.streaming import iter_chunks
    from photon_ml_tpu_torch.models.glm import compute_margins
    from photon_ml_tpu_torch.parallel import overlap
    from photon_ml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cand_w = torch.as_tensor(candidate_means, dtype=torch.float32, device=dev)
    par_w = torch.as_tensor(parent_means, dtype=torch.float32, device=dev)
    for chunk in iter_chunks(
        paths, fmt, index_map, rows_per_chunk=65536, nnz_width=nnz_width,
        device=dev,
    ):
        yield overlap.device_get(
            (
                compute_margins(cand_w, chunk),
                compute_margins(par_w, chunk),
                chunk.labels,
                chunk.weights,
            )
        )
