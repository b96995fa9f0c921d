"""Evaluation: metrics on the device, evaluator types, model selection
(port of ``photon_ml_tpu/evaluation``).

The names below load their module on first use."""

import importlib

_EXPORTS = {
    "evaluator": ("Evaluator", "EvaluatorType", "select_best_model"),
    "metrics": (
        "akaike_information_criterion", "area_under_precision_recall_curve",
        "area_under_roc_curve", "f1_score", "mean_pointwise_loss", "precision_at_k",
        "root_mean_squared_error", "sharded_auc", "sharded_precision_at_k",
        "total_pointwise_loss",
    ),
    "streaming": (
        "StreamingAUC", "StreamingMeanLoss", "StreamingRMSE", "finalize_metrics",
        "glm_streaming_metrics", "update_glm_metrics",
    ),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
