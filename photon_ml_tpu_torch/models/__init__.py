"""Model classes: GLM coefficients and per-family wrappers (port of
``photon_ml_tpu/models``; GAME models live in ``photon_ml_tpu_torch.game``).

The names below load their module on first use."""

import importlib

_EXPORTS = {
    "coefficients": ("CoefficientSummary", "Coefficients"),
    "glm": (
        "GeneralizedLinearModel", "compute_margins", "compute_means", "compute_scores",
        "create_model", "linear_regression_model", "logistic_regression_model",
        "poisson_regression_model", "smoothed_hinge_svm_model",
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
