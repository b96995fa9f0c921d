"""Optimizers: L-BFGS, OWL-QN and TRON over a vector or a ``[G, d]`` bank
(port of ``photon_ml_tpu/optim``; see the modules for the reference's
citations).

The names below load their module on first use."""

import importlib

_EXPORTS = {
    "common": (
        "BoxConstraints", "CONVERGENCE_REASON_NAMES", "FUNCTION_VALUES_WITHIN_TOLERANCE",
        "GRADIENT_WITHIN_TOLERANCE", "LINE_SEARCH_STALLED", "MAX_ITERATIONS",
        "NOT_CONVERGED", "OptResult", "Tracker", "project_coefficients_to_hypercube",
    ),
    "config": (
        "GLMOptimizationConfiguration", "OptimizerConfig", "OptimizerType",
        "RegularizationContext", "RegularizationType",
    ),
    "factory": ("make_optimizer", "validate_optimizer_choice"),
    "lbfgs": ("minimize_lbfgs", "minimize_owlqn"),
    "tron": ("minimize_tron",),
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
