"""Model diagnostics and their HTML report (port of
``photon_ml_tpu/diagnostics``)."""

from photon_ml_tpu_torch.diagnostics.diagnostics import (
    BootstrapReport,
    FeatureImportanceReport,
    FittingReport,
    HosmerLemeshowReport,
    KendallTauReport,
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
    render_html,
    render_text,
    write_html_report,
    write_text_report,
)

__all__ = [
    "BootstrapReport",
    "FeatureImportanceReport",
    "FittingReport",
    "HosmerLemeshowReport",
    "KendallTauReport",
    "bootstrap_training_diagnostic",
    "feature_importance_diagnostic",
    "fitting_diagnostic",
    "hosmer_lemeshow_diagnostic",
    "kendall_tau_diagnostic",
    "Chapter",
    "Document",
    "LinePlot",
    "Section",
    "Table",
    "Text",
    "render_html",
    "render_text",
    "write_html_report",
    "write_text_report",
]
