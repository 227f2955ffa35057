"""Downstream-task evaluation (port of ``diffuncertainty_tpu/evaln``):
aggregation, OoD, failure, calibration, ambiguity, active learning — over
the results-on-disk contract, on the host with numpy and scipy."""

from .dataloader import ResultsReader
from .aggregation import (
    image_level_aggregation,
    patch_level_aggregation,
    threshold_aggregation,
    area_normalized_aggregation,
    border_normalized_aggregation,
    aggregate_uncertainties,
    compute_prediction_shape_stats,
)
from .runner import EvalRunner, run_default_evaluation
from .experiments import (
    EvalMatrix,
    ExperimentVersion,
    expand_versions,
    write_matrix_report,
)

__all__ = [
    "EvalMatrix",
    "ExperimentVersion",
    "expand_versions",
    "write_matrix_report",
    "ResultsReader",
    "image_level_aggregation",
    "patch_level_aggregation",
    "threshold_aggregation",
    "area_normalized_aggregation",
    "border_normalized_aggregation",
    "aggregate_uncertainties",
    "compute_prediction_shape_stats",
    "EvalRunner",
    "run_default_evaluation",
]
