"""Evaluation task runner (port of ``diffuncertainty_tpu/evaln/runner.py``,
the reference's ``EvalExperiments`` over one split).

A run is a function over one results split dir (plus optional paired/val
dirs); ``EvalRunner`` sequences tasks and skips finished outputs;
``run_default_evaluation`` is the standard task chain the inference job runs
with ``--include_eval`` (threshold -> area -> aggregation -> failure ->
ambiguity).

The threshold task writes ``threshold_analysis.json`` to the version
directory, the parent of the split, as the JAX runner does: under
``skip_finished`` the first split's thresholds serve every later split of
the job.
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..core.config import ExperimentConfig
from ..data.dataset import MultiRaterDataset
from .aggregation import aggregate_uncertainties, compute_prediction_shape_stats, find_threshold
from .dataloader import ResultsReader
from .tasks import ambiguity_modeling, calibration, failure_detection, ood_detection_paired

_TASK_OUTPUTS = {
    "threshold": "threshold_analysis.json",  # in exp (version) dir
    "area": "area.json",
    "aggregation": "aggregated_TU.json",
    "failure_detection": "failure_detection.json",
    "ambiguity_modeling": "ambiguity_modeling.json",
    "calibration": "calibration.json",
}


class EvalRunner:
    def __init__(
        self,
        split_dir: str | Path,
        dataset: MultiRaterDataset | None = None,
        val_split_dir: str | Path | None = None,
        val_dataset: MultiRaterDataset | None = None,
        ignore_value=None,
        skip_finished: bool = True,
    ):
        self.reader = ResultsReader(split_dir, dataset)
        self.val_reader = ResultsReader(val_split_dir, val_dataset) if val_split_dir else None
        self.ignore_value = ignore_value
        self.skip_finished = skip_finished

    def _finished(self, task: str) -> bool:
        if not self.skip_finished:
            return False
        out = _TASK_OUTPUTS.get(task)
        if out is None:
            return False
        base = self.reader.split_dir.parent if task == "threshold" else self.reader.split_dir
        return (base / out).exists()

    def run(self, tasks: list[str]) -> dict:
        summary = {}
        for task in tasks:
            if self._finished(task):
                summary[task] = "skipped (finished)"
                continue
            if task == "threshold":
                find_threshold([self.reader], self.reader.split_dir.parent)
            elif task == "area":
                compute_prediction_shape_stats(self.reader)
            elif task == "aggregation":
                aggregate_uncertainties(self.reader)
            elif task == "failure_detection":
                failure_detection(self.reader, self.reader.split_dir / "failure_detection.json")
            elif task == "ambiguity_modeling":
                ambiguity_modeling(self.reader)
            elif task == "calibration":
                calibration(self.reader, self.val_reader, ignore_value=self.ignore_value)
            else:
                raise ValueError(f"Unknown eval task '{task}'")
            summary[task] = "done"
        return summary


DEFAULT_TASKS = ["threshold", "area", "aggregation", "failure_detection", "ambiguity_modeling"]


def run_default_evaluation(split_dir: str | Path, cfg: ExperimentConfig) -> dict:
    """Standard chain after testing (the reference's ``--include_eval``).
    Without the split's dataset (no splits file, no such split) the chain
    runs without ``ambiguity_modeling``, which needs the raters; the reason
    goes to stderr."""
    data_dir = Path(cfg.data.data_input_dir)
    split_name = Path(split_dir).name
    dataset = None
    try:
        splits_path = cfg.data.splits_path or (
            data_dir / "splits" / cfg.data.split_name / "firstCycle" / "splits.pkl")
        dataset = MultiRaterDataset(splits_path, data_dir, split=split_name)
    except Exception as err:  # the JAX chain runs on without any dataset it cannot build
        print(f"evaluation of {split_dir}: no dataset ({type(err).__name__}: {err}); "
              f"ambiguity_modeling is left out", file=sys.stderr)
    runner = EvalRunner(split_dir, dataset,
                        ignore_value=cfg.data.ignore_index if cfg.data.ignore_index != 0 else None)
    tasks = list(DEFAULT_TASKS)
    if dataset is None:
        tasks.remove("ambiguity_modeling")
    return runner.run(tasks)


def run_ood_detection(
    id_split_dir: str | Path, ood_split_dir: str | Path, out_path: str | Path | None = None
) -> dict:
    """Paired OoD detection over two evaluated splits."""
    id_reader = ResultsReader(id_split_dir)
    ood_reader = ResultsReader(ood_split_dir)
    out_path = out_path or (Path(id_split_dir).parent / "ood_detection.json")
    key = f"{Path(id_split_dir).name}&{Path(ood_split_dir).name}"
    return ood_detection_paired(id_reader, ood_reader, out_path, dataset_key=key)
