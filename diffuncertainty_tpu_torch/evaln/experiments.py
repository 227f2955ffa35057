"""Evaluation version-matrix orchestration (port of
``diffuncertainty_tpu/evaln/experiments.py``, the reference's ``EvalExperiments``).

The reference expands ``iter_params`` cartesian products into
``ExperimentVersion`` objects, preflight-classifies the whole matrix as
missing/finished, runs per-version and accumulated (map-reduce) tasks over
it, and cleans bulky heatmap folders afterwards
(``evaluation/eval_experiments.py:25-465``, ``experiment_version.py:5-70``).

This module is that layer over the repo's results-tree contract:

- ``ExperimentVersion`` — experiment identity: format-template naming
  (``exp_name``/``naming_scheme_version``) over a parameter dict (seed,
  epoch, ema, shift, ...) mapping to
  ``base_path/{exp_name}/test_results{n_pred}/{version_name}`` with dataset
  split dirs discovered underneath (``experiment_version.py:36-70``);
- ``expand_versions`` — ``iter_params`` cartesian expansion with
  per-``pred_model`` overrides (``eval_experiments.py:51-116``);
- ``EvalMatrix`` — preflight missing/finished classification
  (``:171-268``), per-version tasks (area/aggregation/failure/ambiguity/
  calibration), accumulated tasks (threshold pools quantiles across a
  version's split dirs then writes per-version analysis files,
  ``find_threshold.py:15-113``), paired OoD detection, and
  ``cleanup``/``cleanup_finished`` (``:404-465``).

Tasks are plain Python callables over ``ResultsReader``s — no hydra
instantiation layer; the task registry below is the fixed ValUES task set.

The command line reads its config without a YAML library
(:func:`read_config`): JSON, or the block YAML that ``yaml.safe_dump``
writes.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from collections import Counter
from itertools import product
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

from ..core.config import parse_scalar
from ..data.dataset import MultiRaterDataset
from .aggregation import (
    DEFAULT_AGGREGATIONS,
    aggregate_uncertainties,
    compute_prediction_shape_stats,
    find_threshold,
)
from .dataloader import ResultsReader
from .tasks import (
    ambiguity_modeling,
    calibration,
    failure_detection,
    ood_detection_paired,
)

KNOWN_TASKS = (
    "threshold",
    "area",
    "aggregation",
    "ood_detection",
    "failure_detection",
    "ambiguity_modeling",
    "calibration",
    "cleanup",
    "cleanup_finished",
)

_HEATMAP_DIRS = ("TU", "AU", "EU", "pred_seg")


@dataclasses.dataclass(frozen=True)
class ExperimentVersion:
    """One cell of the evaluation matrix (``experiment_version.py:5-70``).

    ``exp_name`` and ``naming_scheme_version`` are format templates over
    ``pred_model`` plus every key in ``params`` (e.g.
    ``"{pred_model}_s{seed}/e{epoch}{ema}"`` — the version name may contain
    path separators, like the reference's version/epoch nesting).
    """

    base_path: Path
    pred_model: str = "none"
    exp_name: str = "{pred_model}"
    naming_scheme_version: str = "version_{seed}"
    n_pred: int | None = None
    unc_types: tuple[str, ...] = ("TU", "AU", "EU")
    aggregations: tuple[str, ...] = tuple(DEFAULT_AGGREGATIONS)
    skip_missing: bool = False
    skip_finished: bool = False
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def results_dir(self) -> str:
        # the reference's test_results{n_pred} convention with the n_pred=10
        # default collapsed (``experiment_version.py:63-70``); this repo's
        # writer always suffixes, so keep the suffix when n_pred is given
        if self.n_pred is None:
            return "test_results"
        return f"test_results{int(self.n_pred)}"

    @property
    def version_name(self) -> str:
        return self.naming_scheme_version.format(pred_model=self.pred_model, **self.params)

    @property
    def exp_path(self) -> Path:
        return (
            Path(self.base_path)
            / self.exp_name.format(pred_model=self.pred_model, **self.params)
            / self.results_dir
            / self.version_name
        )

    def split_dirs(self) -> list[Path]:
        """Dataset split dirs under this version (``eval_experiments.py:128-141``):
        children carrying metrics.json, else the version dir itself if it does."""
        exp_path = self.exp_path
        if not exp_path.exists():
            return []
        children = sorted(p for p in exp_path.iterdir() if p.is_dir())
        with_metrics = [p for p in children if (p / "metrics.json").is_file()]
        if with_metrics:
            return with_metrics
        if (exp_path / "metrics.json").is_file():
            return [exp_path]
        return []

    def label(self) -> str:
        return f"{self.exp_name.format(pred_model=self.pred_model, **self.params)}/{self.version_name}"


_VERSION_FIELDS = {
    f.name for f in dataclasses.fields(ExperimentVersion) if f.name != "params"
}


def expand_versions(
    base_path: str | Path,
    experiments: Sequence[Mapping[str, Any]],
    **defaults: Any,
) -> list[ExperimentVersion]:
    """Cartesian ``iter_params`` expansion (``eval_experiments.py:51-116``).

    Each experiment mapping carries:

    - ``iter_params``: ``{key: [values...]}`` — the product axes (typically
      ``pred_model``, ``seed``, ``epoch``, ``ema``, ``shift``);
    - ``prediction_models``: optional per-``pred_model`` override mappings
      merged into matching cells (naming schemes, unc_types, ...);
    - any other key: fixed for every cell (``exp_name``,
      ``naming_scheme_version``, ``n_pred``, ``skip_*``, extra name params).

    ``only_pu: True`` restricts ``unc_types`` to ``("TU",)``
    (``eval_experiments.py:101-113``). ``defaults`` apply under every
    experiment's own keys.
    """
    versions: list[ExperimentVersion] = []
    for experiment in experiments:
        experiment = {**defaults, **experiment}
        iter_params = dict(experiment.pop("iter_params", {}))
        pred_model_overrides = dict(experiment.pop("prediction_models", {}) or {})
        axes = [[(k, v) for v in values] for k, values in iter_params.items()]
        for cell in product(*axes):
            cell_params: dict[str, Any] = dict(experiment)
            cell_params.update(dict(cell))
            pm = str(cell_params.get("pred_model", "none"))
            if pm in pred_model_overrides:
                cell_params.update(dict(pred_model_overrides[pm]))
            if cell_params.pop("only_pu", False):
                cell_params["unc_types"] = ("TU",)
            fields = {
                k: cell_params.pop(k) for k in list(cell_params) if k in _VERSION_FIELDS
            }
            fields.pop("base_path", None)
            fields.pop("params", None)
            for tup_key in ("unc_types", "aggregations"):
                if tup_key in fields:
                    fields[tup_key] = tuple(fields[tup_key])
            versions.append(
                ExperimentVersion(
                    base_path=Path(base_path), params=cell_params, **fields
                )
            )
    return versions


class EvalMatrix:
    """Run the ValUES task set over a version matrix.

    ``dataset_factory(version, split_name)`` returns the GT dataset a task
    needs (ambiguity/calibration) or None — the reference's
    ``datamodule_config`` equivalent without the hydra indirection.
    ``paired_splits`` are ``(id_split, ood_split)`` name pairs for OoD
    detection; ``calibration_val_split`` names the split whose reader fits
    the Platt parameters (and which the per-split calibration pass skips,
    matching the reference's val-excluded task coverage).
    """

    def __init__(
        self,
        versions: Sequence[ExperimentVersion],
        *,
        dataset_factory: Callable[[ExperimentVersion, str], Any] | None = None,
        paired_splits: Sequence[tuple[str, str]] = (),
        calibration_val_split: str = "val",
        ignore_value=None,
        log: Callable[[str], None] = print,
    ):
        self.versions = list(versions)
        self.dataset_factory = dataset_factory
        self.paired_splits = [tuple(p) for p in paired_splits]
        self.calibration_val_split = calibration_val_split
        self.ignore_value = ignore_value
        self.log = log
        self._status: dict[str, dict] = {}

    # ---- preflight (eval_experiments.py:171-268) ---------------------------

    def _is_missing(self, version: ExperimentVersion) -> bool:
        split_dirs = version.split_dirs()
        if not split_dirs:
            return True
        required = ["pred_seg", *version.unc_types]
        return any(
            not (d / folder).is_dir() for d in split_dirs for folder in required
        )

    def _eval_split_dirs(self, version: ExperimentVersion, task: str) -> list[Path]:
        """Split dirs a per-version task is expected to cover. Calibration
        excludes the Platt-fit val split; everything else covers all."""
        dirs = version.split_dirs()
        if task == "calibration":
            dirs = [d for d in dirs if d.name != self.calibration_val_split]
        return dirs

    def _is_finished(self, version: ExperimentVersion, tasks: Sequence[str]) -> bool:
        exp_path = version.exp_path
        if not exp_path.exists():
            return False
        if "threshold" in tasks:
            for name in ("quantile_analysis.json", "threshold_analysis.json"):
                if not (exp_path / name).is_file():
                    return False
        if "ood_detection" in tasks and self.paired_splits:
            if not (exp_path / "ood_detection.json").is_file():
                return False
        per_split = {
            "area": "area.json",
            "failure_detection": "failure_detection.json",
            "ambiguity_modeling": "ambiguity_modeling.json",
            "calibration": "calibration.json",
        }
        for task, out_name in per_split.items():
            if task not in tasks:
                continue
            dirs = self._eval_split_dirs(version, task)
            if not dirs or any(not (d / out_name).is_file() for d in dirs):
                return False
        if "aggregation" in tasks:
            dirs = self._eval_split_dirs(version, "aggregation")
            if not dirs:
                return False
            for d in dirs:
                for unc in version.unc_types:
                    if not (d / f"aggregated_{unc}.json").is_file():
                        return False
        return True

    def classify(self, tasks: Sequence[str] = KNOWN_TASKS) -> dict[str, dict]:
        tasks = [t for t in tasks if t not in ("cleanup", "cleanup_finished")]
        statuses = {}
        for v in self.versions:
            statuses[v.exp_path.as_posix()] = {
                "missing": self._is_missing(v),
                "finished": self._is_finished(v, tasks),
                "skip_missing": v.skip_missing,
                "skip_finished": v.skip_finished,
            }
        self._status = statuses
        return statuses

    def status_summary(self) -> str:
        """The reference's preflight missing x finished matrix
        (``eval_experiments.py:237-268``)."""
        counter = Counter(
            (s["missing"], s["finished"]) for s in self._status.values()
        )
        total = len(self._status)
        missing = sum(1 for s in self._status.values() if s["missing"])
        finished = sum(1 for s in self._status.values() if s["finished"])
        lines = [
            "Preflight version status summary",
            f"- Missing: {missing} | Not missing: {total - missing} | Total: {total}",
            f"- Finished: {finished} | Unfinished: {total - finished} | Total: {total}",
            "- Missing x Finished matrix (rows=missing, cols=finished)",
            "                 finished=False  finished=True",
            f"missing=False      {counter[(False, False)]:>6}         {counter[(False, True)]:>6}",
            f"missing=True       {counter[(True, False)]:>6}         {counter[(True, True)]:>6}",
        ]
        return "\n".join(lines)

    def _should_skip(self, version: ExperimentVersion) -> bool:
        status = self._status.get(version.exp_path.as_posix())
        if status is None:
            return False
        return (status["skip_missing"] and status["missing"]) or (
            status["skip_finished"] and status["finished"]
        )

    # ---- task execution ----------------------------------------------------

    def _reader(self, version: ExperimentVersion, split_dir: Path) -> ResultsReader:
        ds = (
            self.dataset_factory(version, split_dir.name)
            if self.dataset_factory is not None
            else None
        )
        return ResultsReader(split_dir, ds)

    def _run_threshold(self, version: ExperimentVersion) -> None:
        # accumulated across the version's split dirs: quantiles pool over
        # every split, analysis files land per-version (find_threshold.py)
        readers = [ResultsReader(d) for d in version.split_dirs()]
        if readers:
            find_threshold(readers, version.exp_path, pred_model=version.pred_model)

    def _run_ood_detection(self, version: ExperimentVersion) -> None:
        by_name = {d.name: d for d in version.split_dirs()}
        out = version.exp_path / "ood_detection.json"
        for id_split, ood_split in self.paired_splits:
            if id_split not in by_name or ood_split not in by_name:
                continue
            ood_detection_paired(
                ResultsReader(by_name[id_split]),
                ResultsReader(by_name[ood_split]),
                out,
                dataset_key=f"{id_split}&{ood_split}",
            )

    def _run_per_split(self, version: ExperimentVersion, task: str) -> None:
        val_reader = None
        if task == "calibration":
            val_dir = version.exp_path / self.calibration_val_split
            if val_dir.is_dir():
                val_reader = self._reader(version, val_dir)
        for split_dir in self._eval_split_dirs(version, task):
            reader = self._reader(version, split_dir)
            if task == "area":
                compute_prediction_shape_stats(reader)
            elif task == "aggregation":
                aggregate_uncertainties(reader, aggregations=version.aggregations)
            elif task == "failure_detection":
                failure_detection(reader, split_dir / "failure_detection.json")
            elif task == "ambiguity_modeling":
                ambiguity_modeling(reader)
            elif task == "calibration":
                calibration(reader, val_reader, ignore_value=self.ignore_value)
            else:  # pragma: no cover - guarded by KNOWN_TASKS
                raise ValueError(f"unknown per-split task '{task}'")

    def run(self, tasks: Sequence[str]) -> dict[str, str]:
        unknown = [t for t in tasks if t not in KNOWN_TASKS]
        if unknown:
            raise ValueError(f"unknown eval tasks {unknown}; known: {KNOWN_TASKS}")
        statuses = self.classify(tasks)
        self.log(self.status_summary())
        # a missing version without skip_missing is a configuration error —
        # running "successfully" over zero split dirs hides typos in the
        # naming scheme (the reference likewise raises from split discovery,
        # eval_experiments.py:295-325)
        unskippable = [
            v.label() for v in self.versions
            if statuses[v.exp_path.as_posix()]["missing"] and not v.skip_missing
        ]
        if unskippable:
            raise FileNotFoundError(
                f"{len(unskippable)} version(s) have no evaluable results "
                f"(set skip_missing=True to skip them): {unskippable[:5]}"
            )
        summary: dict[str, str] = {}
        for task in tasks:
            self.log(f"ANALYSING TASK: {task}")
            if task == "cleanup":
                self.cleanup()
            elif task == "cleanup_finished":
                self.cleanup(only_finished=True, tasks=tasks)
            else:
                for version in self.versions:
                    if self._should_skip(version):
                        continue
                    if task == "threshold":
                        self._run_threshold(version)
                    elif task == "ood_detection":
                        self._run_ood_detection(version)
                    else:
                        self._run_per_split(version, task)
            summary[task] = "done"
        return summary

    # ---- cleanup (eval_experiments.py:404-465) ------------------------------

    def cleanup(
        self, only_finished: bool = False, tasks: Sequence[str] = KNOWN_TASKS
    ) -> list[str]:
        """Delete bulky heatmap/prediction folders (TU/AU/EU/pred_seg) under
        every version's split dirs; JSON artifacts stay."""
        check_tasks = [t for t in tasks if t not in ("cleanup", "cleanup_finished")]
        removed = []
        for version in self.versions:
            if not version.exp_path.exists():
                continue
            if only_finished and not self._is_finished(version, check_tasks):
                self.log(f"Skipping unfinished version: {version.exp_path}")
                continue
            dirs = version.split_dirs() or [version.exp_path]
            for d in dirs:
                for sub in _HEATMAP_DIRS:
                    target = d / sub
                    if target.is_dir():
                        shutil.rmtree(target)
                        removed.append(target.as_posix())
        return removed


def write_matrix_report(matrix: EvalMatrix, out_path: str | Path) -> dict:
    """Persist the preflight classification (the reference prints it only)."""
    statuses = matrix.classify()
    report = {
        "versions": statuses,
        "summary": matrix.status_summary(),
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2))
    return report


def matrix_from_config(config: Mapping[str, Any]) -> tuple[EvalMatrix, list[str]]:
    """Build an EvalMatrix + task list from a config mapping (the CLI input;
    the reference's hydra ``eval_config_*.yaml`` equivalent).

    Keys: ``base_path``, ``experiments`` (list with ``iter_params``), ``tasks``,
    ``paired_splits``, ``calibration_val_split``, ``ignore_value``, and an
    optional ``dataset: {splits_path, data_input_dir}`` giving GT access for
    ambiguity/calibration (split name taken from each results split dir).
    """
    versions = expand_versions(Path(config["base_path"]), config["experiments"])
    dataset_factory = None
    ds_cfg = config.get("dataset")
    if ds_cfg:
        def dataset_factory(version, split):  # noqa: F811
            try:
                return MultiRaterDataset(
                    ds_cfg["splits_path"], ds_cfg["data_input_dir"], split=split
                )
            except Exception:
                return None

    matrix = EvalMatrix(
        versions,
        dataset_factory=dataset_factory,
        paired_splits=[tuple(p) for p in config.get("paired_splits", [])],
        calibration_val_split=config.get("calibration_val_split", "val"),
        ignore_value=config.get("ignore_value"),
    )
    # default task list excludes BOTH cleanup variants: deleting heatmap /
    # prediction folders must be an explicit opt-in, never a missing-key default
    tasks = list(config.get(
        "tasks", [t for t in KNOWN_TASKS if t not in ("cleanup", "cleanup_finished")]
    ))
    return matrix, tasks


# --------------------------------------------------------------------------
# the config file, without a YAML library
# --------------------------------------------------------------------------

def read_config(text: str) -> Any:
    """A config file's value: JSON, or block YAML as ``yaml.safe_dump`` writes
    it (nested mappings, ``- `` sequences, also at their key's indent, flow
    lists, plain scalars read by :func:`parse_scalar`, single- and
    double-quoted strings, ``{}``, comment lines). Anything else (anchors,
    tags, block scalars, flow mappings, continued lines, tabs) raises a
    ``ValueError`` that names the line."""
    stripped = text.strip()
    if stripped.startswith("{"):
        try:
            return json.loads(stripped)
        except json.JSONDecodeError as err:
            raise ValueError(f"config: not JSON, and flow mappings are not read: {err}") from None
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip()
        content = body.lstrip(" ")
        if not content or content.startswith("#") or content in ("---", "..."):
            continue
        if content.startswith("\t"):
            raise ValueError(f"config line {n}: tabs are not read as indentation")
        lines.append((n, len(body) - len(content), content))
    if not lines:
        return None
    value, pos = _yaml_block(lines, 0, lines[0][1])
    if pos != len(lines):
        n, _, content = lines[pos]
        raise ValueError(f"config line {n}: unexpected {content!r} (continued lines, "
                         f"flow mappings and other YAML forms are not read)")
    return value


def _yaml_block(lines: list, pos: int, indent: int) -> tuple[Any, int]:
    """The mapping or sequence whose entries start at column ``indent``."""
    if _is_item(lines[pos][2]):
        return _yaml_sequence(lines, pos, indent)
    return _yaml_mapping(lines, pos, indent)


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _yaml_sequence(lines: list, pos: int, indent: int) -> tuple[list, int]:
    items = []
    while pos < len(lines) and lines[pos][1] == indent and _is_item(lines[pos][2]):
        n, _, content = lines[pos]
        rest = content[1:].lstrip(" ")
        if not rest:  # the item's block follows, further in
            if pos + 1 < len(lines) and lines[pos + 1][1] > indent:
                item, pos = _yaml_block(lines, pos + 1, lines[pos + 1][1])
            else:
                item, pos = None, pos + 1
        elif _is_item(rest) or _key_value(rest) is not None:
            # a nested sequence or mapping that starts on the item's line:
            # its entries sit at the column of its first
            column = indent + len(content) - len(rest)
            lines = lines[:pos] + [(n, column, rest)] + lines[pos + 1:]
            item, pos = _yaml_block(lines, pos, column)
        else:
            item, pos = _yaml_scalar(rest, n), pos + 1
        items.append(item)
    return items, pos


def _yaml_mapping(lines: list, pos: int, indent: int) -> tuple[dict, int]:
    mapping: dict = {}
    while pos < len(lines) and lines[pos][1] == indent and not _is_item(lines[pos][2]):
        n, _, content = lines[pos]
        kv = _key_value(content)
        if kv is None:
            raise ValueError(f"config line {n}: expected 'key: value', got {content!r}")
        key, rest = kv
        key = _yaml_scalar(key, n)
        if key in mapping:
            raise ValueError(f"config line {n}: duplicate key {key!r}")
        pos += 1
        if rest:
            mapping[key] = _yaml_scalar(rest, n)
        elif pos < len(lines) and (lines[pos][1] > indent
                                   or (lines[pos][1] == indent and _is_item(lines[pos][2]))):
            mapping[key], pos = _yaml_block(lines, pos, lines[pos][1])
        else:
            mapping[key] = None
    return mapping, pos


def _key_value(content: str) -> tuple[str, str] | None:
    """(key, rest) of a ``key: value`` or ``key:`` line; None otherwise."""
    if content[:1] in "'\"":
        end = content.find(content[0], 1)
        while end != -1 and content[0] == "'" and content[end + 1:end + 2] == "'":
            end = content.find("'", end + 2)  # '' inside a single-quoted key
        if end == -1 or not content[end + 1:].startswith(":"):
            return None
        split = end + 1
    else:
        split = content.find(": ")
        if split == -1:
            if not content.endswith(":"):
                return None
            split = len(content) - 1
    if content[split + 1:split + 2] not in ("", " "):
        return None
    return content[:split], content[split + 1:].strip()


def _yaml_scalar(text: str, n: int) -> Any:
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise ValueError(f"config line {n}: unterminated quoted string {text!r}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            raise ValueError(f"config line {n}: a double-quoted string with escapes JSON "
                             f"does not read: {text!r}") from None
    comment = text.find(" #")
    if comment != -1:
        text = text[:comment].rstrip()
    if text == "{}":
        return {}
    if text[:1] in "{&*!|>%@`":
        raise ValueError(f"config line {n}: {text!r} is a YAML form this reader does not "
                         f"take (flow mapping, anchor, alias, tag or block scalar)")
    return parse_scalar(text)


def main(argv: Sequence[str] | None = None) -> dict:
    """CLI: run the evaluation matrix from a YAML or JSON config — the
    reference's ``python evaluation/eval_experiments.py --config-name
    eval_config_lidc`` (``eval_experiments.py:458-465``) without the hydra
    layer.

        python -m diffuncertainty_tpu_torch.evaln.experiments --config eval.yaml \\
            [--preflight-only] [--report report.json]
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--preflight-only", action="store_true",
                    help="classify + print the missing/finished matrix, run nothing")
    ap.add_argument("--report", default=None,
                    help="also write the preflight report JSON here")
    args = ap.parse_args(argv)
    config = read_config(Path(args.config).read_text())
    matrix, tasks = matrix_from_config(config)
    if args.report:
        write_matrix_report(matrix, args.report)
    if args.preflight_only:
        matrix.classify(tasks)
        print(matrix.status_summary())
        return {}
    return matrix.run(tasks)


if __name__ == "__main__":
    main()
