"""Result tables, charts and panels (port of ``diffuncertainty_tpu/evaln/visualization.py``),
without pandas or matplotlib: numpy and scipy only.

The tables. ``collect_results`` walks the task JSONs each version produced
into tidy rows: a list of dicts with the JAX frame's columns (``task,
unc_type, aggregation, metric, value, dataset, version``). ``pivot`` is the
pandas ``pivot_table`` the JAX functions call (``dropna``: a cell whose
aggregate is NaN is left out; rows and columns sorted; ``std`` the sample
std, ddof 1) and returns a :class:`Table`, whose ``to_csv`` writes the text
``DataFrame.to_csv`` writes: the column levels' header rows, the index
names' row, the values as ``repr`` and an empty field for a missing cell.

The figures. Where the JAX package draws with matplotlib, the port writes
what was drawn:

- a chart (``barplot``, ``metric_matrix(_grid)``, ``au_eu_scatter``,
  ``scatter_grid``, ``plot_training_curves``, ``ood_shift_panel``,
  ``al_improvement_plot``, ``risk_coverage_plot``, ``reliability_diagram``)
  writes the series the JAX function passes to ``plot``, ``bar``,
  ``scatter`` or ``imshow`` as JSON, next to the path the JAX function
  would have written, with ``.json`` in place of the suffix (NaN as null),
  and returns that path;
- an image panel (``dataset_overview_panel``, ``grouped_rows_panel``,
  ``uncertainty_triptych_panel``, ``model_comparison_panel``,
  ``uncertainty_panel``, ``plot_prediction_grid``, ``plot_tta_augs``)
  writes one RGB PNG (``infer/image_io.py``) at the path given: the arrays
  the JAX function shows, each where its axes sit in the figure's grid
  (``panel_canvas``), a 2-D array in gray scaled from the JAX call's
  vmin/vmax (its own min and max where the call gives none), an RGB array
  as it is.

Titles, legends, colormaps and the overview's arrow are not drawn (a
deliberate difference: the card's host has no plotting package).
``load_tfevents_curves`` needs tensorboard, which that host lacks, and
raises; the port's trainer writes the ``metrics.jsonl`` that
``load_training_curves`` reads.
"""

from __future__ import annotations

import csv
import io
import json
import re
from pathlib import Path
from typing import Sequence

import numpy as np

_TASK_FILES = {
    "failure_detection": "failure_detection.json",
    "ood_detection": "ood_detection.json",
    "calibration": "calibration.json",
    "ambiguity_modeling": "ambiguity_modeling.json",
}


def _flatten_task(task: str, payload: dict) -> list[dict]:
    rows = []
    if task == "ood_detection":
        for dataset_key, body in payload.items():
            for unc, aggs in body.get("mean", {}).items():
                for agg, rec in aggs.items():
                    for metric, value in rec["metrics"].items():
                        rows.append(dict(task=task, unc_type=unc, aggregation=agg,
                                         metric=metric, value=value, dataset=dataset_key))
    elif task == "calibration" or task == "ambiguity_modeling":
        for unc, rec in payload.get("mean", {}).items():
            for metric, value in rec["metrics"].items():
                rows.append(dict(task=task, unc_type=unc, aggregation="-",
                                 metric=metric, value=value, dataset="-"))
    elif task == "failure_detection":
        for unc, aggs in payload.get("mean", {}).items():
            for agg, rec in aggs.items():
                for metric, value in rec["metrics"].items():
                    rows.append(dict(task=task, unc_type=unc, aggregation=agg,
                                     metric=metric, value=value, dataset="-"))
    return rows


def collect_results(
    versions: dict[str, str | Path],
    *,
    include_segmentation: bool = True,
) -> list[dict]:
    """{version_name: split_dir} -> tidy rows of all task metrics."""
    rows = []
    for version, split_dir in versions.items():
        split_dir = Path(split_dir)
        for task, fname in _TASK_FILES.items():
            path = split_dir / fname
            if not path.exists():
                continue
            for row in _flatten_task(task, json.loads(path.read_text())):
                row["version"] = version
                rows.append(row)
        if include_segmentation and (split_dir / "metrics.json").exists():
            metrics = json.loads((split_dir / "metrics.json").read_text())
            per_metric: dict[str, list[float]] = {}
            for rec in metrics.values():
                for metric, value in rec.get("metrics", {}).items():
                    per_metric.setdefault(metric, []).append(value)
            for metric, values in per_metric.items():
                rows.append(dict(task="segmentation", unc_type="-", aggregation="-",
                                 metric=metric, value=float(np.mean(values)),
                                 dataset="-", version=version))
    return rows


# --------------------------------------------------------------------------
# the pivot (pandas pivot_table with dropna) and its table
# --------------------------------------------------------------------------

def _finite_values(values) -> np.ndarray:
    """The values pandas keeps when it skips missing ones (None and NaN)."""
    vals = np.array([np.nan if v is None else float(v) for v in values], np.float64)
    return vals[~np.isnan(vals)]


def nan_mean(values) -> float:
    """``Series.mean()``: the mean of the non-missing values, NaN if none."""
    vals = _finite_values(values)
    return float(vals.mean()) if vals.size else float("nan")


def nan_std(values) -> float:
    """``Series.std()``: the sample std (ddof 1) of the non-missing values,
    NaN for fewer than two."""
    vals = _finite_values(values)
    return float(vals.std(ddof=1)) if vals.size > 1 else float("nan")


_AGGREGATES = {"mean": nan_mean, "std": nan_std}


class Table:
    """A pivot: ``index`` (tuples, one entry per index level) x ``columns``
    (strings, or ``(aggfunc, key)`` tuples for a two-level header), its
    ``values`` a float array with NaN where a cell is missing."""

    def __init__(self, index_names: Sequence[str | None], index: list[tuple],
                 columns: list, values: np.ndarray,
                 column_names: Sequence[str | None] = (None,)):
        self.index_names = tuple(index_names)
        self.index = list(index)
        self.columns = list(columns)
        self.values = np.asarray(values, np.float64).reshape(len(self.index), len(self.columns))
        self.column_names = tuple(column_names)

    @property
    def shape(self) -> tuple[int, int]:
        return self.values.shape

    @property
    def column_levels(self) -> int:
        return len(self.column_names)

    def __getitem__(self, aggfunc: str) -> "Table":
        """The one-level table of one aggfunc's columns (``table["mean"]``)."""
        keep = [i for i, c in enumerate(self.columns) if c[0] == aggfunc]
        if self.column_levels != 2 or not keep:
            raise KeyError(aggfunc)
        return Table(self.index_names, self.index, [self.columns[i][1] for i in keep],
                     self.values[:, keep], self.column_names[1:])

    def has_aggfunc(self, aggfunc: str) -> bool:
        return self.column_levels == 2 and any(c[0] == aggfunc for c in self.columns)

    def column(self, key) -> np.ndarray:
        return self.values[:, self.columns.index(key)]

    def row_keys(self) -> list:
        """The index entries as pandas gives them: scalars for one level."""
        return [i[0] for i in self.index] if len(self.index_names) == 1 else list(self.index)

    def to_csv(self, path: str | Path | None = None) -> str:
        """The text ``DataFrame.to_csv`` writes for this pivot; written to
        ``path`` when given."""
        n_index = len(self.index_names)
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        levels = ([[c[k] for c in self.columns] for k in range(self.column_levels)]
                  if self.column_levels > 1 else [self.columns])
        for k, level in enumerate(levels):
            name = self.column_names[k] if self.column_levels > 1 else None
            w.writerow([name or ""] + [""] * (n_index - 1) + [str(x) for x in level])
        if any(n is not None for n in self.index_names):
            w.writerow([n or "" for n in self.index_names] + [""] * len(self.columns))
        for key, row in zip(self.index, self.values):
            w.writerow([str(x) for x in key]
                       + ["" if np.isnan(v) else repr(float(v)) for v in row])
        text = buf.getvalue()
        if path is not None:
            Path(path).write_text(text)
        return text


def pivot(rows: Sequence[dict], index: Sequence[str], columns: str,
          aggfuncs: str | Sequence[str] = "mean", values: str = "value") -> Table:
    """``DataFrame(rows).pivot_table(index=index, columns=columns,
    values=values, aggfunc=aggfuncs)``: one aggfunc (a string) gives one
    header level, a list of them two, ``(aggfunc, key)``."""
    names = [aggfuncs] if isinstance(aggfuncs, str) else list(aggfuncs)
    groups: dict[tuple, list] = {}
    for r in rows:
        groups.setdefault((tuple(r[k] for k in index), r[columns]), []).append(r[values])
    cells: dict[tuple, float] = {}
    for name in names:
        fn = _AGGREGATES[name]
        for (key, col), vals in groups.items():
            v = fn(vals)
            if not np.isnan(v):  # dropna: pandas leaves an all-NaN aggregate out
                cells[(name, key, col)] = v
    row_keys = sorted({key for _, key, _ in cells})
    if isinstance(aggfuncs, str):
        col_keys = sorted({col for _, _, col in cells})
        out_cols, lookup = col_keys, [(aggfuncs, c) for c in col_keys]
        col_names = (columns,)
    else:
        out_cols = [(n, c) for n in names for c in sorted({c for m, _, c in cells if m == n})]
        lookup = out_cols
        col_names = (None, columns)
    vals = np.full((len(row_keys), len(out_cols)), np.nan)
    for i, key in enumerate(row_keys):
        for j, (name, col) in enumerate(lookup):
            vals[i, j] = cells.get((name, key, col), np.nan)
    return Table(tuple(index), row_keys, out_cols, vals, col_names)


def task_table(
    rows: Sequence[dict],
    *,
    group_seeds: bool = True,
) -> Table:
    """Pivot to (task, metric, unc_type, aggregation) x version mean±std.

    With ``group_seeds``, versions named ``name_s{seed}`` collapse into
    ``name`` with mean and std columns (the reference's seed grouping).
    """
    grouped = [dict(r, group=re.sub(r"_s\d+$", "", r["version"]) if group_seeds
                    else r["version"]) for r in rows]
    return pivot(grouped, ["task", "metric", "unc_type", "aggregation"], "group",
                 ["mean", "std"])


# metrics where smaller is better (risk/error style); everything else is
# treated as higher-is-better when bolding the per-row winner
LOWER_IS_BETTER = {"aurc", "eaurc", "ace", "ece", "eqace", "gace", "gece", "ged", "ged_bma"}


def _means(table: Table) -> Table:
    return table["mean"] if table.has_aggfunc("mean") else table


def _metric_pos(table: Table) -> int:
    return table.index_names.index("metric") if "metric" in table.index_names else 1


def rank_table(table: Table) -> Table:
    """Per-row method ranks of a ``task_table`` (1 = best), plus a
    ``mean_rank`` summary row — the reference's rank-aggregated view of the
    methods x tasks matrix. Rank direction follows ``LOWER_IS_BETTER`` per
    metric row; ties share the average rank. As the JAX frame's concat, the
    result has no index names."""
    from scipy.stats import rankdata

    means = _means(table)
    pos = _metric_pos(means)
    ranks = np.full(means.shape, np.nan)
    for i, (key, row) in enumerate(zip(means.index, means.values)):
        have = ~np.isnan(row)
        if have.any():
            sign = 1.0 if str(key[pos]).lower() in LOWER_IS_BETTER else -1.0
            ranks[i, have] = rankdata(sign * row[have], method="average")
    summary = np.array([nan_mean(ranks[:, j]) for j in range(ranks.shape[1])])
    nlevels = len(means.index_names)
    return Table((None,) * nlevels,
                 means.index + [("mean_rank",) + ("-",) * (nlevels - 1)], means.columns,
                 np.vstack([ranks, summary[None]]) if len(means.columns) else ranks,
                 means.column_names)


def to_latex(table: Table, *, highlight_best: bool = True, precision: int = 4) -> str:
    """Compact LaTeX with the best mean per row bolded (direction-aware)."""
    means = _means(table)
    lines = [r"\begin{tabular}{l" + "c" * len(means.columns) + "}", r"\toprule"]
    lines.append(" & ".join(["metric"] + [str(c) for c in means.columns]) + r" \\")
    lines.append(r"\midrule")
    pos = _metric_pos(means)
    for idx, vals in zip(means.index, means.values):
        label = "/".join(str(x) for x in idx if x != "-")
        metric_name = str(idx[pos])
        finite = np.isfinite(vals)
        if finite.any() and highlight_best:
            best = (np.nanargmin(vals) if metric_name.lower() in LOWER_IS_BETTER
                    else np.nanargmax(vals))
        else:
            best = -1
        cells = []
        for i, v in enumerate(vals):
            text = f"{v:.{precision}f}" if np.isfinite(v) else "-"
            cells.append(rf"\textbf{{{text}}}" if i == best else text)
        lines.append(" & ".join([label] + cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


# --------------------------------------------------------------------------
# charts: the drawn series as JSON
# --------------------------------------------------------------------------

def _plain(obj):
    """JSON-ready: numpy scalars and arrays to Python, NaN to None."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, np.ndarray)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return None if np.isnan(obj) else float(obj)
    return obj


def chart_path(out_path: str | Path) -> Path:
    """Where a chart's series go: the JAX figure's path with ``.json``."""
    return Path(out_path).with_suffix(".json")


def _write_chart(out_path: str | Path, chart: dict) -> Path:
    path = chart_path(out_path)
    path.write_text(json.dumps(_plain(chart), indent=1) + "\n")
    return path


def _select(rows: Sequence[dict], **match) -> list[dict]:
    return [r for r in rows if all(r[k] == v for k, v in match.items())]


def _table_series(table: Table) -> dict:
    return {"index": table.row_keys(), "columns": table.columns, "values": table.values}


def barplot(
    rows: Sequence[dict],
    *,
    metric: str,
    task: str,
    out_path: str | Path,
    by: str = "unc_type",
):
    """Bars of one (task, metric) grouped along ``by`` x version: for each
    version (a bar series) its mean at each value of ``by`` (an x tick)."""
    sel = _select(rows, task=task, metric=metric)
    if not sel:
        raise ValueError(f"no rows for task={task} metric={metric}")
    table = pivot(sel, [by], "version", "mean")
    return _write_chart(out_path, {
        "chart": "bar", "title": f"{task}: {metric}", "ylabel": metric, "by": by,
        "x": table.row_keys(),
        "series": {v: table.column(v) for v in table.columns}})


def metric_matrix(
    rows: Sequence[dict],
    *,
    task: str,
    metric: str,
    out_path: str | Path | None = None,
) -> Table:
    """(unc_type x aggregation) heatmap of one task metric, the mean over
    versions; its values written when ``out_path`` is given."""
    sel = _select(rows, task=task, metric=metric)
    if not sel:
        raise ValueError(f"no rows for {task}/{metric}")
    table = pivot(sel, ["unc_type"], "aggregation", "mean")
    if out_path is not None:
        _write_chart(out_path, {"chart": "heatmap", "title": f"{task}: {metric}",
                                **_table_series(table)})
    return table


def metric_matrix_grid(
    rows: Sequence[dict],
    *,
    cells: Sequence[tuple[str, str]],
    out_path: str | Path,
    ncols: int = 3,
):
    """A grid of ``metric_matrix`` heatmaps, one per (task, metric) cell;
    a cell with no rows is written empty instead of failing."""
    out = []
    for task, metric in cells:
        try:
            out.append({"task": task, "metric": metric,
                        **_table_series(metric_matrix(rows, task=task, metric=metric))})
        except ValueError:
            out.append({"task": task, "metric": metric, "empty": True})
    return _write_chart(out_path, {"chart": "heatmap_grid", "ncols": ncols, "cells": out})


def entangle_metric(u_first, u_second, lower_is_better: bool = False):
    """Paper's entanglement score Δ = s·(arctan2(a, b) − π/4)/(π/4) ∈ [-1, 1]:
    0 means perfectly entangled (a == b), +1 means the first member
    dominates entirely (``visualization/helpers.py:693-696``)."""
    s = -1.0 if lower_is_better else 1.0
    return s * (np.arctan2(u_first, u_second) - np.pi / 4) / (np.pi / 4)


def _au_eu_series(rows: Sequence[dict], task: str, metric: str, aggregation: str) -> dict:
    """One AU-vs-EU scatter: a point per version, its Δ, and the diagonal."""
    sel = [r for r in _select(rows, task=task, metric=metric)
           if r["aggregation"] in (aggregation, "-")]
    table = pivot(sel, ["version"], "unc_type", "mean")
    if "AU" not in table.columns or "EU" not in table.columns:
        raise ValueError("need both AU and EU rows for the scatter")
    au, eu = table.column("AU"), table.column("EU")
    lims = [min(np.nanmin(au), np.nanmin(eu)) - 0.02, max(np.nanmax(au), np.nanmax(eu)) + 0.02]
    return {"task": task, "metric": metric, "aggregation": aggregation,
            "versions": table.row_keys(), "au": au, "eu": eu,
            "delta": [float(entangle_metric(a, e)) for a, e in zip(au, eu)],
            "diagonal": lims, "xlabel": f"AU {metric}", "ylabel": f"EU {metric}"}


def au_eu_scatter(
    rows: Sequence[dict],
    *,
    task: str = "ood_detection",
    metric: str = "auroc",
    aggregation: str = "image_level",
    out_path: str | Path = "au_eu_scatter.png",
):
    """AU-vs-EU score scatter per version (the "entanglement" figure)."""
    return _write_chart(out_path, {"chart": "scatter",
                                   **_au_eu_series(rows, task, metric, aggregation)})


def scatter_grid(
    rows: Sequence[dict],
    *,
    cells: Sequence[tuple[str, str, str]],
    out_path: str | Path,
    ncols: int = 2,
):
    """A grid of AU-vs-EU scatters over (task, metric, aggregation) cells; a
    cell without an AU or EU series is written empty."""
    out = []
    for task, metric, aggregation in cells:
        try:
            out.append(_au_eu_series(rows, task, metric, aggregation))
        except ValueError:
            out.append({"task": task, "metric": metric, "aggregation": aggregation,
                        "empty": True})
    return _write_chart(out_path, {"chart": "scatter_grid", "ncols": ncols, "cells": out})


# --------------------------------------------------------------------------
# training curves: JSONL, seed-grouped
# --------------------------------------------------------------------------

def load_training_curves(workdir: str | Path) -> list[dict]:
    """A run's ``metrics.jsonl`` as long rows: step, epoch, key, value."""
    records = []
    path = Path(workdir) / "metrics.jsonl"
    for i, line in enumerate(path.read_text().splitlines()):
        rec = json.loads(line)
        step = rec.get("step", rec.get("epoch", i))
        epoch = rec.get("epoch")
        for k, v in rec.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and k not in ("step", "epoch"):
                records.append({"step": step, "epoch": epoch, "key": k, "value": float(v)})
    return records


def load_tfevents_curves(logdir: str | Path) -> list[dict]:
    """Not ported: reading TensorBoard event files needs the tensorboard
    package."""
    raise NotImplementedError(
        f"cannot read the TensorBoard events under {logdir}: that needs the tensorboard "
        f"package, which the port does not use (its host may lack it); the port's trainer "
        f"writes metrics.jsonl, which load_training_curves reads")


def merge_training_curves(runs: dict[str, str | Path]) -> list[dict]:
    """Several runs' curves with a ``run`` field; reads JSONL when present,
    tfevents otherwise."""
    rows = []
    for name, workdir in runs.items():
        workdir = Path(workdir)
        if (workdir / "metrics.jsonl").exists():
            curves = load_training_curves(workdir)
        else:
            curves = load_tfevents_curves(workdir)
        rows += [dict(r, run=name) for r in curves]
    return rows


def plot_training_curves(
    curves: Sequence[dict],
    keys: list[str],
    out_path: str | Path,
    *,
    group_seeds: bool = True,
):
    """Per-key training curves; runs named ``..._s{seed}`` are grouped into
    a mean and a mean +/- std band (drawn when a step has more than one run;
    a missing std counts 0) when ``group_seeds``."""
    def group(r):
        run = str(r.get("run", "run"))
        return re.sub(r"_s\d+$", "", run) if group_seeds else run

    out: dict = {}
    for key in keys:
        sel = [r for r in curves if r["key"] == key]
        if not sel:
            out[key] = None
            continue
        out[key] = {}
        for g in sorted({group(r) for r in sel}):
            by_step: dict = {}
            for r in sel:
                if group(r) == g:
                    by_step.setdefault(r["step"], []).append(r["value"])
            steps = sorted(by_step)
            counts = [len(_finite_values(by_step[s])) for s in steps]
            out[key][g] = {"step": steps, "mean": [nan_mean(by_step[s]) for s in steps],
                           "std": [nan_std(by_step[s]) for s in steps], "count": counts,
                           "band": any(c > 1 for c in counts)}
    return _write_chart(out_path, {"chart": "curves", "xlabel": "step", "keys": out})


def ood_shift_panel(
    rows: Sequence[dict],
    out_path: str | Path,
    *,
    metric: str = "dice",
    task: str | None = None,
    shift_of=lambda v: v.rsplit("/", 1)[-1],
    method_of=lambda v: v.rsplit("/", 1)[0],
    id_shift: str = "id",
):
    """Metric-vs-distribution-shift lines, one per method across id ->
    ood_noise/blur/... (version names ``method/shift``; the id split first)."""
    sel = [r for r in rows if r["metric"] == metric and (task is None or r["task"] == task)]
    if not sel:
        raise ValueError(f"no rows for metric={metric!r} (task={task!r})")
    shifts = sorted({shift_of(r["version"]) for r in sel}, key=lambda s: (s != id_shift, s))
    series = {}
    for method in sorted({method_of(r["version"]) for r in sel}):
        mine = [r for r in sel if method_of(r["version"]) == method]
        by_shift = {s: [r["value"] for r in mine if shift_of(r["version"]) == s] for s in shifts}
        series[method] = [nan_mean(v) if v else float("nan") for v in by_shift.values()]
    return _write_chart(out_path, {"chart": "lines", "title": f"{metric} under distribution shift",
                                   "ylabel": metric, "x": shifts, "series": series})


def al_improvement_plot(
    cycles: dict[str, dict[str, float]],
    out_path: str | Path,
    *,
    metric: str = "dice",
):
    """Active-learning panel: first-cycle score + per-query-strategy second
    cycle bars. ``cycles``: {method: {"first": v, "unc": v, "random": v, ...}}."""
    strategies: list[str] = []
    for d in cycles.values():
        for k in d:
            if k != "first" and k not in strategies:
                strategies.append(k)
    x = np.arange(len(cycles))
    width = 0.8 / (len(strategies) + 1)
    bars = [{"label": "first cycle", "x": x, "height": [d["first"] for d in cycles.values()]}]
    for i, strat in enumerate(strategies):
        bars.append({"label": f"2nd: {strat}", "x": x + (i + 1) * width,
                     "height": [d.get(strat, np.nan) for d in cycles.values()]})
    return _write_chart(out_path, {
        "chart": "bar", "title": f"active-learning second cycle ({metric})", "ylabel": metric,
        "width": width, "xticks": x + 0.4 - width / 2, "xticklabels": list(cycles),
        "bars": bars})


def risk_coverage_plot(
    series: dict[str, tuple],
    out_path: str | Path,
    *,
    title: str | None = None,
):
    """Risk–coverage curves with their AURC (``metrics/aurc.py``).
    ``series``: {label: (risks, confids)} per method/heatmap."""
    from ..metrics.aurc import aurc, rc_curve_stats

    out = {}
    for label, (risks, confids) in series.items():
        coverages, sel_risks, _ = rc_curve_stats(
            np.asarray(risks, np.float64), np.asarray(confids, np.float64))
        out[label] = {"coverage": coverages, "selective_risk": sel_risks,
                      "aurc": aurc(np.asarray(risks), np.asarray(confids))}
    return _write_chart(out_path, {"chart": "risk_coverage", "title": title or "risk–coverage",
                                   "xlabel": "coverage", "ylabel": "selective risk",
                                   "series": out})


def reliability_diagram(
    correct,
    confids,
    out_path: str | Path,
    *,
    n_bins: int = 20,
    title: str | None = None,
):
    """Reliability diagram: per non-empty bin its centre, accuracy, mean
    confidence and share of the samples, with the ECE and ACE (bins as
    ``evaln.tasks._calib_stats``)."""
    from .tasks import calc_ace, calc_ece

    correct = np.asarray(correct).astype(np.float64).reshape(-1)
    confids = np.clip(np.asarray(confids).astype(np.float64).reshape(-1), 0, 1)
    bins = np.linspace(0.0, 1.0 + 1e-8, n_bins + 1)
    binids = np.digitize(confids, bins) - 1
    total = np.bincount(binids, minlength=n_bins + 1)[:n_bins]
    acc = np.full(n_bins, np.nan)
    conf = np.full(n_bins, np.nan)
    nz = total > 0
    acc[nz] = np.bincount(binids, weights=correct, minlength=n_bins + 1)[:n_bins][nz] / total[nz]
    conf[nz] = np.bincount(binids, weights=confids, minlength=n_bins + 1)[:n_bins][nz] / total[nz]
    centers = (bins[:-1] + bins[1:])[:n_bins] / 2
    ece, ace = calc_ece(correct, confids), calc_ace(correct, confids)
    return _write_chart(out_path, {
        "chart": "reliability", "title": title or f"ECE {ece:.4f} · ACE {ace:.4f}",
        "n_bins": n_bins, "width": 1.0 / n_bins, "bin_centers": centers[nz],
        "accuracy": acc[nz], "confidence": conf[nz], "density": total[nz] / total.sum(),
        "count": total[nz], "ece": ece, "ace": ace})


# --------------------------------------------------------------------------
# image panels: the shown arrays composed into one PNG
# --------------------------------------------------------------------------

PANEL_PAD = 2  # white pixels between the tiles of a panel


def shown(arr, vmin=None, vmax=None) -> np.ndarray:
    """What ``imshow`` shows of ``arr``, as (H, W, 3) floats in [0, 1]: a
    2-D array in gray, scaled from [vmin, vmax] (its own min and max where
    not given; 0 where the two are equal; NaN white), an RGB(A) array as it
    is, clipped."""
    a = np.asarray(arr)
    if a.ndim == 3:
        return np.clip(a[..., :3].astype(np.float64), 0.0, 1.0)
    a = a.astype(np.float64)
    finite = a[~np.isnan(a)]
    lo = float(finite.min()) if vmin is None and finite.size else vmin
    hi = float(finite.max()) if vmax is None and finite.size else vmax
    lo, hi = (0.0, 0.0) if lo is None or hi is None else (float(lo), float(hi))
    t = np.zeros_like(a) if hi == lo else np.clip((a - lo) / (hi - lo), 0.0, 1.0)
    t[np.isnan(a)] = 1.0
    return np.repeat(t[..., None], 3, axis=-1)


def panel_canvas(tiles: dict[tuple[int, int], np.ndarray], n_rows: int, n_cols: int,
                 pad: int = PANEL_PAD) -> np.ndarray:
    """The (rows x cols) grid of a figure's axes as one RGB canvas: tile
    (r, c) top-left in its cell, each row as tall and each column as wide as
    its largest tile, ``pad`` white pixels around; an axes without a tile
    stays white."""
    heights = [max([t.shape[0] for (r, _), t in tiles.items() if r == i] or [0])
               for i in range(n_rows)]
    widths = [max([t.shape[1] for (_, c), t in tiles.items() if c == j] or [0])
              for j in range(n_cols)]
    ys = np.concatenate([[pad], pad + np.cumsum(np.add(heights, pad))])
    xs = np.concatenate([[pad], pad + np.cumsum(np.add(widths, pad))])
    canvas = np.ones((int(ys[-1]), int(xs[-1]), 3))
    for (r, c), tile in tiles.items():
        h, w = tile.shape[:2]
        canvas[ys[r]:ys[r] + h, xs[c]:xs[c] + w] = tile
    return canvas


def _write_canvas(canvas: np.ndarray, out_path: str | Path) -> Path:
    from ..infer.image_io import write_png

    write_png(out_path, np.round(np.clip(canvas, 0.0, 1.0) * 255.0).astype(np.uint8),
              mode="RGB")
    return Path(out_path)


def _heatmaps(group_means: np.ndarray) -> dict[str, np.ndarray]:
    """TU/AU/EU of a (G, H, W, C) stack of group means (``ops/entropy.py``)."""
    import torch

    from ..ops.entropy import uncertainty_heatmaps

    maps = uncertainty_heatmaps(torch.from_numpy(np.ascontiguousarray(group_means)),
                                sample_axis=0, class_axis=-1)
    return {k: v.numpy() for k, v in maps.items()}


def plot_prediction_grid(
    raw: dict,
    out_path: str | Path,
    *,
    max_samples: int = 6,
    heatmap: str = "TU",
):
    """Qualitative grid: image | raters | per-group samples | mean | heatmap,
    from ``UncertaintyInference.collect_raw_predictions``."""
    records = raw["records"]
    sample_cols = min(max_samples, records[0]["groups"].shape[0])
    tiles = {}
    for r, rec in enumerate(records):
        img = rec["image"]
        tiles[r, 0] = shown(img if img.ndim == 2 else img[..., 0])
        tiles[r, 1] = shown(rec["gt"].mean(axis=0), vmin=0, vmax=rec["gt"].max() or 1)
        for c in range(sample_cols):
            tiles[r, 2 + c] = shown(np.argmax(rec["groups"][c, 0], axis=-1))
        tiles[r, 2 + sample_cols] = shown(np.argmax(rec["mean"], axis=-1))
        maps = _heatmaps(rec["groups"].mean(axis=1))
        key = heatmap if heatmap in maps else list(maps)[0]
        tiles[r, 3 + sample_cols] = shown(maps[key])
    return _write_canvas(panel_canvas(tiles, len(records), 4 + sample_cols), out_path)


def uncertainty_panel(
    raw: dict,
    out_path: str | Path,
    *,
    max_rows: int = 4,
):
    """Per-dataset paper panel: image | rater mean | mean pred | TU | AU | EU."""
    records = raw["records"][:max_rows]
    tiles = {}
    for r, rec in enumerate(records):
        img = rec["image"]
        tiles[r, 0] = shown(img if img.ndim == 2 else img[..., 0])
        tiles[r, 1] = shown(rec["gt"].mean(axis=0), vmin=0,
                            vmax=max(float(rec["gt"].max()), 1.0))
        tiles[r, 2] = shown(np.argmax(rec["mean"], axis=-1))
        maps = _heatmaps(rec["groups"].mean(axis=1))
        for c, key in enumerate(["TU", "AU", "EU"]):
            if key in maps:
                tiles[r, 3 + c] = shown(maps[key])
    return _write_canvas(panel_canvas(tiles, len(records), 6), out_path)


def plot_tta_augs(
    image,
    out_path: str | Path,
    *,
    n: int = 8,
    tta_config=None,
    seed: int = 0,
):
    """Debug grid of TTA draws (rows: input, augmented, inverted), the
    draws from a CPU generator seeded ``seed``."""
    import torch

    from ..sampling import tta as tta_lib

    cfg = tta_config or tta_lib.TTAConfig()
    img = torch.as_tensor(np.asarray(image), dtype=torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    batch = img[None].expand((n,) + tuple(img.shape)).contiguous()
    params = tta_lib.sample_tta_params(cfg, torch.Generator().manual_seed(seed), n, h, w)
    aug = tta_lib.apply_tta(batch, params)
    back = tta_lib.invert_tta(aug, params)
    tiles = {}
    for i in range(n):
        for row, arr in ((0, batch), (1, aug), (2, back)):
            a = arr[i].numpy()
            tiles[row, i] = shown(a[..., 0] if a.shape[-1] not in (3, 4) else a)
    return _write_canvas(panel_canvas(tiles, 3, n), out_path)


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """float [0,1] grayscale/RGB -> (H, W, 3)."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3 and img.shape[-1] >= 3:
        return img[..., :3].copy()
    if img.ndim == 3:
        img = img[..., 0]
    return np.repeat(img[..., None], 3, axis=-1)


def _overlay_outline(rgb: np.ndarray, mask: np.ndarray, color, lw: float = 1.0):
    """Alpha-blend the erosion-outline of a binary mask onto an RGB image
    in place (the reference's label overlay style, helpers.py:2366-2420)."""
    from scipy import ndimage as ndi

    binary = np.asarray(mask) > 0
    if not binary.any():
        return rgb
    eroded = ndi.binary_erosion(binary, iterations=max(1, int(round(lw))))
    outline = binary & ~eroded
    alpha = color[3] if len(color) == 4 else 0.75
    for c in range(3):
        rgb[..., c] = np.where(outline, (1 - alpha) * rgb[..., c] + alpha * color[c],
                               rgb[..., c])
    return rgb


def _image_grid(tiles: list[np.ndarray], cols: int, pad: int, pad_color) -> np.ndarray:
    """Concatenate RGB tiles into a rows x cols grid with padding all around."""
    h, w = tiles[0].shape[:2]
    rows = (len(tiles) + cols - 1) // cols
    canvas = np.ones((rows * h + (rows + 1) * pad, cols * w + (cols + 1) * pad, 3))
    canvas *= np.asarray(pad_color, np.float64)
    for k, tile in enumerate(tiles):
        r, c = divmod(k, cols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        canvas[y:y + h, x:x + w] = tile
    return canvas


def dataset_overview_panel(
    data_dir: str | Path,
    out_path: str | Path,
    *,
    split_name: str = "default",
    pools: "list[tuple[str, str]] | None" = None,
    ood_pools: "list[tuple[str, str]] | None" = None,
    n_rows: int = 3,
    cols_per_pool: "dict[str, int] | None" = None,
    num_label_rows: int = 2,
    label_color=(1.0, 0.1, 0.1, 0.8),
    pad: int = 1,
    seed: int = 0,
    norm: str = "gauss3",
):
    """Train | Val | Test(id) | Test(ood) dataset overview: per-pool image
    grids side by side, rater-0 outlines on the first ``num_label_rows``
    rows, one OOD pool drawn at random (the reference's ``plot_lidc``).

    ``norm``: "gauss3" standardizes each image and clips to +-3 std;
    "minmax" rescales to [0, 1].
    """
    from ..data.dataset import MultiRaterDataset, load_splits

    data_dir = Path(data_dir)
    splits_path = data_dir / "splits" / split_name / "firstCycle" / "splits.pkl"
    fold = load_splits(splits_path)[0]
    rng = np.random.default_rng(seed)

    pools = pools or [("train", "Train"), ("val", "Val"), ("id", "Test (id)")]
    if ood_pools is None:
        ood_pools = [
            (k, k.removeprefix("ood_").replace("_", " ").capitalize())
            for k in fold
            if isinstance(k, str) and k.startswith("ood_") and "&" not in k
        ]
    ood_choice = ood_pools[rng.integers(len(ood_pools))] if ood_pools else None
    cols = {"train": 4, "val": 1, "id": 1, "ood": 1, **(cols_per_pool or {})}

    def normalize(img):
        img = np.asarray(img, np.float64)
        if norm == "gauss3":
            img = (img - img.mean()) / (img.std() + 1e-8)
            img = (np.clip(img, -3, 3) + 3) / 6
        else:
            img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        return img

    def pool_grid(pool_key, n_cols):
        ds = MultiRaterDataset(splits_path, data_dir, split=pool_key, return_all_raters=True)
        count = min(n_rows * n_cols, len(ds))
        idxs = rng.choice(len(ds), size=count, replace=False)
        tiles = []
        for k, i in enumerate(idxs):
            sample = ds.load(int(i))
            rgb = _to_rgb(normalize(sample["image"]))
            if k // n_cols < num_label_rows:
                _overlay_outline(rgb, np.asarray(sample["seg"])[0], label_color)
            tiles.append(rgb)
        return _image_grid(tiles, n_cols, pad, (0.0, 0.0, 0.0))

    grids = [pool_grid(key, cols.get(key, 1)) for key, _ in pools]
    if ood_choice is not None:
        grids.append(pool_grid(ood_choice[0], cols.get("ood", 1)))
    return _write_canvas(panel_canvas({(0, i): shown(g) for i, g in enumerate(grids)},
                                      1, len(grids)), out_path)


def grouped_rows_panel(
    data_dir: str | Path,
    out_path: str | Path,
    *,
    group_col: str = "machine",
    groups: "list[str] | None" = None,
    group_titles: "list[str] | None" = None,
    split_name: str | None = None,
    pool: str | None = None,
    n_cols: int = 6,
    label_cols: int = 3,
    class_colors=((0.1, 1.0, 0.1, 0.6), (1.0, 0.1, 0.1, 0.6)),
    label_lw: float = 1.0,
    pad: int = 1,
    seed: int = 0,
):
    """Rows-by-metadata-group qualitative figure (the reference's
    ``plot_chaksu``): one row per metadata group, randomly sampled images,
    all raters' class outlines on the first ``label_cols`` columns."""
    import csv as _csv

    data_dir = Path(data_dir)
    meta_path = data_dir / "preprocessed" / "metadata.csv"
    by_group: dict[str, list[str]] = {}
    with open(meta_path) as f:
        for row in _csv.DictReader(f):
            by_group.setdefault(row[group_col], []).append(row["image_file"])
    groups = groups or sorted(by_group)
    rng = np.random.default_rng(seed)

    img_root = data_dir / "preprocessed"
    lbl_root = data_dir / "preprocessed" / "labels"

    def load_rgb(rel):
        img = np.asarray(np.load(img_root / rel), np.float64)
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        return _to_rgb(img)

    def rater_masks(rel):
        base = Path(rel).stem
        out = []
        for r in range(64):
            p = lbl_root / f"{base}_{r:02d}_mask.npy"
            if not p.exists():
                break
            out.append(np.load(p))
        return out

    rows = []
    for g in groups:
        files = by_group.get(g, [])
        if not files:
            raise ValueError(f"metadata group {g!r} has no images")
        take = rng.choice(len(files), size=min(n_cols, len(files)), replace=False)
        tiles = []
        for k, fi in enumerate(take):
            rgb = load_rgb(files[int(fi)])
            if k < label_cols:
                for mask in rater_masks(files[int(fi)]):
                    for ci, color in enumerate(class_colors):
                        _overlay_outline(rgb, np.asarray(mask) >= ci + 0.5, color, label_lw)
            tiles.append(rgb)
        rows.append(_image_grid(tiles, len(tiles), pad, (0.0, 0.0, 0.0)))
    return _write_canvas(panel_canvas({(i, 0): shown(g) for i, g in enumerate(rows)},
                                      len(rows), 1), out_path)


def _common_ids(raws: dict, n_images: int, what: str) -> tuple[list, list, list]:
    labels = list(raws)
    by_id = [{r["image_id"]: r for r in raws[label]["records"]} for label in labels]
    common = [i for i in by_id[0] if all(i in d for d in by_id[1:])][:n_images]
    if not common:
        raise ValueError(f"no shared image_ids across the provided {what}")
    return labels, by_id, common


def _input_rgb(base: dict) -> tuple[np.ndarray, np.ndarray]:
    """The record's image in [0, 1] as RGB, and its raters' masks."""
    rgb = _to_rgb(np.asarray(base["image"], np.float64))
    rgb = (rgb - rgb.min()) / (rgb.max() - rgb.min() + 1e-8)
    return rgb, np.asarray(base["gt"]).reshape((-1,) + rgb.shape[:2])


def uncertainty_triptych_panel(
    raws: "dict[str, dict]",
    out_path: str | Path,
    *,
    n_images: int = 2,
    gt_color=(1.0, 0.1, 0.1, 0.9),
    cmap: str = "viridis",
):
    """Uncertainty-type grid (the reference's ``qualitative_plot_uncertainty``):
    per image three rows (AU/EU/TU), one heatmap column per method; the
    leading column shows the input with rater outlines on the AU row and the
    first raters' masks below. ``raws``: {method label:
    ``collect_raw_predictions`` result}. ``cmap`` is not drawn (gray)."""
    unc_types = ("AU", "EU", "TU")
    labels, by_id, common = _common_ids(raws, n_images, "methods")
    tiles = {}
    for b, image_id in enumerate(common):
        rgb, raters = _input_rgb(by_id[0][image_id])
        outlined = rgb.copy()
        for rater in raters:
            _overlay_outline(outlined, rater, gt_color)
        tiles[3 * b, 0] = shown(outlined)
        for k in (1, 2):
            if k - 1 < raters.shape[0]:
                tiles[3 * b + k, 0] = shown(raters[k - 1])
        for m in range(len(labels)):
            maps = _heatmaps(np.asarray(by_id[m][image_id]["groups"]).mean(axis=1))
            for k, unc in enumerate(unc_types):
                tiles[3 * b + k, 1 + m] = shown(maps[unc])
    return _write_canvas(panel_canvas(tiles, 3 * len(common), 1 + len(labels)), out_path)


def model_comparison_panel(
    raws: "dict[str, dict]",
    out_path: str | Path,
    *,
    n_images: int = 3,
    heatmap: str = "TU",
    gt_color=(1.0, 0.1, 0.1, 0.9),
    cmap: str = "viridis",
):
    """Side-by-side model comparison (the reference's
    ``qualitative_plot_models``): rows are images; the input with every
    rater's outline, then per model its mean prediction and an uncertainty
    heatmap ("TU" | "AU" | "EU"; 1 - max softmax for one group). ``cmap``
    is not drawn (gray)."""
    import torch

    from ..ops.entropy import one_minus_msr

    labels, by_id, common = _common_ids(raws, n_images, "models")
    tiles = {}
    for row, image_id in enumerate(common):
        rgb, raters = _input_rgb(by_id[0][image_id])
        for rater in raters:
            _overlay_outline(rgb, rater, gt_color)
        tiles[row, 0] = shown(rgb)
        for m in range(len(labels)):
            rec = by_id[m][image_id]
            group_means = np.asarray(rec["groups"]).mean(axis=1)
            if group_means.shape[0] > 1:
                unc = _heatmaps(group_means)[heatmap]
            else:
                unc = one_minus_msr(torch.from_numpy(group_means[0]), class_axis=-1).numpy()
            tiles[row, 1 + 2 * m] = shown(np.asarray(rec["mean"]).argmax(-1))
            tiles[row, 2 + 2 * m] = shown(unc)
    return _write_canvas(panel_canvas(tiles, len(common), 1 + 2 * len(labels)), out_path)
