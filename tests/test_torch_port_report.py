"""Port parity of the report layer: ``diffuncertainty_tpu_torch/evaln/visualization.py``,
``tools/report.py``, ``tools/checks.py`` and the study's analysis
(``tools/values_study.py``) against the JAX package on the same inputs.

No model runs. One results tree is drawn with numpy from a seed, laid out
as the study lays it out: AU types softmax and ssn x EU methods none and
dropout x seeds 0 and 1, splits ``val``, ``id`` and ``ood_noise`` of 16x16
images (mean and three sample masks, TU/AU/EU TIFFs, ``metrics.json``), with
every task file written by the port's evaluation matrix (held to the JAX
one by ``test_torch_port_eval.py``). Then one calibration value is made
NaN and one failure-detection AURC equal across two methods, so the pivot's
dropped cells and the ranks' ties show. Both packages read that tree: the
JAX functions a pandas frame, the port's its tidy rows.

Tolerances: the tables' values 1e-12 (NaN in the same places), the LaTeX
and the interpretation text identical, the direction checks and the noise
diagnosis's AUROCs 1e-12; a chart's series 1e-12 against what the JAX
function hands matplotlib (``plot``, ``bar``, ``scatter``, ``imshow``,
``fill_between``, recorded on ``Axes``); a panel's canvas 1e-5 against the
arrays the JAX function hands ``imshow`` at their axes' places (the
heatmaps are float32 entropies of two implementations), its PNG within
8-bit rounding of the canvas; the ``backfill_tu`` TIFFs 1e-7.
"""

import csv
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

import diffuncertainty_tpu.evaln.experiments as j_exp
import diffuncertainty_tpu.sampling.tta as j_tta
import diffuncertainty_tpu.evaln.visualization as j_viz
import diffuncertainty_tpu.tools.checks as j_checks
import diffuncertainty_tpu.tools.report as j_report
import diffuncertainty_tpu.tools.values_study as j_study
import diffuncertainty_tpu_torch.evaln.experiments as t_exp
import diffuncertainty_tpu_torch.evaln.visualization as t_viz
import diffuncertainty_tpu_torch.sampling.tta as t_tta
import diffuncertainty_tpu_torch.tools.checks as t_checks
import diffuncertainty_tpu_torch.tools.report as t_report
import diffuncertainty_tpu_torch.tools.values_study as t_study
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset as TDataset
from diffuncertainty_tpu_torch.infer.image_io import write_png, write_tiff
from torch_threads import one_torch_thread  # noqa: F401

HW, RATERS = 16, 3
SPLITS = {"val": 5, "id": 6, "ood_noise": 6}
METHODS = ("softmax_none", "softmax_dropout", "ssn_none", "ssn_dropout")
SEEDS = (0, 1)
EXACT = dict(rtol=0, atol=1e-12)


def write_dataset(root: Path, rng) -> Path:
    proc = root / "preprocessed"
    (proc / "images").mkdir(parents=True)
    (proc / "labels").mkdir()
    fold = {"_meta": {"num_raters": RATERS, "dataset_name": "toy"}, "train": []}
    for split, n in SPLITS.items():
        fold[split] = []
        for i in range(n):
            iid = f"{split}_{i:02d}"
            np.save(proc / "images" / f"{iid}.npy", rng.random((HW, HW, 1), dtype=np.float32))
            for r in range(RATERS):
                np.save(proc / "labels" / f"{iid}_{r:02d}_mask.npy",
                        (rng.random((HW, HW)) > 0.6).astype(np.uint8))
            fold[split].append(f"images/{iid}.npy")
    splits = root / "splits" / "default" / "firstCycle" / "splits.pkl"
    splits.parent.mkdir(parents=True)
    splits.write_bytes(pickle.dumps([fold]))
    return splits


def write_split(split_dir: Path, split: str, n: int, eu_scale: float, rng) -> None:
    (split_dir / "pred_seg").mkdir(parents=True)
    metrics = {}
    for i in range(n):
        iid = f"{split}_{i:02d}"
        samples = [(rng.random((HW, HW)) > 0.6).astype(np.uint8) for _ in range(3)]
        for name, mask in [("mean", (np.sum(samples, 0) >= 2).astype(np.uint8))] + [
                (f"{k + 1:02d}", s) for k, s in enumerate(samples)]:
            write_png(split_dir / "pred_seg" / f"{iid}_{name}.png", mask * np.uint8(255))
        au = rng.random((HW, HW), dtype=np.float32) * np.float32(0.5)
        eu = rng.random((HW, HW), dtype=np.float32) * np.float32(eu_scale)
        if split == "ood_noise":
            eu = eu + np.float32(0.1 * eu_scale)
        for unc, arr in {"TU": au + eu, "AU": au, "EU": eu}.items():
            (split_dir / unc).mkdir(exist_ok=True)
            write_tiff(split_dir / unc / f"{iid}.tif", arr)
        metrics[iid] = {"dataset": "toy", "metrics": {"dice": float(rng.random()),
                                                      "ged": float(rng.random())}}
    (split_dir / "metrics.json").write_text(json.dumps(metrics))


def version_dir(root: Path, method: str, seed: int) -> Path:
    return root / "results" / method / "test_results4" / f"s{seed}" / "e3_ema"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The results tree, evaluated by the port's matrix, and its inputs."""
    root = tmp_path_factory.mktemp("report")
    rng = np.random.default_rng(0)
    splits = write_dataset(root / "data", rng)
    for m, method in enumerate(METHODS):
        for seed in SEEDS:
            for split, n in SPLITS.items():
                write_split(version_dir(root, method, seed) / split, split, n,
                            0.1 + 0.1 * m + 0.05 * seed, rng)
    experiments = [{"iter_params": {"pred_model": list(METHODS), "seed": list(SEEDS)},
                    "exp_name": "{pred_model}", "naming_scheme_version": "s{seed}/e{epoch}_ema",
                    "n_pred": 4, "epoch": 3}]
    versions = t_exp.expand_versions(root / "results", experiments)
    t_exp.EvalMatrix(versions, dataset_factory=lambda v, s: TDataset(splits, root / "data",
                                                                     split=s),
                     paired_splits=[("id", "ood_noise")], ignore_value=-1,
                     log=lambda msg: None).run(t_study.TASKS)
    # a NaN cell (pandas drops it) and a tie of two methods' means
    cal = version_dir(root, "ssn_dropout", 1) / "id" / "calibration.json"
    payload = json.loads(cal.read_text())
    payload["mean"]["EU"]["metrics"]["ace"] = float("nan")
    cal.write_text(json.dumps(payload))
    for method in ("softmax_none", "ssn_none"):
        for seed in SEEDS:
            fd = version_dir(root, method, seed) / "id" / "failure_detection.json"
            payload = json.loads(fd.read_text())
            payload["mean"]["TU"]["image_level"]["metrics"]["aurc"] = 0.25 + 0.125 * seed
            fd.write_text(json.dumps(payload))
    by_split = {f"{m}_s{s}": version_dir(root, m, s) / "id" for m in METHODS for s in SEEDS}
    by_exp = {f"{m}_s{s}": version_dir(root, m, s) for m in METHODS for s in SEEDS}
    rows = (t_viz.collect_results(by_split)
            + t_viz.collect_results(by_exp, include_segmentation=False))
    df = pd.concat([j_viz.collect_results(by_split),
                    j_viz.collect_results(by_exp, include_segmentation=False)],
                   ignore_index=True)
    return {"root": root, "splits": splits, "data": root / "data", "rows": rows, "df": df,
            "experiments": experiments, "versions": versions}


def assert_json_close(got, ref, path=""):
    """Same structure and keys in the same order, floats to 1e-12 (NaN equal)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            assert_json_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_json_close(g, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        np.testing.assert_allclose(got, ref, err_msg=path, **EXACT)
    else:
        assert got == ref, (path, got, ref)


def assert_frames_equal(got: pd.DataFrame, ref: pd.DataFrame):
    assert list(got.index) == list(ref.index)
    assert list(got.columns) == list(ref.columns)
    assert got.index.names == ref.index.names and got.columns.names == ref.columns.names
    np.testing.assert_allclose(got.to_numpy(float), ref.to_numpy(float), equal_nan=True,
                               **EXACT)


# ---- the table half ---------------------------------------------------------


def test_collect_results_rows_equal_the_jax_frame(tree):
    ref = tree["df"].to_dict("records")
    assert len(tree["rows"]) == len(ref) > 0
    for got, want in zip(tree["rows"], ref):
        assert list(got) == list(want)
        assert_json_close(got, want)


@pytest.mark.parametrize("group_seeds", [True, False])
def test_task_table_csv_equals_jax(tree, tmp_path, group_seeds):
    table = t_viz.task_table(tree["rows"], group_seeds=group_seeds)
    ref = j_viz.task_table(tree["df"], group_seeds=group_seeds)
    table.to_csv(tmp_path / "port.csv")
    ref.to_csv(tmp_path / "jax.csv")
    read = dict(header=[0, 1], index_col=[0, 1, 2, 3])
    assert_frames_equal(pd.read_csv(tmp_path / "port.csv", **read),
                        pd.read_csv(tmp_path / "jax.csv", **read))
    # the dropped NaN cell and the std columns of one seed (no seed grouping)
    assert np.isnan(ref.to_numpy(float)).any() and ref.shape == table.shape
    if not group_seeds:
        assert all(agg == "mean" for agg, _ in table.columns)


def test_rank_table_and_latex_equal_jax(tree, tmp_path):
    table = t_viz.task_table(tree["rows"])
    ref = j_viz.task_table(tree["df"])
    t_viz.rank_table(table).to_csv(tmp_path / "port.csv")
    ranks = j_viz.rank_table(ref)
    ranks.to_csv(tmp_path / "jax.csv")
    got = pd.read_csv(tmp_path / "port.csv", index_col=[0, 1, 2, 3])
    want = pd.read_csv(tmp_path / "jax.csv", index_col=[0, 1, 2, 3])
    assert_frames_equal(got, want)
    assert (tmp_path / "port.csv").read_text().splitlines()[0] == (
        tmp_path / "jax.csv").read_text().splitlines()[0]
    assert (ranks.to_numpy(float) % 1 == 0.5).any()  # the tie shares the average rank
    assert t_viz.to_latex(table) == j_viz.to_latex(ref)
    assert t_viz.to_latex(table, highlight_best=False, precision=2) == j_viz.to_latex(
        ref, highlight_best=False, precision=2)


# ---- the study's analysis -----------------------------------------------------

AL = {"dice_first_cycle": 0.61, "dice_second_cycle": {"uncertainty": 0.63, "random": 0.62,
                                                      "worst": 0.6},
      "al_improvement_uncertainty": 0.63 / 0.61 - 0.62 / 0.61,
      "al_improvement_worst": 0.6 / 0.61 - 0.62 / 0.61}


def study_configs(root):
    kw = dict(workdir=root, au_types=("softmax", "ssn"), eu_methods=("none", "dropout"),
              seeds=SEEDS, ood_shifts=("ood_noise",), n_pred=4)
    return j_study.StudyConfig(**kw), t_study.StudyConfig(**kw)


@pytest.mark.parametrize("al", [AL, None])
def test_direction_checks_and_interpretation_equal_jax(tree, al):
    j_cfg, t_cfg = study_configs(tree["root"])
    ref = j_study._direction_checks(tree["df"], j_cfg, al)
    got = t_study._direction_checks(tree["rows"], t_cfg, al)
    assert_json_close(got, ref)
    assert ref["ood_auroc"]["per_shift"]["ood_noise"]["eu_methods"]  # the EU rows were found
    assert t_study._interpretation_lines(got, al) == j_study._interpretation_lines(ref, al)


def test_eu_noise_diagnosis_equals_jax(tree):
    j_cfg, t_cfg = study_configs(tree["root"])
    ref = j_study._eu_noise_diagnosis(j_exp.expand_versions(tree["root"] / "results",
                                                            tree["experiments"]), j_cfg)
    got = t_study._eu_noise_diagnosis(tree["versions"], t_cfg)
    assert_json_close(got, ref)
    assert "auroc_EU" in got and "auroc_TU" in got and got["root_cause"] == ref["root_cause"]


def test_report_md_equals_jax_but_the_environment_line(tree, tmp_path):
    j_cfg, t_cfg = study_configs(tree["root"])
    checks = t_study._direction_checks(tree["rows"], t_cfg, AL)
    diagnosis = t_study._eu_noise_diagnosis(tree["versions"], t_cfg)
    figures = {"risk_coverage": "x/risk_coverage_id.png", "triptych": "x/triptych.png",
               "ood_auroc_ood_noise": "x/ood_auroc_ood_noise.png"}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j_study._write_report_md(tmp_path / "jax", j_cfg, tree["df"], checks, AL, figures,
                             diagnosis=diagnosis, wall_seconds=12.0, environment={
                                 "backend": "cpu", "devices": ["cpu:0"], "n_devices": 1})
    env = t_study.study_environment("cpu")
    t_study._write_report_md(tmp_path / "port", t_cfg, tree["rows"], checks, AL, figures,
                             diagnosis=diagnosis, environment=env, wall_seconds=12.0)
    ref = (tmp_path / "jax" / "REPORT.md").read_text().splitlines()
    got = (tmp_path / "port" / "REPORT.md").read_text().splitlines()
    assert ref[4].startswith("Ran on backend") and got[4] == (
        f"Ran on torch device `cpu` (1 device(s): {env['device_name']}), wall-clock 12s this "
        f"invocation (resumed invocations exclude cached cells).")
    # the scatter is written as its series
    assert got[:4] + got[5:] == [ln.replace("au_eu_scatter.png", "au_eu_scatter.json")
                                 for ln in ref[:4] + ref[5:]]
    # a chart's entry links its JSON series, a panel's stays an image
    t_study._write_report_md(tmp_path / "port", t_cfg, tree["rows"], checks, None,
                             {"reliability": "r/reliability_id.json", "triptych": "t.png"})
    text = (tmp_path / "port" / "REPORT.md").read_text()
    assert ("\n[reliability diagram, Platt-scaled pixel confidences](reliability_id.json)\n"
            in text and "\n![qualitative AU/EU/TU heatmaps across AU types](t.png)\n" in text)


# ---- the charts ------------------------------------------------------------------


@pytest.fixture
def drawn(monkeypatch):
    """Every ``plot``/``bar``/``scatter``/``imshow``/``fill_between`` call on
    a matplotlib Axes: (name, (row, col) of its axes, args, kwargs)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.axes import Axes

    calls = []
    for name in ("plot", "bar", "scatter", "imshow", "fill_between"):
        def record(self, *args, _name=name, _orig=getattr(Axes, name), **kw):
            spec = self.get_subplotspec()
            where = None if spec is None else (spec.rowspan.start, spec.colspan.start,
                                               spec.get_gridspec().get_geometry())
            calls.append((_name, where, args, kw))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(Axes, name, record)
    return calls


def of(calls, name):
    return [c for c in calls if c[0] == name]


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               equal_nan=True, **EXACT)


def chart(path) -> dict:
    """A chart's JSON, null read back as NaN."""
    def nan(x):
        if isinstance(x, dict):
            return {k: nan(v) for k, v in x.items()}
        if isinstance(x, list):
            return [nan(v) for v in x]
        return float("nan") if x is None else x
    return nan(json.loads(Path(path).read_text()))


def curves_runs(root: Path) -> dict:
    """Three runs' metrics.jsonl (two seeds of one method, steps missing in
    one), as the trainer's jsonl logger writes them."""
    rng = np.random.default_rng(3)
    runs = {}
    for name, n in (("softmax_none_s0", 5), ("softmax_none_s1", 4), ("ssn_none_s0", 5)):
        (root / name).mkdir(parents=True)
        recs = [{"epoch": e, "train_loss": float(rng.random()), "lr": 0.003} for e in range(n)]
        recs[1]["val_dice"] = float(rng.random())
        (root / name / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
        runs[name] = root / name
    return runs


def shift_rows(tree) -> list[dict]:
    return [dict(r, version=f"{r['version'].rsplit('_s', 1)[0]}/{shift}",
                 value=r["value"] + 0.1 * k)
            for k, shift in enumerate(("ood_noise", "id", "ood_blur"))
            for r in tree["rows"] if r["task"] == "segmentation"]


def rc_series(tree):
    from diffuncertainty_tpu_torch.evaln.dataloader import ResultsReader

    series = {}
    for m in METHODS:
        reader = ResultsReader(version_dir(tree["root"], m, 0) / "id")
        metrics, agg = reader.metrics(), reader.aggregated("TU")
        series[m] = ([1.0 - metrics[i]["metrics"]["dice"] for i in reader.image_ids],
                     [-agg[k]["image_level"]["max_score"] for i in reader.image_ids
                      for k in agg if k.startswith(i)])
    series["tied"] = ([0.1, 0.5, 0.2, 0.9, 0.4], [0.3, 0.3, 0.1, 0.3, 0.7])
    return series


CHARTS = ["barplot", "metric_matrix", "metric_matrix_grid", "au_eu_scatter", "scatter_grid",
          "training_curves", "ood_shift_panel", "al_improvement", "risk_coverage",
          "reliability"]


@pytest.mark.parametrize("name", CHARTS)
def test_chart_series_equal_what_jax_draws(tree, tmp_path, drawn, name):
    rows, df = tree["rows"], tree["df"]
    out = tmp_path / f"{name}.png"
    if name == "barplot":
        kw = dict(task="ood_detection", metric="auroc", out_path=out)
        got = chart(t_viz.barplot(rows, **kw))
        j_viz.barplot(df, **kw)
        bars = of(drawn, "bar")
        assert got["x"] == ["AU", "EU", "TU"] and len(bars) == len(got["series"]) == 8
        for (_, _, args, _), values in zip(bars, got["series"].values()):
            close(args[1], values)
    elif name in ("metric_matrix", "metric_matrix_grid"):
        cells = [("ood_detection", "auroc"), ("failure_detection", "aurc"),
                 ("calibration", "ace"), ("no_task", "x")]
        if name == "metric_matrix":
            table = t_viz.metric_matrix(rows, task="failure_detection", metric="aurc",
                                        out_path=out)
            got = {"cells": [chart(t_viz.chart_path(out))]}
            ref = [j_viz.metric_matrix(df, task="failure_detection", metric="aurc",
                                       out_path=out)]
            close(table.values, ref[0].values)
        else:
            got = chart(t_viz.metric_matrix_grid(rows, cells=cells, out_path=out, ncols=2))
            j_viz.metric_matrix_grid(df, cells=cells, out_path=out, ncols=2)
            ref = [j_viz.metric_matrix(df, task=t, metric=m) for t, m in cells[:3]]
            assert got["cells"][3] == {"task": "no_task", "metric": "x", "empty": True}
        for cell, pv, (_, _, args, _) in zip(got["cells"], ref, of(drawn, "imshow")):
            assert cell["index"] == list(pv.index) and cell["columns"] == list(pv.columns)
            close(cell["values"], args[0])
    elif name in ("au_eu_scatter", "scatter_grid"):
        cells = [("ood_detection", "auroc", "image_level"), ("segmentation", "dice", "-"),
                 ("calibration", "ace", "-")]
        if name == "au_eu_scatter":
            got = {"cells": [chart(t_viz.au_eu_scatter(rows, out_path=out))]}
            j_viz.au_eu_scatter(df, out_path=out)
        else:
            got = chart(t_viz.scatter_grid(rows, cells=cells, out_path=out))
            j_viz.scatter_grid(df, cells=cells, out_path=out)
            assert got["cells"][1]["empty"]  # segmentation has no AU row
            got["cells"] = [got["cells"][0], got["cells"][2]]
        for cell, (_, _, s, _), (_, _, p, _) in zip(got["cells"], of(drawn, "scatter"),
                                                    of(drawn, "plot")):
            assert cell["versions"] == list(s[0].index)
            close(cell["au"], s[0])
            close(cell["eu"], s[1])
            close(cell["diagonal"], p[0])
            close(cell["delta"], j_viz.entangle_metric(s[0].to_numpy(), s[1].to_numpy()))
    elif name == "training_curves":
        runs = curves_runs(tmp_path / "runs")
        curves = t_viz.merge_training_curves(runs)
        ref = j_viz.merge_training_curves(runs)
        assert curves == ref.to_dict("records")
        keys = ["train_loss", "val_dice", "missing"]
        path = t_viz.plot_training_curves(curves, keys, out)
        j_viz.plot_training_curves(ref, keys, out)
        assert json.loads(path.read_text())["keys"]["missing"] is None  # no data
        got = chart(path)
        lines, bands = iter(of(drawn, "plot")), iter(of(drawn, "fill_between"))
        for key in keys[:2]:
            for group, g in got["keys"][key].items():
                _, _, args, kw = next(lines)
                assert kw["label"] == group
                close(g["step"], args[0])
                close(g["mean"], args[1])
                if g["band"]:
                    _, _, (x, lo, hi), _ = next(bands)
                    sd = np.nan_to_num(g["std"])
                    close(x, g["step"])
                    close(lo, np.subtract(g["mean"], sd))
                    close(hi, np.add(g["mean"], sd))
        assert next(bands, None) is None and next(lines, None) is None
    elif name == "ood_shift_panel":
        srows = shift_rows(tree)
        got = chart(t_viz.ood_shift_panel(srows, out))
        j_viz.ood_shift_panel(pd.DataFrame(srows), out)
        assert got["x"] == ["id", "ood_blur", "ood_noise"]
        for (method, values), (_, _, args, kw) in zip(got["series"].items(), of(drawn, "plot")):
            assert kw["label"] == method
            close(values, args[1])
    elif name == "al_improvement":
        cycles = {"softmax_dropout": {"first": 0.6, "uncertainty": 0.62, "random": 0.61},
                  "ssn_none": {"first": 0.5, "random": 0.55, "worst": 0.52}}
        got = chart(t_viz.al_improvement_plot(cycles, out))
        j_viz.al_improvement_plot(cycles, out)
        bars = of(drawn, "bar")
        assert len(bars) == len(got["bars"]) == 4
        for bar, (_, _, args, kw) in zip(got["bars"], bars):
            assert bar["label"] == kw["label"]
            close(bar["x"], args[0])
            close(bar["height"], args[1])
            close(got["width"], kw["width"])
    elif name == "risk_coverage":
        from diffuncertainty_tpu.metrics.aurc import aurc

        series = rc_series(tree)
        got = chart(t_viz.risk_coverage_plot(series, out, title="t"))
        j_viz.risk_coverage_plot(series, out, title="t")
        for (label, s), (_, _, args, _) in zip(got["series"].items(), of(drawn, "plot")):
            close(s["coverage"], args[0])
            close(s["selective_risk"], args[1])
            close(s["aurc"], aurc(np.asarray(series[label][0]), np.asarray(series[label][1])))
    else:
        from diffuncertainty_tpu.evaln.tasks import calc_ace, calc_ece

        rng = np.random.default_rng(5)
        confids = np.concatenate([rng.random(500) * 0.6 + 0.4, [0.0, 1.0, 1.2]])
        correct = rng.random(confids.size) < confids
        got = chart(t_viz.reliability_diagram(correct, confids, out))
        j_viz.reliability_diagram(correct, confids, out)
        (_, _, acc, _), (_, _, dens, _) = of(drawn, "bar")
        _, (_, _, conf, _) = of(drawn, "plot")
        close(got["bin_centers"], acc[0])
        close(got["accuracy"], acc[1])
        close(got["confidence"], conf[1])
        close(got["density"], dens[1])
        clipped = np.clip(confids, 0, 1)
        close(got["ece"], calc_ece(correct.astype(float), clipped))
        close(got["ace"], calc_ace(correct.astype(float), clipped))
        assert got["title"] == f"ECE {got['ece']:.4f} · ACE {got['ace']:.4f}"


def test_chart_without_rows_raises_as_jax(tree, tmp_path):
    for fn, kw in ((t_viz.barplot, dict(task="x", metric="y")),
                   (t_viz.metric_matrix, dict(task="x", metric="y"))):
        with pytest.raises(ValueError, match="no rows"):
            fn(tree["rows"], out_path=tmp_path / "a.png", **kw)
    with pytest.raises(ValueError, match="both AU and EU"):
        t_viz.au_eu_scatter(tree["rows"], task="segmentation", metric="dice", aggregation="-",
                            out_path=tmp_path / "a.png")
    with pytest.raises(NotImplementedError, match="tensorboard"):
        t_viz.merge_training_curves({"r": tmp_path})


# ---- the image panels --------------------------------------------------------------


def raw_predictions(seed: int, ids, groups: int = 3) -> dict:
    """A ``collect_raw_predictions`` result: softmax stacks of 2 classes."""
    rng = np.random.default_rng(seed)
    records = []
    for iid in ids:
        logits = rng.normal(size=(groups, 2, HW, HW, 2)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        gt = np.zeros((RATERS, HW, HW), np.uint8)
        gt[:, 4:11, 5:12] = 1
        gt[1, 4:6] = 0
        records.append({"image_id": iid, "image": rng.random((HW, HW, 1), dtype=np.float32),
                        "gt": gt, "groups": probs, "mean": probs.mean(axis=(0, 1))})
    return {"split": "id", "records": records}


def grouped_tree(root: Path) -> Path:
    rng = np.random.default_rng(7)
    (root / "preprocessed" / "labels").mkdir(parents=True)
    with open(root / "preprocessed" / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image_file", "machine"])
        w.writeheader()
        for i in range(7):
            np.save(root / "preprocessed" / f"img_{i}.npy", rng.random((HW, HW, 3)))
            for r in range(2):
                mask = np.zeros((HW, HW), np.uint8)
                mask[3:12, 2 + r:13] = 1
                mask[6:9, 6:9] = 2
                np.save(root / "preprocessed" / "labels" / f"img_{i}_{r:02d}_mask.npy", mask)
            w.writerow({"image_file": f"img_{i}.npy", "machine": "ab"[i % 2]})
    return root


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    from diffuncertainty_tpu_torch.data.toy import generate_toy_dataset

    return generate_toy_dataset(tmp_path_factory.mktemp("toy") / "toy", num_train=6,
                                num_val=2, num_test=2, num_ood=2, size=HW, seed=3)


def tta_params(monkeypatch, n: int):
    """One TTA draw (the port's, seed 0, composed warp) handed to both functions."""
    import jax.numpy as jnp
    import torch

    p = t_tta.sample_tta_params(t_tta.TTAConfig(separable_warp=False),
                                torch.Generator().manual_seed(0), n, HW, HW)
    assert not p.separable
    monkeypatch.setattr(t_tta, "sample_tta_params", lambda *a, **k: p)
    monkeypatch.setattr(j_tta, "sample_tta_params", lambda *a, **k: j_tta.TTAParams(
        jnp.asarray(p.forward.numpy()), jnp.asarray(p.inverse.numpy()), False, 0, 0))


PANELS = ["prediction_grid", "uncertainty_panel", "triptych", "model_comparison",
          "model_comparison_one_group", "tta_augs", "dataset_overview", "grouped_rows"]


@pytest.mark.parametrize("name", PANELS)
def test_panel_canvas_is_what_jax_shows(tmp_path, drawn, monkeypatch, toy_dir, name):
    canvases = []

    def capture(canvas, out_path):
        canvases.append(canvas)
        return write_canvas(canvas, out_path)

    write_canvas = t_viz._write_canvas
    monkeypatch.setattr(t_viz, "_write_canvas", capture)
    raw = raw_predictions(1, ["a", "b", "c"])
    raws = {"softmax": raw, "ssn": raw_predictions(2, ["b", "a", "d"])}
    j_out, t_out = tmp_path / "jax.png", tmp_path / "port.png"
    tta_configs = {j_viz: j_tta.TTAConfig(separable_warp=False),
                   t_viz: t_tta.TTAConfig(separable_warp=False)}
    grouped = grouped_tree(tmp_path / "g") if name == "grouped_rows" else None
    calls = {
        "prediction_grid": lambda v, out: v.plot_prediction_grid(raw, out, max_samples=2),
        "uncertainty_panel": lambda v, out: v.uncertainty_panel(raw, out, max_rows=2),
        "triptych": lambda v, out: v.uncertainty_triptych_panel(raws, out, n_images=2),
        "model_comparison": lambda v, out: v.model_comparison_panel(raws, out, n_images=2,
                                                                    heatmap="EU"),
        "model_comparison_one_group": lambda v, out: v.model_comparison_panel(
            {"one": raw_predictions(4, ["a", "b"], groups=1)}, out),
        "tta_augs": lambda v, out: v.plot_tta_augs(raw["records"][0]["image"], out, n=3,
                                                   tta_config=tta_configs[v]),
        "dataset_overview": lambda v, out: v.dataset_overview_panel(toy_dir, out, n_rows=2),
        "grouped_rows": lambda v, out: v.grouped_rows_panel(grouped, out, n_cols=3,
                                                            label_cols=2),
    }
    if name == "tta_augs":
        tta_params(monkeypatch, 3)
    calls[name](j_viz, j_out)
    path = calls[name](t_viz, t_out)
    assert path == t_out and len(canvases) == 1
    shows = of(drawn, "imshow")
    (geometry,) = {where[2] for _, where, _, _ in shows}
    tiles = {where[:2]: t_viz.shown(np.asarray(args[0]), kw.get("vmin"), kw.get("vmax"))
             for _, where, args, kw in shows}
    assert len(tiles) == len(shows)  # one image per axes
    want = t_viz.panel_canvas(tiles, *geometry)
    np.testing.assert_allclose(canvases[0], want, rtol=0, atol=1e-5)
    png = np.asarray(Image.open(t_out).convert("RGB"), np.float64) / 255.0
    assert png.shape == want.shape
    assert np.abs(png - canvases[0]).max() <= 0.5 / 255 + 1e-9


def test_shown_scales_as_imshow():
    a = np.array([[0.0, 2.0], [1.0, np.nan]])
    np.testing.assert_array_equal(t_viz.shown(a)[..., 0], [[0.0, 1.0], [0.5, 1.0]])
    np.testing.assert_array_equal(t_viz.shown(a, vmin=0, vmax=4)[..., 1], [[0, 0.5], [0.25, 1]])
    np.testing.assert_array_equal(t_viz.shown(np.ones((2, 2))), np.zeros((2, 2, 3)))
    rgb = np.full((1, 1, 3), 1.5)
    np.testing.assert_array_equal(t_viz.shown(rgb), np.ones((1, 1, 3)))


# ---- checks and the report command line ------------------------------------------------


def test_checks_equal_jax(tree, tmp_path):
    vdir = version_dir(tree["root"], "softmax_none", 0)
    split = vdir / "id"
    assert t_checks.check_test_finished(split) == j_checks.check_test_finished(split)
    assert t_checks.check_test_finished(tmp_path) == j_checks.check_test_finished(tmp_path)
    partial = tmp_path / "partial"
    shutil.copytree(split, partial)
    (partial / "EU" / "id_01.tif").unlink()
    next((partial / "pred_seg").glob("id_02_*.png")).unlink()
    for f in (partial / "pred_seg").glob("id_03_*.png"):
        f.unlink()
    assert t_checks.check_test_finished(partial) == j_checks.check_test_finished(partial)
    assert t_checks.check_test_finished(partial, expect_heatmaps=False) == \
        j_checks.check_test_finished(partial, expect_heatmaps=False)
    dirs = {"id": split, "v": vdir, "none": tmp_path}
    for tasks in (None, ["area", "calibration"]):
        assert t_checks.check_eval_matrix(dirs, tasks) == j_checks.check_eval_matrix(dirs, tasks)
    for side, checks in (("jax", j_checks), ("port", t_checks)):
        root = tmp_path / side / "ckpt"
        for e in (3, 10, 7):
            (root / f"epoch_{e:06d}").mkdir(parents=True)
        (root / "last").mkdir()
        assert checks.keep_largest_epoch_checkpoint(root, dry_run=True) == [
            str(root / "epoch_000003"), str(root / "epoch_000007")]
        checks.keep_largest_epoch_checkpoint(root)
        assert sorted(p.name for p in root.iterdir()) == ["epoch_000010", "last"]


def test_backfill_tu_and_merge_metric_logs_equal_jax(tree, tmp_path):
    src = version_dir(tree["root"], "ssn_none", 1) / "ood_noise"
    for side, checks in (("jax", j_checks), ("port", t_checks)):
        d = tmp_path / side
        shutil.copytree(src, d)
        shutil.rmtree(d / "TU")
        (d / "TU").mkdir()
        shutil.copy(src / "TU" / "ood_noise_00.tif", d / "TU")  # kept as it is
        (d / "EU" / "ood_noise_05.tif").unlink()  # no EU: no TU
        assert checks.backfill_tu(d) == 4
        assert checks.backfill_tu(tmp_path / "none") == 0
    names = sorted(p.name for p in (tmp_path / "jax" / "TU").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "TU").iterdir())
    assert len(names) == 5
    for n in names:
        got = np.asarray(Image.open(tmp_path / "port" / "TU" / n), np.float64)
        ref = np.asarray(Image.open(tmp_path / "jax" / "TU" / n), np.float64)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    runs = curves_runs(tmp_path / "runs")
    resumed = tmp_path / "runs" / "resumed"
    resumed.mkdir()
    (resumed / "metrics.jsonl").write_text(json.dumps({"epoch": 2, "train_loss": 9.0}) + "\n"
                                           + json.dumps({"note": "no epoch"}) + "\n")
    dirs = [*runs.values(), resumed, tmp_path / "none"]
    assert t_checks.merge_metric_logs(dirs, tmp_path / "p.jsonl") == \
        j_checks.merge_metric_logs(dirs, tmp_path / "j.jsonl")
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()


def test_report_cli_equals_jax(tree, tmp_path, capsys):
    pattern = str(tree["root"] / "results" / "*" / "test_results4" / "s*" / "e3_ema" / "id")
    versions = t_report.discover_versions([pattern, str(tmp_path)])
    assert versions == j_report.discover_versions([pattern, str(tmp_path)])
    assert len(versions) == 8
    for flags in ([], ["--no-seed-grouping"]):
        args = [pattern, "--latex", str(tmp_path / "p.tex"), "--barplot",
                f"aurc:failure_detection:{tmp_path / 'p.png'}", *flags]
        got = t_report.main(args)
        ref = j_report.main([a.replace("p.", "j.") for a in args])
        got.to_csv(tmp_path / "p.csv")
        ref.to_csv(tmp_path / "j.csv")
        assert_frames_equal(pd.read_csv(tmp_path / "p.csv", header=[0, 1], index_col=[0, 1, 2, 3]),
                            pd.read_csv(tmp_path / "j.csv", header=[0, 1], index_col=[0, 1, 2, 3]))
        assert (tmp_path / "p.tex").read_text() == (tmp_path / "j.tex").read_text()
        series = chart(tmp_path / "p.json")
        assert list(series["series"]) == sorted(versions) and (tmp_path / "j.png").is_file()
    out = capsys.readouterr().out
    assert "collected 8 versions" in out and f"wrote {tmp_path / 'p.json'}" in out
    with pytest.raises(SystemExit, match="no evaluated result dirs"):
        t_report.main([str(tmp_path / "nothing")])
