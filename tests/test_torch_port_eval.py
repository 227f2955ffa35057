"""Port parity of the evaluation stack: ``diffuncertainty_tpu_torch/evaln``
against ``diffuncertainty_tpu/evaln`` on the same results trees.

No model runs. The trees are drawn with numpy from a seed: 32x32 images, 6-8
per split (``val``, ``id``, ``ood_noise``, ``ood_blur``), each with the mean
and three per-sample 0/255 grayscale PNG masks, TU/AU/EU float32 TIFFs and a
``metrics.json``; a three-class split of 24x32 palette masks whose heatmaps
are stored transposed (``mc``); and, in a second version, a split of one
sample per image with ``pred_entropy`` only (``one``). Ties are built in: two
equal patch maxima in one map, equal maps (so equal scores) inside ``id`` and
across ``id`` and ``ood_noise``, equal Dice values. Each tree is written
twice: through PIL, as the JAX job writes it (filtered rows, a short
palette), and through the port's ``infer/image_io``. Each evaluator reads its
own copy through its own ``MultiRaterDataset``.

Tolerances: the reader exact; aggregations, thresholds, failure detection,
ambiguity and AL 1e-12; AUROC 1e-12 and the detection rate exact; the Platt
parameters rtol 1e-5 + atol 1e-7 (the port's L-BFGS-B on its own loss
against scikit-learn's); the calibration errors atol 1e-6.
"""

import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

import diffuncertainty_tpu.evaln.aggregation as j_agg
import diffuncertainty_tpu.evaln.al_splits as j_al
import diffuncertainty_tpu.evaln.experiments as j_exp
import diffuncertainty_tpu.evaln.runner as j_runner
import diffuncertainty_tpu.evaln.tasks as j_tasks
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.data.dataset import MultiRaterDataset as JDataset
from diffuncertainty_tpu.evaln.dataloader import ResultsReader as JReader
import diffuncertainty_tpu_torch.evaln as t_evaln
import diffuncertainty_tpu_torch.evaln.aggregation as t_agg
import diffuncertainty_tpu_torch.evaln.al_splits as t_al
import diffuncertainty_tpu_torch.evaln.experiments as t_exp
import diffuncertainty_tpu_torch.evaln.runner as t_runner
import diffuncertainty_tpu_torch.evaln.tasks as t_tasks
from diffuncertainty_tpu_torch.core.config import load_config as t_load_config
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset as TDataset
from diffuncertainty_tpu_torch.evaln.dataloader import ResultsReader as TReader
from diffuncertainty_tpu_torch.infer.image_io import write_png, write_tiff
from torch_threads import one_torch_thread  # noqa: F401

HW, MC_SHAPE, RATERS = 32, (24, 32), 3
SPLITS = {"val": 6, "id": 8, "ood_noise": 6, "ood_blur": 6}
SHORT_PALETTE = [0, 0, 0, 200, 30, 30, 30, 200, 30]  # three classes: PIL writes 2 bits
V0 = Path("exp") / "test_results3" / "v0" / "e3"  # val, id, ood_*, mc
V1 = Path("exp") / "test_results3" / "v1" / "e3"  # one
TASKS = ["threshold", "area", "aggregation", "ood_detection", "failure_detection",
         "ambiguity_modeling", "calibration"]
PAIRS = [("id", "ood_noise"), ("id", "ood_blur")]
EXACT = dict(rtol=0, atol=1e-12)


def make_content(seed: int = 0) -> dict:
    """split -> image id -> masks (``mean`` None for one sample), heatmaps,
    Dice, rater masks and whether the masks are palette masks."""
    rng = np.random.default_rng(seed)
    content: dict = {}
    for split, n in SPLITS.items():
        recs = content[split] = {}
        for i in range(n):
            samples = [(rng.random((HW, HW)) > 0.6).astype(np.uint8) for _ in range(3)]
            au = rng.random((HW, HW), dtype=np.float32) * np.float32(0.5)
            eu = rng.random((HW, HW), dtype=np.float32) * np.float32(0.2)
            if split.startswith("ood"):
                eu = eu + np.float32(0.1)
            recs[f"{split}_{i:02d}"] = {
                "samples": samples, "mean": (np.sum(samples, 0) >= 2).astype(np.uint8),
                "maps": {"TU": au + eu, "AU": au, "EU": eu}, "dice": float(rng.random()),
                "refs": (rng.random((RATERS, HW, HW)) > 0.7).astype(np.uint8), "palette": False}
    ids = content["id"]
    tu = np.full((HW, HW), 0.1, np.float32)
    tu[2:10, 3:11] = tu[20:28, 18:26] = 0.9  # two equal patch maxima
    ids["id_00"]["maps"]["TU"] = tu
    for other in (ids["id_02"], content["ood_noise"]["ood_noise_01"]):  # tied scores
        other["maps"] = {k: v.copy() for k, v in ids["id_01"]["maps"].items()}
    ids["id_04"]["dice"] = ids["id_03"]["dice"]
    content["mc"] = {}
    for i in range(6):
        samples = [rng.integers(0, 3, MC_SHAPE).astype(np.uint8) for _ in range(3)]
        au = rng.random(MC_SHAPE[::-1], dtype=np.float32)  # stored transposed
        eu = rng.random(MC_SHAPE[::-1], dtype=np.float32) * np.float32(0.3)
        content["mc"][f"mc_{i:02d}"] = {
            "samples": samples, "mean": samples[0], "maps": {"TU": au + eu, "AU": au, "EU": eu},
            "dice": float(rng.random()), "palette": True,
            "refs": rng.integers(0, 3, (RATERS,) + MC_SHAPE).astype(np.uint8)}
    content["one"] = {}
    for i in range(6):
        content["one"][f"one_{i:02d}"] = {
            "samples": [(rng.random((HW, HW)) > 0.5).astype(np.uint8)], "mean": None,
            "maps": {"pred_entropy": rng.random((HW, HW), dtype=np.float32)},
            "dice": float(rng.random()), "palette": False,
            "refs": (rng.random((RATERS, HW, HW)) > 0.5).astype(np.uint8)}
    return content


def write_dataset(root: Path, content: dict) -> Path:
    proc = root / "preprocessed"
    (proc / "images").mkdir(parents=True)
    (proc / "labels").mkdir()
    fold = {"_meta": {"num_raters": RATERS, "dataset_name": "toy"}, "train": []}
    for split, recs in content.items():
        fold[split] = []
        for iid, rec in recs.items():
            np.save(proc / "images" / f"{iid}.npy", np.zeros(rec["refs"].shape[1:], np.float32))
            for r, mask in enumerate(rec["refs"]):
                np.save(proc / "labels" / f"{iid}_{r:02d}_mask.npy", mask)
            fold[split].append(f"images/{iid}.npy")
    fold["unlabeled"] = [f"images/unl_{i:02d}.npy" for i in range(9)]
    splits = root / "splits" / "default" / "firstCycle" / "splits.pkl"
    splits.parent.mkdir(parents=True)
    splits.write_bytes(pickle.dumps([fold]))
    return splits


def save_png(path: Path, mask: np.ndarray, palette: bool, writer: str) -> None:
    if writer == "pil":  # as the JAX job's ResultsWriter
        if palette:
            img = Image.fromarray(mask, mode="P")
            img.putpalette(SHORT_PALETTE)
        else:
            img = Image.fromarray(mask * np.uint8(255), mode="L")
        img.save(path, compress_level=1)
    elif palette:
        write_png(path, mask, SHORT_PALETTE, mode="P")
    else:
        write_png(path, mask * np.uint8(255))


def write_split(split_dir: Path, recs: dict, writer: str) -> None:
    pred = split_dir / "pred_seg"
    pred.mkdir(parents=True)
    for iid, rec in recs.items():
        masks = [(f"{iid}_{k + 1:02d}", s) for k, s in enumerate(rec["samples"])]
        if rec["mean"] is not None:
            masks.insert(0, (f"{iid}_mean", rec["mean"]))
        for name, mask in masks:
            save_png(pred / f"{name}.png", mask, rec["palette"], writer)
        for unc, arr in rec["maps"].items():
            (split_dir / unc).mkdir(exist_ok=True)
            if writer == "pil":
                Image.fromarray(arr, mode="F").save(split_dir / unc / f"{iid}.tif")
            else:
                write_tiff(split_dir / unc / f"{iid}.tif", arr)
    metrics = {iid: {"dataset": "toy", "metrics": {"dice": rec["dice"]}}
               for iid, rec in recs.items()}
    (split_dir / "metrics.json").write_text(json.dumps(metrics))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The content, its dataset and one results tree per writer."""
    root = tmp_path_factory.mktemp("eval")
    content = make_content()
    splits = write_dataset(root / "data", content)
    for writer in ("pil", "port"):
        for split, recs in content.items():
            write_split(root / writer / (V1 if split == "one" else V0) / split, recs, writer)
    return {"root": root, "content": content, "splits": splits, "data": root / "data"}


@pytest.fixture
def pair(world, tmp_path):
    """A copy of the port-written tree for each evaluator (JAX, port)."""
    dirs = {}
    for side in ("jax", "port"):
        shutil.copytree(world["root"] / "port", tmp_path / side)
        dirs[side] = tmp_path / side
    return dirs


def datasets(world, split):
    return (JDataset(world["splits"], world["data"], split=split),
            TDataset(world["splits"], world["data"], split=split))


def readers(world, dirs, split, version=V0, with_dataset=True):
    ds = datasets(world, split) if with_dataset else (None, None)
    return (JReader(dirs["jax"] / version / split, ds[0]),
            TReader(dirs["port"] / version / split, ds[1]))


def assert_json_close(got, ref, path="", **tol):
    """Same structure, keys in the same order, numbers to ``tol``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            assert_json_close(got[k], ref[k], f"{path}/{k}", **tol)
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_json_close(g, r, f"{path}[{i}]", **tol)
    elif isinstance(ref, float) and isinstance(got, float):
        np.testing.assert_allclose(got, ref, err_msg=path, **(tol or EXACT))
    else:
        assert got == ref, (path, got, ref)


def assert_same_outputs(j_dir: Path, t_dir: Path, **tol) -> list[Path]:
    """The same files under both trees, every JSON file close."""
    files = sorted(p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".json":
            assert_json_close(json.loads((t_dir / rel).read_text()),
                              json.loads((j_dir / rel).read_text()), str(rel), **tol)
    return files


# ---- the reader -----------------------------------------------------------


@pytest.mark.parametrize("writer", ["pil", "port"])
def test_reader_reads_either_writers_tree_as_jax_does(world, writer):
    base = world["root"] / writer
    for split in [*SPLITS, "mc", "one"]:
        split_dir = base / (V1 if split == "one" else V0) / split
        j_ds, t_ds = datasets(world, split)
        ref, got = JReader(split_dir, j_ds), TReader(split_dir, t_ds)
        assert got.image_ids == ref.image_ids == sorted(world["content"][split])
        assert got.unc_types == ref.unc_types
        assert got.metrics() == ref.metrics()
        for iid in ref.image_ids:
            rec = world["content"][split][iid]
            mean = got.get_mean_pred_seg(iid)
            np.testing.assert_array_equal(mean, ref.get_mean_pred_seg(iid))
            assert mean.dtype == np.uint8
            np.testing.assert_array_equal(mean, rec["samples"][0] if rec["mean"] is None
                                          else rec["mean"])
            segs, j_segs = got.get_pred_segs(iid), ref.get_pred_segs(iid)
            assert len(segs) == len(j_segs) == len(rec["samples"])
            for s, j_s in zip(segs, j_segs):
                np.testing.assert_array_equal(s, j_s)
            for unc in ref.unc_types:
                m = got.get_unc_map(iid, unc)
                assert m.dtype == np.float32
                np.testing.assert_array_equal(m, ref.get_unc_map(iid, unc))
            np.testing.assert_array_equal(got.get_reference_segs(iid),
                                          ref.get_reference_segs(iid))
            gt = got.get_gt_unc_map(iid)
            assert gt.dtype == np.float64
            np.testing.assert_array_equal(gt, ref.get_gt_unc_map(iid))
    with pytest.raises(ValueError, match="require a dataset"):
        TReader(base / V0 / "id").get_reference_segs("id_00")


# ---- aggregations and thresholds ----------------------------------------

AGGREGATIONS = ["image_level", "patch_level", "threshold", "area_normalized",
                "border_normalized"]


@pytest.mark.parametrize("name", AGGREGATIONS + ["shape_stats", "foreground_quantile",
                                                 "find_threshold"])
def test_aggregations_and_thresholds_equal_jax(world, pair, name):
    j_id, t_id = readers(world, pair, "id")
    j_mc, t_mc = readers(world, pair, "mc")
    if name in AGGREGATIONS:
        fn = name + "_aggregation"
        for reader, t_reader in ((j_id, t_id), (j_mc, t_mc)):
            stats = j_agg.compute_prediction_shape_stats(reader)
            assert t_agg.compute_prediction_shape_stats(t_reader) == stats
            for iid in reader.image_ids:
                for unc in reader.unc_types:
                    image = reader.get_unc_map(iid, unc)
                    kw = {"threshold": 0.3, "area": stats[iid]["area"],
                          "border": stats[iid]["border"]}
                    assert_json_close(getattr(t_agg, fn)(image, **kw),
                                      getattr(j_agg, fn)(image, **kw))
        # the tied maxima: the box starts at the first of them
        tied = t_agg.patch_level_aggregation(t_id.get_unc_map("id_00", "TU"))
        assert tied["bounding_box"] == [(2, 10), (3, 11)]
        if name == "threshold":  # the thresholds come from the version's analysis file
            j_agg.find_threshold([j_id, j_mc], j_id.split_dir.parent)
            t_agg.find_threshold([t_id, t_mc], t_id.split_dir.parent)
        for reader, t_reader in ((j_id, t_id), (j_mc, t_mc)):
            j_agg.aggregate_uncertainties(reader, aggregations=(name,))
            t_agg.aggregate_uncertainties(t_reader, aggregations=(name,))
        rec = json.loads((t_id.split_dir / "aggregated_TU.json").read_text())["id_00.tif"]
        assert name in rec
    elif name == "shape_stats":
        for reader, t_reader in ((j_id, t_id), (j_mc, t_mc)):
            assert t_agg.compute_prediction_shape_stats(t_reader) == \
                j_agg.compute_prediction_shape_stats(reader)
    elif name == "foreground_quantile":
        for reader, t_reader in ((j_id, t_id), (j_mc, t_mc), readers(world, pair, "one", V1)):
            np.testing.assert_allclose(t_agg.foreground_quantile(t_reader),
                                       j_agg.foreground_quantile(reader), **EXACT)
    else:
        ref = j_agg.find_threshold([j_id, j_mc], j_id.split_dir.parent, pred_model="m")
        got = t_agg.find_threshold([t_id, t_mc], t_id.split_dir.parent, pred_model="m")
        assert_json_close(got, ref)
        assert list(got["m"]) == ["Mean TU threshold", "Mean AU threshold", "Mean EU threshold"]
    assert_same_outputs(pair["jax"], pair["port"])


# ---- the tasks ------------------------------------------------------------


def aggregate_both(world, pair, splits, version=V0):
    out = {}
    for split in splits:
        out[split] = readers(world, pair, split, version)
        j_agg.aggregate_uncertainties(out[split][0])
        t_agg.aggregate_uncertainties(out[split][1])
    return out


def test_failure_detection_ambiguity_and_al_improvement_equal_jax(world, pair):
    rd = aggregate_both(world, pair, ["id", "mc"])
    rd.update(aggregate_both(world, pair, ["one"], V1))
    for j_r, t_r in rd.values():
        ref = j_tasks.failure_detection(j_r, j_r.split_dir / "failure_detection.json")
        assert_json_close(t_tasks.failure_detection(t_r, t_r.split_dir / "failure_detection.json"),
                          ref)
        assert_json_close(t_tasks.ambiguity_modeling(t_r), j_tasks.ambiguity_modeling(j_r))
    assert set(json.loads((rd["one"][1].split_dir / "failure_detection.json").read_text())["mean"]
               ) == {"pred_entropy"}
    for dice in ((0.8, 0.85, 0.82), (0.5, 0.4, 0.45), (0.7, 0.7, 0.7)):
        np.testing.assert_allclose(t_tasks.al_improvement(*dice), j_tasks.al_improvement(*dice),
                                   **EXACT)
    assert_same_outputs(pair["jax"], pair["port"])


def test_ood_detection_equals_jax_with_tied_scores(world, pair):
    rd = aggregate_both(world, pair, ["id", "ood_noise", "ood_blur"])
    scores = [r["image_level"]["max_score"] for s in ("id", "ood_noise")
              for r in rd[s][1].aggregated("TU").values()]
    assert len(set(scores)) < len(scores)  # the case holds ties
    for id_split, ood_split in PAIRS:
        key = f"{id_split}&{ood_split}"
        ref = j_tasks.ood_detection_paired(rd[id_split][0], rd[ood_split][0],
                                           pair["jax"] / V0 / "ood_detection.json", key)
        got = t_tasks.ood_detection_paired(rd[id_split][1], rd[ood_split][1],
                                           pair["port"] / V0 / "ood_detection.json", key)
        assert_json_close(got, ref)
    assert_same_outputs(pair["jax"], pair["port"])
    # the rank form against scikit-learn's trapezoid, ties included
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(5)
    for _ in range(20):
        labels = rng.integers(0, 2, 30)
        labels[:2] = (0, 1)
        scores = np.round(rng.random(30), 1)
        np.testing.assert_allclose(t_tasks.auroc(labels, scores), roc_auc_score(labels, scores),
                                   **EXACT)


def platt_inputs(case: str):
    """Binned Platt samples as ``platt_scale_params`` builds them: F the
    negative mean uncertainty per bin, one sample per class, weighted by
    its pixel count."""
    rng = np.random.default_rng(11)
    n = 40
    f = -np.sort(rng.random(n)) * (60.0 if case == "large" else 2.0)
    p = 1.0 / (1.0 + np.exp(-(3.0 * f / np.abs(f).max() + 2.0)))
    pos = rng.binomial(500, p)
    fs, ys, ws = [], [], []
    for b in range(n):
        for label, count in ((1.0, pos[b]), (0.0, 500 - pos[b])):
            if count > 0 and (case != "one_class" or label == 1.0):
                fs.append(f[b])
                ys.append(label)
                ws.append(float(count))
    return np.asarray(fs), np.asarray(ys), np.asarray(ws)


@pytest.mark.parametrize("case", ["normal", "large", "one_class"])
def test_platt_fit_equals_scikit_learns(case):
    f, y, w = platt_inputs(case)
    if case == "large":
        assert np.abs(f).max() >= 30
    ref = j_tasks._sigmoid_calibration(f, y, w)  # scikit-learn's fit
    got = t_tasks._sigmoid_calibration(f, y, w)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("split,ignore_value", [("id", None), ("id", 0), ("mc", None),
                                                ("mc", 2)])
def test_calibration_equals_jax(world, pair, split, ignore_value):
    j_val, t_val = readers(world, pair, "val")
    j_r, t_r = readers(world, pair, split)
    ref_params = j_tasks.platt_scale_params(j_val, ignore_value=ignore_value)
    got_params = t_tasks.platt_scale_params(t_val, ignore_value=ignore_value)
    assert_json_close(got_params, ref_params, rtol=1e-5, atol=1e-7)
    ref = j_tasks.calibration(j_r, j_val, ignore_value=ignore_value)
    got = t_tasks.calibration(t_r, t_val, ignore_value=ignore_value)
    assert_json_close(got, ref, rtol=0, atol=1e-6)
    for unc in ("TU", "AU", "EU"):
        assert 0 <= got["mean"][unc]["metrics"]["gece"] <= 1
    assert_same_outputs(pair["jax"], pair["port"], rtol=1e-5, atol=1e-6)
    # the parameters now come from the version's file
    (t_r.split_dir / "calibration.json").unlink()
    assert t_tasks.calibration(t_r, ignore_value=ignore_value) == got
    with pytest.raises(ValueError, match="val_reader"):
        t_tasks.calibration(t_r, platt_file=t_r.split_dir / "absent.json")


# ---- active-learning splits ---------------------------------------------


@pytest.mark.parametrize("strategy", ["uncertainty", "random", "best", "worst"])
def test_second_cycle_splits_equal_jax(world, tmp_path, strategy):
    rng = np.random.default_rng(3)
    scores = np.round(rng.random(9), 1)
    scores[4] = scores[2]  # a tie
    agg = {f"unl_{i:02d}.tif": {"image_level": {"max_score": float(s)}}
           for i, s in enumerate(scores)}
    agg["not_in_pool.tif"] = {"image_level": {"max_score": 9.0}}
    agg_file = tmp_path / "aggregated_TU.json"
    agg_file.write_text(json.dumps(agg))
    kw = dict(strategy=strategy, seed=4, fraction=0.5)
    ref = j_al.generate_second_cycle_splits(world["splits"], agg_file, tmp_path / "j.pkl", **kw)
    got = t_al.generate_second_cycle_splits(world["splits"], agg_file, tmp_path / "t.pkl", **kw)
    assert got == ref and len(got) == 5
    j_folds, t_folds = (pickle.loads((tmp_path / n).read_bytes()) for n in ("j.pkl", "t.pkl"))
    assert t_folds == j_folds
    assert set(got) <= set(world["content"]) | {f"images/unl_{i:02d}.npy" for i in range(9)}
    assert t_al.sorted_by_uncertainty(agg, "image_level") == \
        j_al.sorted_by_uncertainty(agg, "image_level")
    assert t_al.samples_to_query(list("abcde"), 0.4) == j_al.samples_to_query(list("abcde"), 0.4)
    with pytest.raises(ValueError):
        t_al.generate_second_cycle_splits(world["splits"], agg_file, tmp_path / "x.pkl",
                                          strategy="nope")


# ---- the runner -----------------------------------------------------------


def test_eval_runner_and_skip_finished_equal_jax(world, pair):
    tasks = ["threshold", "area", "aggregation", "failure_detection", "ambiguity_modeling",
             "calibration"]
    summaries = {}
    for split in ("id", "mc"):
        for side, runner_mod, ds, val_ds in zip(("jax", "port"), (j_runner, t_runner),
                                                datasets(world, split), datasets(world, "val")):
            runner = runner_mod.EvalRunner(pair[side] / V0 / split, ds,
                                           val_split_dir=pair[side] / V0 / "val",
                                           val_dataset=val_ds)
            summaries[side, split] = runner.run(tasks)
            summaries[side, split, "again"] = runner.run(tasks)
    for key in [("id",), ("mc",), ("id", "again"), ("mc", "again")]:
        assert summaries[("port",) + key] == summaries[("jax",) + key]
    # the second split finds the first's thresholds in the version directory
    assert summaries["port", "mc"]["threshold"] == "skipped (finished)"
    assert set(summaries["port", "id", "again"].values()) == {"skipped (finished)"}
    assert_same_outputs(pair["jax"], pair["port"], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown eval task"):
        t_runner.EvalRunner(pair["port"] / V0 / "id", skip_finished=False).run(["nope"])
    # paired OoD through the runner's helper
    out = {}
    for side, runner_mod in (("jax", j_runner), ("port", t_runner)):
        runner_mod.EvalRunner(pair[side] / V0 / "ood_noise").run(["aggregation"])
        out[side] = runner_mod.run_ood_detection(pair[side] / V0 / "id",
                                                 pair[side] / V0 / "ood_noise")
    assert_json_close(out["port"], out["jax"])
    assert list(out["port"]) == ["id&ood_noise"]


@pytest.mark.parametrize("with_dataset", [True, False])
def test_run_default_evaluation_equals_jax(world, pair, tmp_path, capsys, monkeypatch,
                                           with_dataset):
    data_dir = world["data"] if with_dataset else tmp_path / "no_data"
    # the runner's ignore_value is the config's ignore_index unless that is 0
    ignore_index = -1 if with_dataset else 0
    overrides = [f"data.data_input_dir={data_dir}", "data.split_name=default",
                 f"data.ignore_index={ignore_index}"]
    j_cfg = j_load_config(overrides=overrides)
    t_cfg = t_load_config(overrides=overrides)
    ignore_values = {"jax": [], "port": []}
    for side, mod in (("jax", j_runner), ("port", t_runner)):
        def spy(self, *args, _init=mod.EvalRunner.__init__, _seen=ignore_values[side], **kw):
            _seen.append(kw["ignore_value"])
            _init(self, *args, **kw)

        monkeypatch.setattr(mod.EvalRunner, "__init__", spy)
    for version, split in ((V0, "id"), (V0, "ood_noise"), (V1, "one")):
        ref = j_runner.run_default_evaluation(pair["jax"] / version / split, j_cfg)
        got = t_runner.run_default_evaluation(pair["port"] / version / split, t_cfg)
        assert got == ref
        assert ("ambiguity_modeling" in got) == with_dataset
    assert ignore_values["port"] == ignore_values["jax"] == [-1 if with_dataset else None] * 3
    err = capsys.readouterr().err
    assert ("ambiguity_modeling is left out" in err) == (not with_dataset)
    assert_same_outputs(pair["jax"], pair["port"])


# ---- the evaluation matrix ----------------------------------------------


def experiments(seeds=(0,), **extra):
    """One experiment per seed; version 1 holds ``pred_entropy`` maps only."""
    return [{"iter_params": {"pred_model": ["exp"], "seed": [seed]}, "exp_name": "{pred_model}",
             "naming_scheme_version": "v{seed}/e3", "n_pred": 3,
             **({"unc_types": ["pred_entropy"]} if seed == 1 else {}), **extra} for seed in seeds]


def matrices(world, pair, version_list=None, **kw):
    """A JAX and a port ``EvalMatrix`` over their copies, each with its own
    dataset factory, both logging into lists."""
    logs = {"jax": [], "port": []}
    out = []
    for side, mod, ds_cls in (("jax", j_exp, JDataset), ("port", t_exp, TDataset)):
        versions = mod.expand_versions(pair[side], version_list or experiments())

        def factory(version, split, _cls=ds_cls):
            try:
                return _cls(world["splits"], world["data"], split=split)
            except ValueError:
                return None

        out.append(mod.EvalMatrix(versions, dataset_factory=factory, log=logs[side].append,
                                  paired_splits=PAIRS, **kw))
    return out[0], out[1], logs


def relative(statuses: dict, base: Path) -> dict:
    return {Path(k).relative_to(base).as_posix(): v for k, v in statuses.items()}


def test_expand_versions_equals_jax(tmp_path):
    exps = [{"iter_params": {"pred_model": ["a", "b"], "seed": [0, 1, 2]},
             "naming_scheme_version": "s{seed}", "n_pred": 8,
             "prediction_models": {"b": {"only_pu": True, "epoch": 9}}},
            {"iter_params": {"pred_model": ["c"], "epoch": [1, 40]}, "exp_name": "x_{pred_model}",
             "naming_scheme_version": "v/e{epoch}", "aggregations": ["image_level"],
             "skip_missing": True}]
    ref = j_exp.expand_versions(tmp_path, exps, skip_finished=True)
    got = t_exp.expand_versions(tmp_path, exps, skip_finished=True)
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert (g.exp_path, g.label(), g.results_dir, g.version_name, g.unc_types,
                g.aggregations, g.skip_missing, g.skip_finished, dict(g.params)) == (
            r.exp_path, r.label(), r.results_dir, r.version_name, r.unc_types,
            r.aggregations, r.skip_missing, r.skip_finished, dict(r.params))
    version = t_evaln.ExperimentVersion(tmp_path, "m", params={"seed": 1})
    assert version.exp_path == tmp_path / "m" / "test_results" / "version_1"
    assert version.split_dirs() == []


def test_matrix_preflight_run_and_finish_equal_jax(world, pair):
    ghost = experiments(seeds=(7,))
    j_m, t_m, logs = matrices(world, pair, experiments() + ghost)
    for m, side in ((j_m, "jax"), (t_m, "port")):
        statuses = relative(m.classify(TASKS), pair[side])
        assert statuses == relative(j_m.classify(TASKS), pair["jax"])
    assert t_m.status_summary() == j_m.status_summary()
    assert "Missing: 1" in t_m.status_summary()
    with pytest.raises(FileNotFoundError, match="no evaluable results"):
        t_m.run(TASKS)
    j_m, t_m, logs = matrices(world, pair)
    ref, got = j_m.run(TASKS), t_m.run(TASKS)
    assert got == ref == {t: "done" for t in TASKS}
    assert logs["port"] == logs["jax"]
    files = assert_same_outputs(pair["jax"], pair["port"], rtol=1e-5, atol=1e-6)
    names = {f.name for f in files}
    assert {"ood_detection.json", "platt_scale_params.json", "threshold_analysis.json",
            "quantile_analysis.json", "calibration.json"} <= names
    assert not (pair["port"] / V0 / "val" / "calibration.json").exists()  # the Platt split
    assert all(s["finished"] for s in t_m.classify(TASKS).values())
    report = {}
    for side, m, mod in (("jax", j_m, j_exp), ("port", t_m, t_exp)):
        report[side] = mod.write_matrix_report(m, pair[side] / "report.json")
        report[side]["versions"] = relative(report[side]["versions"], pair[side])
    assert report["port"] == report["jax"]


def test_matrix_skip_finished_and_skip_missing_equal_jax(world, pair):
    tasks = ["threshold", "area", "aggregation"]
    j_m, t_m, _ = matrices(world, pair)
    j_m.run(tasks)
    t_m.run(tasks)
    mtime = (pair["port"] / V0 / "threshold_analysis.json").stat().st_mtime_ns
    j_m, t_m, logs = matrices(world, pair, experiments(skip_finished=True))
    assert t_m.run(tasks) == j_m.run(tasks)
    assert (pair["port"] / V0 / "threshold_analysis.json").stat().st_mtime_ns == mtime
    ghost = experiments(seeds=(7,), skip_missing=True)
    j_m, t_m, logs = matrices(world, pair, ghost)
    assert t_m.run(["area"]) == j_m.run(["area"]) == {"area": "done"}
    assert logs["port"] == logs["jax"]


@pytest.mark.parametrize("cleanup", ["cleanup", "cleanup_finished"])
def test_matrix_cleanups_equal_jax(world, pair, cleanup):
    tasks = ["threshold", "area", cleanup]
    j_m, t_m, _ = matrices(world, pair, experiments(seeds=(0, 1)))
    if cleanup == "cleanup_finished":  # nothing finished yet: nothing goes
        assert t_m.cleanup(only_finished=True, tasks=tasks) == \
            j_m.cleanup(only_finished=True, tasks=tasks) == []
    assert t_m.run(tasks) == j_m.run(tasks)
    for split_dir in (V0 / "id", V0 / "mc", V1 / "one"):
        for sub in ("TU", "AU", "EU", "pred_seg"):
            assert not (pair["port"] / split_dir / sub).exists()
        assert (pair["port"] / split_dir / "area.json").is_file()
    assert (pair["port"] / V1 / "one" / "pred_entropy").is_dir()  # not a folder it removes
    assert_same_outputs(pair["jax"], pair["port"])


def test_matrix_unknown_task_raises_as_jax(world, pair):
    j_m, t_m, _ = matrices(world, pair)
    with pytest.raises(ValueError, match="unknown eval tasks") as ref:
        j_m.run(["not_a_task"])
    with pytest.raises(ValueError, match="unknown eval tasks") as got:
        t_m.run(["not_a_task"])
    assert str(got.value) == str(ref.value)


# ---- the command line -----------------------------------------------------


@pytest.mark.parametrize("form", ["yaml", "json"])
def test_experiments_cli_equals_jax(world, pair, capsys, form):
    cfg_files = {}
    for side in ("jax", "port"):
        config = {"base_path": str(pair[side]), "experiments": experiments(),
                  "paired_splits": [list(p) for p in PAIRS], "calibration_val_split": "val",
                  "dataset": {"splits_path": str(world["splits"]),
                              "data_input_dir": str(world["data"])}}
        if form == "json":  # a task list of its own (YAML: the default, no cleanup)
            config["tasks"] = ["threshold", "area", "aggregation", "ood_detection"]
        cfg_files[side] = pair[side].parent / f"{side}.{form}"
        # the JAX command line reads YAML only (and JSON is YAML)
        cfg_files[side].write_text(yaml.safe_dump(config) if form == "yaml"
                                   else json.dumps(config, indent=2))
    out = {}
    for side, main in (("jax", j_exp.main), ("port", t_exp.main)):
        report = pair[side].parent / f"{side}_report.json"
        assert main(["--config", str(cfg_files[side]), "--preflight-only",
                     "--report", str(report)]) == {}
        out[side] = capsys.readouterr().out
        data = json.loads(report.read_text())
        data["versions"] = relative(data["versions"], pair[side])
        out[side, "report"] = data
    assert out["port"] == out["jax"] and "Missing x Finished matrix" in out["port"]
    assert out["port", "report"] == out["jax", "report"]
    assert not (pair["port"] / V0 / "quantile_analysis.json").exists()
    tasks = TASKS if form == "yaml" else ["threshold", "area", "aggregation", "ood_detection"]
    assert t_exp.main(["--config", str(cfg_files["port"])]) == j_exp.main(
        ["--config", str(cfg_files["jax"])]) == {t: "done" for t in tasks}
    assert_same_outputs(pair["jax"], pair["port"], rtol=1e-5, atol=1e-6)
    assert (pair["port"] / V0 / "id" / "pred_seg").is_dir()  # no cleanup by default


@pytest.mark.parametrize("text,message", [
    ("a: &x 1\n", "anchor"),
    ("a: {b: 1}\n", "flow mapping"),
    ("a: |\n  text\n", "block scalar"),
    ("a: 1\n  b: 2\n", "unexpected"),
    ("a: 'open\n", "unterminated"),
    ("- a\nb: 1\n", "unexpected"),
    ("{not json\n", "not JSON"),
])
def test_config_reader_refuses_other_yaml_forms(text, message):
    with pytest.raises(ValueError, match=message):
        t_exp.read_config(text)

