"""Completeness checkers and experiment-directory maintenance (port of
``diffuncertainty_tpu/tools/checks.py``, numpy only).

Reference: ``global_utils/check_test_script_finished.py``,
``check_eval_matrix.py``, ``keep_largest_epoch_model.py``, ``create_TU.py``
and the tfevents merge: the ops tooling of the reference workflow. The TU
maps ``backfill_tu`` writes are float32 TIFFs through ``infer/image_io.py``,
the form the JAX package's PIL writes.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from ..infer.image_io import read_tiff, write_tiff

_EXPECTED_TEST_FILES = ("metrics.json",)
_EVAL_TASK_FILES = {
    "aggregation": "aggregated_TU.json",
    "area": "area.json",
    "failure_detection": "failure_detection.json",
    "calibration": "calibration.json",
    "ambiguity_modeling": "ambiguity_modeling.json",
}


def check_test_finished(split_dir: str | Path, *, expect_heatmaps: bool = True) -> dict:
    """Classify a results split dir as finished / partial / missing.

    A finished dir has metrics.json whose ids all have pred_seg files and
    (when expected) heatmaps for every uncertainty type present.
    """
    split_dir = Path(split_dir)
    result = {"dir": str(split_dir), "status": "missing", "problems": []}
    metrics_file = split_dir / "metrics.json"
    if not metrics_file.exists():
        return result
    metrics = json.loads(metrics_file.read_text())
    ids = [k for k in metrics if k != "mean"]
    result["n_images"] = len(ids)
    pred_dir = split_dir / "pred_seg"
    for image_id in ids:
        if not list(pred_dir.glob(f"{image_id}_*.png")):
            result["problems"].append(f"no pred_seg for {image_id}")
    if expect_heatmaps:
        unc_dirs = [d for d in ("TU", "AU", "EU", "pred_entropy") if (split_dir / d).exists()]
        if not unc_dirs:
            result["problems"].append("no uncertainty heatmap dirs")
        for unc in unc_dirs:
            missing = [i for i in ids if not (split_dir / unc / f"{i}.tif").exists()]
            if missing:
                result["problems"].append(f"{unc}: {len(missing)} heatmaps missing")
    result["status"] = "finished" if not result["problems"] else "partial"
    return result


def check_eval_matrix(version_dirs: dict[str, str | Path], tasks=None) -> dict:
    """Matrix of (version x eval task) -> done/missing (check_eval_matrix.py)."""
    tasks = tasks or list(_EVAL_TASK_FILES)
    matrix: dict = {}
    for version, vdir in version_dirs.items():
        vdir = Path(vdir)
        matrix[version] = {task: "done" if (vdir / _EVAL_TASK_FILES[task]).exists()
                           else "missing" for task in tasks}
    return matrix


def keep_largest_epoch_checkpoint(ckpt_root: str | Path, *, dry_run: bool = False) -> list[str]:
    """Delete all scheduled epoch checkpoints except the largest
    (``keep_largest_epoch_model.py``); 'last' is always kept."""
    ckpt_root = Path(ckpt_root)
    epochs = sorted(ckpt_root.glob("epoch_*"))
    removed = []
    for path in epochs[:-1]:
        removed.append(str(path))
        if not dry_run:
            shutil.rmtree(path)
    return removed


def backfill_tu(split_dir: str | Path) -> int:
    """Create TU maps as AU + EU (float32) where only AU/EU exist
    (``create_TU.py``)."""
    split_dir = Path(split_dir)
    au_dir, eu_dir, tu_dir = split_dir / "AU", split_dir / "EU", split_dir / "TU"
    if not (au_dir.exists() and eu_dir.exists()):
        return 0
    tu_dir.mkdir(exist_ok=True)
    n = 0
    for au_path in au_dir.glob("*.tif"):
        tu_path = tu_dir / au_path.name
        if tu_path.exists():
            continue
        eu_path = eu_dir / au_path.name
        if not eu_path.exists():
            continue
        write_tiff(tu_path, read_tiff(au_path) + read_tiff(eu_path))
        n += 1
    return n


def merge_metric_logs(workdirs: list[str | Path], out_path: str | Path) -> int:
    """Concatenate metrics.jsonl logs from resumed runs, dropping epochs that
    were re-run (keep the latest record per epoch) — the tfevents-merge
    equivalent (``merge_tfevents.py``)."""
    records: dict = {}
    order = 0
    for wd in workdirs:
        f = Path(wd) / "metrics.jsonl"
        if not f.exists():
            continue
        for line in f.read_text().splitlines():
            rec = json.loads(line)
            records[rec.get("epoch", order)] = rec
            order += 1
    out = sorted(records.values(), key=lambda r: r.get("epoch", 0))
    with open(out_path, "w") as fh:
        for rec in out:
            fh.write(json.dumps(rec) + "\n")
    return len(out)
