"""C3 aggregation: heatmap -> scalar score (port of
``diffuncertainty_tpu/evaln/aggregation.py``, numpy and scipy as there, so
every number equals the JAX package's).

The image, patch, threshold, area-normalized and border-normalized
aggregations of the reference's
``evaluation/uncertainty_aggregation/aggregate_uncertainties.py:16-130``,
the prediction shape stats (``prediction_shape_stats.py:10-103``: area and
boundary length) and the threshold finding (``find_threshold.py:10-113``).
Patch aggregation is a 'valid' ones-kernel ``scipy.signal.convolve``, as in
the reference.

Writes ``aggregated_{unc}.json`` and ``area.json`` next to the heatmaps, and
``quantile_analysis.json`` and ``threshold_analysis.json`` in the version
directory: the inter-stage contract the downstream tasks read.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .dataloader import ResultsReader


def image_level_aggregation(image: np.ndarray, mean: bool = True, **_) -> dict:
    score = float(np.sum(image) / image.size) if mean else float(np.sum(image))
    return {"max_score": score}


def patch_level_aggregation(image: np.ndarray, patch_size=8, mean: bool = False, **_) -> dict:
    # imported here: scipy.signal takes seconds to import, and every user of
    # tools/quality.py imports this package
    from scipy.signal import convolve

    if isinstance(patch_size, int):
        patch_size = [patch_size] * image.ndim
    kernel = np.ones(patch_size)
    agg = convolve(image, kernel, mode="valid")
    if mean:
        agg = agg / np.prod(patch_size)
    all_max = np.where(np.isclose(agg, np.max(agg)))
    bbox = [
        (int(idx[0]), int(idx[0] + patch_size[d]))
        for d, idx in enumerate(all_max)
    ]
    return {"max_score": float(np.max(agg)), "bounding_box": bbox}


def threshold_aggregation(image: np.ndarray, threshold: float, mean: bool = True, **_) -> dict:
    selected = image[image >= threshold]
    if mean and selected.size > 0:
        return {"max_score": float(selected.mean()), "threshold": float(threshold)}
    return {"max_score": float(selected.sum()), "threshold": float(threshold)}


def _normalized(image: np.ndarray, divisor: float) -> float:
    total = float(np.sum(image))
    return total if divisor <= 0 else total / divisor


def area_normalized_aggregation(image: np.ndarray, area: float, **_) -> dict:
    return {"max_score": _normalized(image, area), "normalizer": float(area)}


def border_normalized_aggregation(image: np.ndarray, border: float, **_) -> dict:
    return {"max_score": _normalized(image, border), "normalizer": float(border)}


# --------------------------------------------------------------------------
# prediction shape stats (area.json)
# --------------------------------------------------------------------------

def _mask_area(mask: np.ndarray) -> float:
    return float(np.count_nonzero(np.asarray(mask) > 0))


def _mask_border(mask: np.ndarray) -> float:
    mask = np.asarray(mask)
    total = 0
    for axis in range(mask.ndim):
        if mask.shape[axis] < 2:
            continue
        a = [slice(None)] * mask.ndim
        b = [slice(None)] * mask.ndim
        a[axis] = slice(0, -1)
        b[axis] = slice(1, None)
        total += int(np.count_nonzero(mask[tuple(a)] != mask[tuple(b)]))
    return float(total)


def compute_prediction_shape_stats(reader: ResultsReader) -> dict:
    """Per-image mean-prediction area & boundary length -> area.json."""
    stats = {}
    for image_id in reader.image_ids:
        mask = reader.get_mean_pred_seg(image_id)
        stats[image_id] = {"area": _mask_area(mask), "border": _mask_border(mask)}
    with open(reader.split_dir / "area.json", "w") as f:
        json.dump(stats, f, indent=2)
    return stats


# --------------------------------------------------------------------------
# the aggregation task
# --------------------------------------------------------------------------

DEFAULT_AGGREGATIONS = (
    "image_level",
    "patch_level",
    "threshold",
    "area_normalized",
    "border_normalized",
)


def aggregate_uncertainties(
    reader: ResultsReader,
    aggregations=DEFAULT_AGGREGATIONS,
    *,
    patch_size: int = 8,
    thresholds: dict[str, float] | None = None,
    unc_ending: str = ".tif",
) -> None:
    """Run the configured aggregations over every (image, unc_type), writing
    ``aggregated_{unc}.json`` keyed ``{image_id}{ending}`` like the reference."""
    needs_stats = any(a in aggregations for a in ("area_normalized", "border_normalized"))
    stats = None
    if needs_stats:
        area_file = reader.split_dir / "area.json"
        stats = (
            json.loads(area_file.read_text())
            if area_file.exists()
            else compute_prediction_shape_stats(reader)
        )
    if "threshold" in aggregations and thresholds is None:
        tfile = reader.split_dir.parent / "threshold_analysis.json"
        if tfile.exists():
            payload = json.loads(tfile.read_text())
            inner = next(iter(payload.values()))
            thresholds = {
                u: inner.get(f"Mean {u.split('_')[0]} threshold") for u in reader.unc_types
            }
        else:
            thresholds = {}

    for unc in reader.unc_types:
        all_uncs: dict = {}
        for image_id in reader.image_ids:
            image = reader.get_unc_map(image_id, unc)
            record = {}
            for agg in aggregations:
                if agg == "image_level":
                    record[agg] = image_level_aggregation(image)
                elif agg == "patch_level":
                    record[agg] = patch_level_aggregation(image, patch_size)
                elif agg == "threshold":
                    thr = (thresholds or {}).get(unc)
                    if thr is None:
                        continue
                    record[agg] = threshold_aggregation(image, thr)
                elif agg == "area_normalized":
                    record[agg] = area_normalized_aggregation(
                        image, stats[image_id]["area"]
                    )
                elif agg == "border_normalized":
                    record[agg] = border_normalized_aggregation(
                        image, stats[image_id]["border"]
                    )
                else:
                    raise ValueError(f"unknown aggregation '{agg}'")
            all_uncs[f"{image_id}{unc_ending}"] = record
        with open(reader.split_dir / f"aggregated_{unc}.json", "w") as f:
            json.dump(all_uncs, f, indent=4)


# --------------------------------------------------------------------------
# threshold finding (find_threshold.py:10-113)
# --------------------------------------------------------------------------

def foreground_quantile(reader: ResultsReader) -> float:
    """Mean fraction of background pixels across all per-sample predictions."""
    quantiles = []
    for image_id in reader.image_ids:
        for pred in reader.get_pred_segs(image_id):
            fg = np.count_nonzero(pred)
            quantiles.append(1.0 - fg / pred.size)
    return float(np.mean(quantiles)) if quantiles else 1.0


def find_threshold(
    readers: list[ResultsReader],
    exp_path: str | Path,
    pred_model: str = "model",
) -> dict:
    """Two-stage accumulated task: pooled foreground quantile -> per-unc-type
    pooled-uncertainty quantile thresholds -> threshold_analysis.json."""
    exp_path = Path(exp_path)
    exp_path.mkdir(parents=True, exist_ok=True)
    q = float(np.mean([foreground_quantile(r) for r in readers]))
    with open(exp_path / "quantile_analysis.json", "w") as f:
        json.dump({pred_model: q}, f, indent=2)

    entries = {}
    unc_types = readers[0].unc_types if readers else []
    for unc in unc_types:
        pooled = np.concatenate(
            [r.get_unc_map(i, unc).ravel() for r in readers for i in r.image_ids]
        )
        thr = float(np.quantile(pooled, q))
        entries[f"Mean {unc.split('_')[0]} threshold"] = thr
    payload = {pred_model: entries}
    with open(exp_path / "threshold_analysis.json", "w") as f:
        json.dump(payload, f, indent=2)
    return payload
