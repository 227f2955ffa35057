"""Evaluation tasks of ``diffuncertainty_tpu/evaln/tasks.py``: the expected
calibration error (``calc_ece``, 20 equal-width bins over [0, 1]) and the
NCC of two uncertainty maps (``compute_ncc``)."""

from __future__ import annotations

import numpy as np


def _calib_stats(correct: np.ndarray, confids: np.ndarray, n_bins: int = 20):
    confids = np.clip(confids, 0.0, 1.0)
    bins = np.linspace(0.0, 1.0 + 1e-8, n_bins + 1)
    binids = np.digitize(confids, bins) - 1
    n = len(bins)
    bin_sums = np.bincount(binids, weights=confids, minlength=n)
    bin_true = np.bincount(binids, weights=correct.astype(np.float64), minlength=n)
    bin_total = np.bincount(binids, minlength=n)
    nz = bin_total != 0
    prob_true = bin_true[nz] / bin_total[nz]
    prob_pred = bin_sums[nz] / bin_total[nz]
    prob_total = bin_total[nz] / bin_total.sum()
    return np.abs(prob_true - prob_pred), prob_total, int(nz.sum())


def calc_ece(correct, confids) -> float:
    d, pt, _ = _calib_stats(np.asarray(correct), np.asarray(confids))
    return float(np.sum(d * pt))


def compute_ncc(gt_unc_map: np.ndarray, pred_unc_map: np.ndarray) -> float:
    """Normalized cross-correlation of two uncertainty maps (``compute_ncc``
    of ``diffuncertainty_tpu/evaln/tasks.py``); 0 if either is constant."""
    mu_gt, mu_pred = np.mean(gt_unc_map), np.mean(pred_unc_map)
    s_gt = np.std(gt_unc_map, ddof=1)
    s_pred = np.std(pred_unc_map, ddof=1)
    if s_gt == 0 or s_pred == 0:
        return 0.0
    prod = np.sum((gt_unc_map - mu_gt) * (pred_unc_map - mu_pred))
    return float(prod / (gt_unc_map.size * s_gt * s_pred))
