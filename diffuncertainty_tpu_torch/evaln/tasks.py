"""Expected calibration error (``calc_ece`` of
``diffuncertainty_tpu/evaln/tasks.py``): 20 equal-width bins over [0, 1]."""

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
