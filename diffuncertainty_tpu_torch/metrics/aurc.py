"""Risk-coverage curves: AURC and E-AURC (copy of
``diffuncertainty_tpu/metrics/aurc.py``, host numpy).

Samples leave in ascending-confidence order; a new RC point is emitted only
where the confidence changes (ties collapse into one step); AURC is the
trapezoid over those steps weighted by the fraction of samples consumed.
"""

from __future__ import annotations

import numpy as np


def rc_curve_stats(
    risks: np.ndarray, confids: np.ndarray
) -> tuple[list[float], list[float], list[float]]:
    risks = np.asarray(risks, dtype=np.float64)
    confids = np.asarray(confids, dtype=np.float64)
    assert risks.ndim == 1 and confids.ndim == 1 and len(risks) == len(confids)
    n = len(risks)
    # numpy's default (unstable) argsort is the spec: within-tie order is observable
    order = np.argsort(confids)
    sorted_risks = risks[order]
    sorted_conf = confids[order]

    coverages = [1.0]
    selective_risks = [float(sorted_risks.sum()) / n if n else 0.0]
    weights: list[float] = []
    if n < 2:
        return coverages, selective_risks, weights

    removed = np.cumsum(sorted_risks)
    total = removed[-1]
    emit = np.flatnonzero(
        np.concatenate(([True], sorted_conf[1 : n - 1] != sorted_conf[: n - 2]))
    )
    cov = (n - 1 - emit).astype(np.float64)
    coverages.extend((cov / n).tolist())
    selective_risks.extend(((total - removed[emit]) / cov).tolist())
    weights.extend((np.diff(emit, prepend=-1) / n).tolist())

    trailing = (n - 1) - (emit[-1] + 1)
    if trailing > 0:
        coverages.append(0.0)
        selective_risks.append(selective_risks[-1])
        weights.append(trailing / n)
    return coverages, selective_risks, weights


def aurc(risks: np.ndarray, confids: np.ndarray) -> float:
    _, sr, w = rc_curve_stats(risks, confids)
    sr_arr = np.asarray(sr)
    w_arr = np.asarray(w)
    return float(np.sum((sr_arr[:-1] + sr_arr[1:]) * 0.5 * w_arr))
