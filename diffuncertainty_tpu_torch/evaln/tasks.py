"""Downstream-task metrics (port of ``diffuncertainty_tpu/evaln/tasks.py``):
OoD detection, failure detection, calibration, ambiguity modeling, AL
improvement. numpy and scipy on the host, without scikit-learn.

Provenance (the reference's ``evaluation/metrics``):
- OoD (``auroc.py:90-212``): AUROC of aggregated scores over paired id/ood
  splits plus the detection rate at 50% acquisition. The JAX package takes
  ``sklearn.metrics.roc_curve`` and ``auc``; the port takes the tie-aware
  Mann-Whitney form from average ranks, which equals that trapezoid area,
  ties included;
- failure detection (``aurc.py:113-153``): AURC / E-AURC of risk = 1 - dice
  against confidence = -aggregated score;
- calibration (``ace.py:14-545``): a Platt fit on the val split with 256
  log-space binned compression (the fit of
  ``sklearn.calibration._sigmoid_calibration``, which the JAX package calls:
  the same priors, start and L-BFGS-B settings), then per-image
  ACE/ECE/eqACE and global gACE/gECE through a streaming accumulator;
- ambiguity (``ncc.py:9-82``): NCC between the rater-variance map and the
  predicted heatmap;
- AL improvement (``al_improvement.py:6-72``).
"""

from __future__ import annotations

import json
from math import log
from pathlib import Path

import numpy as np

from ..metrics.aurc import aurc, eaurc
from .dataloader import ResultsReader


# --------------------------------------------------------------------------
# OoD detection
# --------------------------------------------------------------------------

def auroc(labels, scores) -> float:
    """Area under the ROC curve of ``scores`` for ``labels`` (1 positive, 0
    negative): the Mann-Whitney U of the positives' average ranks, a tie
    between a positive and a negative counting one half."""
    # imported here, as scipy.optimize below: scipy.stats takes a second to
    # import, and every user of tools/quality.py imports this module
    from scipy.stats import rankdata

    labels = np.asarray(labels)
    ranks = rankdata(np.asarray(scores, dtype=np.float64))
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def ood_detection_paired(
    id_reader: ResultsReader,
    ood_reader: ResultsReader,
    out_path: str | Path,
    dataset_key: str = "paired",
) -> dict:
    """AUROC + detection rate over a paired (id, ood) split pair."""
    results: dict = {dataset_key: {"mean": {}}}
    for unc in id_reader.unc_types:
        agg_id = id_reader.aggregated(unc)
        agg_ood = ood_reader.aggregated(unc)
        if not agg_id or not agg_ood:
            continue
        aggregations = next(iter(agg_id.values())).keys()
        for aggregation in aggregations:
            # the id split's records, then the OoD split's, in file order:
            # the detection rate's order of tied scores depends on it
            scores, labels = [], []
            for source, label in ((agg_id, 0), (agg_ood, 1)):
                for rec in source.values():
                    if aggregation not in rec:
                        continue
                    scores.append(rec[aggregation]["max_score"])
                    labels.append(label)
            if len(set(labels)) < 2:
                continue
            roc_auc = auroc(labels, scores)
            # detection rate at 50% acquisition: query the most-uncertain half
            order = np.argsort(scores)[::-1]
            n_query = int(np.ceil(len(scores) * 0.5))
            n_ood = sum(labels)
            detected = sum(labels[i] for i in order[:n_query])
            rate = detected / n_ood if n_ood else 0.0
            results[dataset_key]["mean"].setdefault(unc, {})[aggregation] = {
                "metrics": {"ood_detection_rate": float(rate), "auroc": roc_auc}
            }
    out_path = Path(out_path)
    existing = json.loads(out_path.read_text()) if out_path.exists() else {}
    existing.update(results)
    out_path.write_text(json.dumps(existing, indent=4))
    return results


# --------------------------------------------------------------------------
# failure detection
# --------------------------------------------------------------------------

def failure_detection(reader: ResultsReader, out_path: str | Path | None = None) -> dict:
    metrics = reader.metrics()
    results: dict = {"mean": {}}
    for unc in reader.unc_types:
        agg = reader.aggregated(unc)
        if not agg:
            continue
        aggregations = next(iter(agg.values())).keys()
        results["mean"][unc] = {}
        for aggregation in aggregations:
            risks, confids = [], []
            for image_id in reader.image_ids:
                rec = metrics[image_id]
                dice = rec["metrics"].get("dice", rec.get("dice"))
                risks.append(1.0 - dice)
                key = next(k for k in agg if k.startswith(image_id))
                confids.append(-agg[key][aggregation]["max_score"])
            risks = np.asarray(risks)
            confids = np.asarray(confids)
            results["mean"][unc][aggregation] = {
                "metrics": {
                    "aurc": float(aurc(risks, confids)),
                    "eaurc": float(eaurc(risks, confids)),
                }
            }
    if out_path is not None:
        Path(out_path).write_text(json.dumps(results, indent=2))
    return results


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------

# scikit-learn's ``max_abs_prediction_threshold``
_PLATT_F_LIMIT = 30.0


def _sigmoid_calibration(f: np.ndarray, y: np.ndarray,
                         w: np.ndarray | None) -> tuple[float, float]:
    """Platt's fit of P(y = 1 | f) = 1 / (1 + exp(a f + b)): the method of
    ``sklearn.calibration._sigmoid_calibration``. F is scaled down when its
    largest magnitude reaches ``_PLATT_F_LIMIT`` (``a`` scaled back), the
    targets are Platt's priors (T+ = (n+ + 1) / (n+ + 2), T- = 1 / (n- + 2),
    counted with the weights), the start is [0, log((n- + 1) / (n+ + 1))],
    and L-BFGS-B minimizes the weighted binomial loss of the raw prediction
    r = -(a F + b), log(1 + e^r) - T r."""
    from scipy.optimize import minimize
    from scipy.special import expit

    f = np.ravel(f)
    y = np.ravel(y)
    scale = 1.0
    max_prediction = np.max(np.abs(f))
    if max_prediction >= _PLATT_F_LIMIT:
        scale = max_prediction
        f = f / scale
    negative = y <= 0
    if w is not None:
        prior0, prior1 = w[negative].sum(), w[~negative].sum()
    else:
        prior0 = float(np.sum(negative))
        prior1 = y.shape[0] - prior0
    t = np.zeros_like(y, dtype=f.dtype)
    t[y > 0] = (prior1 + 1.0) / (prior1 + 2.0)
    t[y <= 0] = 1.0 / (prior0 + 2.0)
    weights = np.ones_like(f) if w is None else w

    def loss_grad(ab):
        raw = -(ab[0] * f + ab[1])
        loss = weights * (np.logaddexp(0.0, raw) - t * raw)
        g = weights * (expit(raw) - t)
        return loss.sum(), np.asarray([-g @ f, -g.sum()], dtype=np.float64)

    ab0 = np.array([0.0, log((prior0 + 1.0) / (prior1 + 1.0))])
    result = minimize(loss_grad, ab0, method="L-BFGS-B", jac=True,
                      options={"gtol": 1e-6, "ftol": 64 * np.finfo(float).eps})
    return result.x[0] / scale, result.x[1]


def platt_scale_params(
    val_reader: ResultsReader, ignore_value=None, n_bins: int = 256
) -> dict:
    """Fit Platt params per unc type on the val split with binned compression
    (``ace.py:14-196``): log-space bins over [1e-12, 1e2], two weighted
    samples per non-empty bin, F = -mean bin uncertainty."""
    bin_edges = np.logspace(-12, 2, num=n_bins + 1, dtype=np.float64)
    params: dict = {}
    for unc in val_reader.unc_types:
        pos = np.zeros(n_bins, np.int64)
        neg = np.zeros(n_bins, np.int64)
        sum_unc = np.zeros(n_bins, np.float64)
        total = np.zeros(n_bins, np.int64)
        for image_id in val_reader.image_ids:
            refs = val_reader.get_reference_segs(image_id)
            pred = val_reader.get_mean_pred_seg(image_id)
            unc_map = val_reader.get_unc_map(image_id, unc)
            if pred.shape != unc_map.shape:
                unc_map = np.swapaxes(unc_map, 0, 1)
            correct = refs == pred[None]
            valid = refs != ignore_value if ignore_value is not None else np.ones(refs.shape, bool)
            u = np.broadcast_to(unc_map[None], refs.shape)[valid].ravel()
            c = correct[valid].ravel().astype(np.int8)
            if u.size == 0:
                continue
            idx = np.clip(np.digitize(u, bin_edges) - 1, 0, n_bins - 1)
            sum_unc += np.bincount(idx, weights=u, minlength=n_bins)
            total += np.bincount(idx, minlength=n_bins)
            pos += np.bincount(idx[c == 1], minlength=n_bins)
            neg += np.bincount(idx[c == 0], minlength=n_bins)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_unc = np.divide(sum_unc, total, out=np.zeros_like(sum_unc), where=total > 0)
        fs, ys, ws = [], [], []
        for b in range(n_bins):
            if total[b] == 0:
                continue
            if pos[b] > 0:
                fs.append(-mean_unc[b])
                ys.append(1.0)
                ws.append(float(pos[b]))
            if neg[b] > 0:
                fs.append(-mean_unc[b])
                ys.append(0.0)
                ws.append(float(neg[b]))
        if not fs:
            a, b_param = 0.0, 0.0
        else:
            a, b_param = _sigmoid_calibration(np.asarray(fs), np.asarray(ys), np.asarray(ws))
        params[unc] = {"a": float(a), "b": float(b_param)}
    return params


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


def calc_ace(correct, confids) -> float:
    d, _, n = _calib_stats(np.asarray(correct), np.asarray(confids))
    return float(np.sum(d) / n)


def calc_ece(correct, confids) -> float:
    d, pt, _ = _calib_stats(np.asarray(correct), np.asarray(confids))
    return float(np.sum(d * pt))


def calc_eqace(correct, confids, n_bins: int = 20) -> float:
    confids = np.clip(np.ravel(confids), 0.0, 1.0)
    correct = np.ravel(correct).astype(np.float64)
    if confids.size == 0:
        return float("nan")
    edges = np.quantile(confids, np.linspace(0, 1, n_bins + 1))
    edges[0], edges[-1] = 0.0, 1.0 + 1e-8
    edges = np.maximum.accumulate(edges)
    binids = np.clip(np.digitize(confids, edges) - 1, 0, n_bins - 1)
    bin_sums = np.bincount(binids, weights=confids, minlength=n_bins)
    bin_true = np.bincount(binids, weights=correct, minlength=n_bins)
    bin_total = np.bincount(binids, minlength=n_bins)
    nz = bin_total > 0
    if not nz.any():
        return float("nan")
    d = np.abs(bin_true[nz] / bin_total[nz] - bin_sums[nz] / bin_total[nz])
    return float(np.sum(d) / nz.sum())


def calibration(
    reader: ResultsReader,
    val_reader: ResultsReader | None = None,
    ignore_value=None,
    platt_file: str | Path | None = None,
) -> dict:
    """Per-image ACE/ECE/eqACE + global gACE/gECE with Platt-scaled confids.
    The Platt parameters are read from ``platt_file`` (default
    ``platt_scale_params.json`` in the version directory), else fitted on
    ``val_reader`` and written there."""
    exp_path = reader.split_dir.parent
    platt_file = Path(platt_file or exp_path / "platt_scale_params.json")
    if platt_file.exists():
        params = json.loads(platt_file.read_text())
    else:
        if val_reader is None:
            raise ValueError("val_reader needed to fit Platt parameters")
        params = platt_scale_params(val_reader, ignore_value=ignore_value)
        platt_file.write_text(json.dumps(params, indent=2))

    out: dict = {"mean": {}}
    for unc in reader.unc_types:
        a, b = params[unc]["a"], params[unc]["b"]
        aces, eces, eqaces = [], [], []
        g_sums = np.zeros(21)
        g_true = np.zeros(21)
        g_total = np.zeros(21, np.int64)
        for image_id in reader.image_ids:
            refs = reader.get_reference_segs(image_id)
            pred = reader.get_mean_pred_seg(image_id)
            unc_map = reader.get_unc_map(image_id, unc)
            if pred.shape != unc_map.shape:
                unc_map = np.swapaxes(unc_map, 0, 1)
            correct = (refs == pred[None]).astype(int)
            u = np.broadcast_to(unc_map[None], refs.shape)
            if ignore_value is not None:
                mask = refs != ignore_value
                u_v, c_v = u[mask], correct[mask]
            else:
                u_v, c_v = u.ravel(), correct.ravel()
            confids = 1.0 / (1.0 + np.exp((-u_v) * a + b))
            aces.append(calc_ace(c_v, confids))
            eces.append(calc_ece(c_v, confids))
            eqaces.append(calc_eqace(c_v, confids))
            out.setdefault(image_id, {})[unc] = {
                "metrics": {"ace": aces[-1], "ece": eces[-1], "eqace": eqaces[-1]}
            }
            # streaming global accumulation
            cc = np.clip(confids, 0, 1)
            binids = np.digitize(cc, np.linspace(0.0, 1.0 + 1e-8, 21)) - 1
            g_sums += np.bincount(binids, weights=cc, minlength=21)
            g_true += np.bincount(binids, weights=c_v.astype(np.float64), minlength=21)
            g_total += np.bincount(binids, minlength=21)
        nz = g_total > 0
        gap = np.abs(g_true[nz] / g_total[nz] - g_sums[nz] / g_total[nz])
        out["mean"][unc] = {
            "metrics": {
                "ace": float(np.mean(aces)),
                "ece": float(np.mean(eces)),
                "eqace": float(np.mean(eqaces)),
                "gace": float(np.sum(gap) / nz.sum()),
                "gece": float(np.sum(gap * (g_total[nz] / g_total.sum()))),
            }
        }
    (reader.split_dir / "calibration.json").write_text(json.dumps(out, indent=2))
    return out


# --------------------------------------------------------------------------
# ambiguity modeling (NCC)
# --------------------------------------------------------------------------

def compute_ncc(gt_unc_map: np.ndarray, pred_unc_map: np.ndarray) -> float:
    """Normalized cross-correlation of two uncertainty maps; 0 if either is
    constant."""
    mu_gt, mu_pred = np.mean(gt_unc_map), np.mean(pred_unc_map)
    s_gt = np.std(gt_unc_map, ddof=1)
    s_pred = np.std(pred_unc_map, ddof=1)
    if s_gt == 0 or s_pred == 0:
        return 0.0
    prod = np.sum((gt_unc_map - mu_gt) * (pred_unc_map - mu_pred))
    return float(prod / (gt_unc_map.size * s_gt * s_pred))


def ambiguity_modeling(reader: ResultsReader) -> dict:
    out: dict = {"mean": {}}
    for unc in reader.unc_types:
        nccs = []
        for image_id in reader.image_ids:
            gt_map = reader.get_gt_unc_map(image_id)
            pred_map = reader.get_unc_map(image_id, unc)
            if gt_map.shape != pred_map.shape:
                pred_map = np.swapaxes(pred_map, 0, 1)
            ncc = compute_ncc(gt_map, pred_map)
            out.setdefault(image_id, {})[unc] = {"metrics": {"ncc": ncc}}
            nccs.append(ncc)
        out["mean"][unc] = {"metrics": {"ncc": float(np.mean(nccs))}}
    (reader.split_dir / "ambiguity_modeling.json").write_text(json.dumps(out, indent=2))
    return out


# --------------------------------------------------------------------------
# AL improvement (al_improvement.py:6-72)
# --------------------------------------------------------------------------

def al_improvement(
    dice_first_cycle: float,
    dice_second_cycle_unc: float,
    dice_second_cycle_random: float,
) -> float:
    """Relative dice improvement of uncertainty-queried vs random-queried
    second-cycle training."""
    rel_unc = dice_second_cycle_unc / dice_first_cycle - 1.0
    rel_rand = dice_second_cycle_random / dice_first_cycle - 1.0
    return float(rel_unc - rel_rand)
