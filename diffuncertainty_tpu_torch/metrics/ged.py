"""Generalized Energy Distance (port of ``ged_binary``, batched over
leading axes, and ``ged_multiclass`` of ``diffuncertainty_tpu/metrics/ged.py``).

GED = 2 E[d(p, g)] - E[d(p, p')] - E[d(g, g')] with d = 1 - Dice: pred-gt
Dice under each rater's ignore mask with the empty-mask rules; pred-pred
through a Gram matrix without masking (empty pairs -> 1); gt-gt under the
mask of the second rater.

Padded raters: a variable-rater batch pads the rater axis with all-zero
masks. Both functions take ``n_raters``, the true rater count (a tensor of
the leading shape), and leave every rater at index >= ``n_raters`` out of
each term that involves the raters (the pred-gt and gt-gt means, the
max-Dice reductions, the majority vote), as the JAX functions do; with
``n_raters=None`` every rater counts.
"""

from __future__ import annotations

import torch

from .dice import dice_from_counts, rater_mean, rater_weights


class _Raters:
    """Means over (pred, rater) and (rater, rater) pairs, and the rater
    majority, over every rater (``n_raters`` None) or the true ones only."""

    def __init__(self, n_gt: int, n_raters, device):
        self.n_raters = self.w = self.n = None
        if n_raters is not None:
            self.n_raters = torch.as_tensor(n_raters, device=device)
            self.w, self.n = rater_weights(n_gt, self.n_raters)

    def pg_mean(self, m):  # (..., P, G) -> (...)
        if self.w is None:
            return m.mean(dim=(-2, -1))
        return (m * self.w.unsqueeze(-2)).sum(dim=(-2, -1)) / (m.shape[-2] * self.n)

    def gg_mean(self, m):  # (..., G, G) -> (...)
        if self.w is None:
            return m.mean(dim=(-2, -1))
        return ((m * self.w.unsqueeze(-1) * self.w.unsqueeze(-2)).sum(dim=(-2, -1))
                / (self.n * self.n))

    def max_over_raters(self, m):  # (..., P, G) -> mean over P of the max over G
        if self.w is None:
            return m.amax(dim=-1).mean(dim=-1)
        return torch.where(self.w.unsqueeze(-2) > 0, m, -torch.inf).amax(dim=-1).mean(dim=-1)

    def real(self):  # (..., G, 1, 1) bool, or None when every rater is real
        return None if self.w is None else (self.w > 0)[..., None, None]


def ged_binary(output_softmax: torch.Tensor, ground_truth: torch.Tensor,
               ignore_index: int | None = None, n_raters=None) -> dict[str, torch.Tensor]:
    """GED of a (..., P, H, W, 2) softmax stack against (..., G, H, W) labels.

    Returns ged, dice, max_dice_pred, max_dice_gt, major_dice (each (...))
    and the (..., P, G) dice_matrix.
    """
    if output_softmax.shape[-1] != 2:
        raise ValueError("ged_binary takes two classes")
    gt = ground_truth
    raters = _Raters(gt.shape[-3], n_raters, gt.device)
    pred_idx = output_softmax.argmax(dim=-1)  # (..., P, H, W)
    gt_valid = torch.ones_like(gt, dtype=torch.bool) if ignore_index is None else gt != ignore_index

    # pred-gt dice (..., P, G) under each rater's mask
    pred_pos = (pred_idx.unsqueeze(-3) == 1) & gt_valid.unsqueeze(-4)  # (..., P, G, H, W)
    gt_pos = ((gt == 1) & gt_valid).unsqueeze(-4)  # (..., 1, G, H, W)
    tp = (pred_pos & gt_pos).sum(dim=(-2, -1)).float()
    dice_pg = dice_from_counts(tp, pred_pos.sum(dim=(-2, -1)).float(),
                               gt_pos.sum(dim=(-2, -1)).float())
    dist_gt_pred = raters.pg_mean(1.0 - dice_pg)

    # pred-pred through a Gram matrix, no mask
    f = (pred_idx == 1).flatten(-2).float()  # (..., P, HW)
    tp_mat = f @ f.transpose(-1, -2)
    pos = f.sum(dim=-1)
    denom_pp = pos.unsqueeze(-1) + pos.unsqueeze(-2)
    dice_pp = torch.where(denom_pp > 0, 2.0 * tp_mat / denom_pp.clamp(min=1.0),
                          torch.ones_like(tp_mat))
    dist_pred_pred = (1.0 - dice_pp).mean(dim=(-2, -1))

    # gt-gt: rater i under the mask of rater j
    gt_bin = gt == 1
    gtj = gt_bin.unsqueeze(-4) & gt_valid.unsqueeze(-3)  # (..., J, G, H, W)
    gtj_self = gt_bin & gt_valid  # (..., G, H, W)
    tp_g = (gtj & gtj_self.unsqueeze(-3)).sum(dim=(-2, -1)).float()
    denom_g = gtj.sum(dim=(-2, -1)).float() + gtj_self.sum(dim=(-2, -1)).float().unsqueeze(-1)
    dice_g = torch.where(denom_g > 0, 2.0 * tp_g / denom_g.clamp(min=1.0), torch.ones_like(tp_g))
    dist_gt_gt = raters.gg_mean(1.0 - dice_g)

    # major dice: argmax of the mean prediction vs the rater majority
    majority_pred = output_softmax.mean(dim=-4).argmax(dim=-1)  # (..., H, W)
    real = raters.real()
    if real is None:
        majority_gt = (gt == 1).float().mean(dim=-3) >= 0.5
        valid_all = gt_valid.all(dim=-3)
    else:
        majority_gt = ((gt == 1).float() * real).sum(dim=-3) / raters.n[..., None, None] >= 0.5
        valid_all = (gt_valid | ~real).all(dim=-3)
    mp = (majority_pred == 1) & valid_all
    mg = majority_gt & valid_all
    major_dice = dice_from_counts((mp & mg).sum(dim=(-2, -1)).float(),
                                  mp.sum(dim=(-2, -1)).float(), mg.sum(dim=(-2, -1)).float())
    return {
        "ged": 2.0 * dist_gt_pred - dist_pred_pred - dist_gt_gt,
        "dice": raters.pg_mean(dice_pg),
        "max_dice_pred": raters.max_over_raters(dice_pg),
        "max_dice_gt": rater_mean(dice_pg.amax(dim=-2), raters.n_raters),
        "major_dice": major_dice,
        "dice_matrix": dice_pg,
    }


def ged_multiclass(output_softmax: torch.Tensor, ground_truth: torch.Tensor, num_classes: int,
                   ignore_index: int | None = 0, n_raters=None) -> dict[str, torch.Tensor]:
    """Multiclass GED of a (P, H, W, C) softmax stack against (G, H, W)
    labels (``ged_multiclass`` of the JAX package).

    The pairwise distance is 1 - micro Dice, which over all classes is the
    accuracy over the target's valid pixels: pred-gt under rater g's mask,
    pred-pred unmasked, gt-gt (rater i against rater j) under rater j's mask.
    Labels outside [0, num_classes) match nothing. ``major_dice`` is the
    accuracy of the mean prediction's argmax against the rater mode (ties
    to the smaller class) where the mode is valid.
    """
    p, g = output_softmax.shape[0], ground_truth.shape[0]
    raters = _Raters(g, n_raters, ground_truth.device)
    gt = ground_truth.flatten(1)  # (G, N)
    pred = output_softmax.argmax(dim=-1).flatten(1)  # (P, N)
    hw = pred.shape[1]
    valid = (torch.ones_like(gt, dtype=torch.bool) if ignore_index is None
             else gt != ignore_index)
    gt_in = (gt >= 0) & (gt < num_classes)
    n_valid = valid.sum(dim=1).float()  # (G,)

    def accuracy(agree: torch.Tensor) -> torch.Tensor:
        # agree (..., G) counts over the valid pixels of the last axis' rater
        return torch.where(n_valid > 0, agree / n_valid.clamp(min=1.0), torch.ones_like(agree))

    gt_mask = (gt_in & valid).unsqueeze(0)
    dice_pg = accuracy(((pred.unsqueeze(1) == gt.unsqueeze(0)) & gt_mask).sum(-1).float())
    dice_pp = (pred.unsqueeze(1) == pred.unsqueeze(0)).sum(-1).float() / hw
    dist_pred_pred = (1.0 - dice_pp).mean() if p > 1 else torch.zeros((), device=gt.device)
    agree_gg = ((gt.unsqueeze(1) == gt.unsqueeze(0)) & gt_in.unsqueeze(1)
                & valid.unsqueeze(0)).sum(-1).float()
    dist_gg = 1.0 - accuracy(agree_gg)
    dist_gt_gt = ((dist_gg.sum() / (g * g) if raters.w is None else raters.gg_mean(dist_gg))
                  if g > 1 else torch.zeros((), device=gt.device))
    ged = 2.0 * raters.pg_mean(1.0 - dice_pg) - dist_pred_pred - dist_gt_gt

    majority_pred = output_softmax.mean(dim=0).argmax(dim=-1).flatten()
    counts = torch.zeros((hw, num_classes), device=gt.device)
    votes = gt_in if raters.w is None else gt_in & (raters.w > 0).unsqueeze(-1)
    counts.scatter_add_(1, gt.clamp(0, num_classes - 1).t(), votes.t().float())
    majority_gt = counts.argmax(dim=-1)
    valid_m = (torch.ones_like(majority_gt, dtype=torch.bool) if ignore_index is None
               else majority_gt != ignore_index)
    nv = valid_m.sum().float()
    agree_m = ((majority_pred == majority_gt) & valid_m).sum().float()
    major_dice = torch.where(nv > 0, agree_m / nv.clamp(min=1.0), torch.ones_like(nv))
    return {
        "ged": ged,
        "dice": raters.pg_mean(dice_pg),
        "max_dice_pred": raters.max_over_raters(dice_pg),
        "max_dice_gt": rater_mean(dice_pg.amax(dim=0), raters.n_raters),
        "major_dice": major_dice,
        "dice_matrix": dice_pg,
    }
