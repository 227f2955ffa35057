"""Generalized Energy Distance (port of ``ged_binary``, batched over
leading axes, and ``ged_multiclass`` of ``diffuncertainty_tpu/metrics/ged.py``).

GED = 2 E[d(p, g)] - E[d(p, p')] - E[d(g, g')] with d = 1 - Dice: pred-gt
Dice under each rater's ignore mask with the empty-mask rules; pred-pred
through a Gram matrix without masking (empty pairs -> 1); gt-gt under the
mask of the second rater. Uniform rater counts (no padded raters).
"""

from __future__ import annotations

import torch

from .dice import dice_from_counts


def ged_binary(output_softmax: torch.Tensor, ground_truth: torch.Tensor,
               ignore_index: int | None = None) -> dict[str, torch.Tensor]:
    """GED of a (..., P, H, W, 2) softmax stack against (..., G, H, W) labels.

    Returns ged, dice, max_dice_pred, max_dice_gt, major_dice (each (...))
    and the (..., P, G) dice_matrix.
    """
    if output_softmax.shape[-1] != 2:
        raise ValueError("ged_binary takes two classes")
    gt = ground_truth
    pred_idx = output_softmax.argmax(dim=-1)  # (..., P, H, W)
    gt_valid = torch.ones_like(gt, dtype=torch.bool) if ignore_index is None else gt != ignore_index

    # pred-gt dice (..., P, G) under each rater's mask
    pred_pos = (pred_idx.unsqueeze(-3) == 1) & gt_valid.unsqueeze(-4)  # (..., P, G, H, W)
    gt_pos = ((gt == 1) & gt_valid).unsqueeze(-4)  # (..., 1, G, H, W)
    tp = (pred_pos & gt_pos).sum(dim=(-2, -1)).float()
    dice_pg = dice_from_counts(tp, pred_pos.sum(dim=(-2, -1)).float(),
                               gt_pos.sum(dim=(-2, -1)).float())
    dist_gt_pred = (1.0 - dice_pg).mean(dim=(-2, -1))

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
    dist_gt_gt = (1.0 - dice_g).mean(dim=(-2, -1))

    # major dice: argmax of the mean prediction vs the rater majority
    majority_pred = output_softmax.mean(dim=-4).argmax(dim=-1)  # (..., H, W)
    majority_gt = (gt == 1).float().mean(dim=-3) >= 0.5
    valid_all = gt_valid.all(dim=-3)
    mp = (majority_pred == 1) & valid_all
    mg = majority_gt & valid_all
    major_dice = dice_from_counts((mp & mg).sum(dim=(-2, -1)).float(),
                                  mp.sum(dim=(-2, -1)).float(), mg.sum(dim=(-2, -1)).float())
    return {
        "ged": 2.0 * dist_gt_pred - dist_pred_pred - dist_gt_gt,
        "dice": dice_pg.mean(dim=(-2, -1)),
        "max_dice_pred": dice_pg.amax(dim=-1).mean(dim=-1),
        "max_dice_gt": dice_pg.amax(dim=-2).mean(dim=-1),
        "major_dice": major_dice,
        "dice_matrix": dice_pg,
    }


def ged_multiclass(output_softmax: torch.Tensor, ground_truth: torch.Tensor, num_classes: int,
                   ignore_index: int | None = 0) -> dict[str, torch.Tensor]:
    """Multiclass GED of a (P, H, W, C) softmax stack against (G, H, W)
    labels (``ged_multiclass`` of the JAX package, every rater real).

    The pairwise distance is 1 - micro Dice, which over all classes is the
    accuracy over the target's valid pixels: pred-gt under rater g's mask,
    pred-pred unmasked, gt-gt (rater i against rater j) under rater j's mask.
    Labels outside [0, num_classes) match nothing. ``major_dice`` is the
    accuracy of the mean prediction's argmax against the rater mode (ties
    to the smaller class) where the mode is valid.
    """
    p, g = output_softmax.shape[0], ground_truth.shape[0]
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
    dist_gt_gt = ((1.0 - accuracy(agree_gg)).sum() / (g * g) if g > 1
                  else torch.zeros((), device=gt.device))
    ged = 2.0 * (1.0 - dice_pg).mean() - dist_pred_pred - dist_gt_gt

    majority_pred = output_softmax.mean(dim=0).argmax(dim=-1).flatten()
    counts = torch.zeros((hw, num_classes), device=gt.device)
    counts.scatter_add_(1, gt.clamp(0, num_classes - 1).t(), gt_in.t().float())
    majority_gt = counts.argmax(dim=-1)
    valid_m = (torch.ones_like(majority_gt, dtype=torch.bool) if ignore_index is None
               else majority_gt != ignore_index)
    nv = valid_m.sum().float()
    agree_m = ((majority_pred == majority_gt) & valid_m).sum().float()
    major_dice = torch.where(nv > 0, agree_m / nv.clamp(min=1.0), torch.ones_like(nv))
    return {
        "ged": ged,
        "dice": dice_pg.mean(),
        "max_dice_pred": dice_pg.amax(dim=1).mean(),
        "max_dice_gt": dice_pg.amax(dim=0).mean(),
        "major_dice": major_dice,
        "dice_matrix": dice_pg,
    }
