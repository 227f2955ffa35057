"""Dice (port of ``diffuncertainty_tpu/metrics/dice.py``): binary Dice with
the reference's edge cases (both masks empty -> 1, exactly one empty -> 0,
else 2TP / (2TP + FP + FN)) and the multiclass macro Dice. Leading axes are
batched."""

from __future__ import annotations

import torch


def dice_from_counts(tp: torch.Tensor, pred_sum: torch.Tensor, gt_sum: torch.Tensor) -> torch.Tensor:
    denom = pred_sum + gt_sum
    both_empty = (pred_sum == 0) & (gt_sum == 0)
    one_empty = (pred_sum == 0) ^ (gt_sum == 0)
    regular = 2.0 * tp / torch.where(denom > 0, denom, torch.ones_like(denom))
    one = torch.ones_like(regular)
    return torch.where(both_empty, one, torch.where(one_empty, torch.zeros_like(regular), regular))


def dice_bin_masked(pred: torch.Tensor, gt: torch.Tensor, ignore_index: int | None) -> torch.Tensor:
    """Binary Dice of {0,1} ``pred`` (..., H, W) against ``gt`` (..., H, W)
    that may hold ``ignore_index`` (masked per rater); returns (...)."""
    valid = torch.ones_like(gt, dtype=torch.bool) if ignore_index is None else gt != ignore_index
    pred_pos = (pred == 1) & valid
    gt_pos = (gt == 1) & valid
    tp = (pred_pos & gt_pos).sum(dim=(-2, -1)).float()
    return dice_from_counts(tp, pred_pos.sum(dim=(-2, -1)).float(), gt_pos.sum(dim=(-2, -1)).float())


def dice_multiclass_macro(pred_idx: torch.Tensor, target_idx: torch.Tensor, num_classes: int,
                          ignore_index: int | None = None,
                          include_background: bool = False) -> torch.Tensor:
    """Macro-averaged Dice of (..., H, W) index maps (``dice_multiclass_macro``
    of the JAX package, ``test_2D.py:901-918`` with ``average="macro"``).

    Per-class Dice 2TP/(P+T) over the included classes; classes with no
    pixel in either map are left out of the mean; 1.0 if no class has one.
    """
    valid = (torch.ones_like(target_idx, dtype=torch.bool) if ignore_index is None
             else target_idx != ignore_index)
    classes = torch.arange(0 if include_background else 1, num_classes,
                           device=target_idx.device)[:, None, None]
    pred_c = (pred_idx.unsqueeze(-3) == classes) & valid.unsqueeze(-3)
    tgt_c = (target_idx.unsqueeze(-3) == classes) & valid.unsqueeze(-3)
    tp = (pred_c & tgt_c).sum(dim=(-2, -1)).float()
    denom = (pred_c.sum(dim=(-2, -1)) + tgt_c.sum(dim=(-2, -1))).float()
    present = denom > 0
    per_class = 2.0 * tp / torch.where(present, denom, torch.ones_like(denom))
    n_present = present.sum(dim=-1)
    mean = (torch.where(present, per_class, torch.zeros_like(per_class)).sum(dim=-1)
            / n_present.clamp(min=1))
    return torch.where(n_present > 0, mean, torch.ones_like(mean))
