"""Binary Dice with the reference's edge cases (port of
``diffuncertainty_tpu/metrics/dice.py``): both masks empty -> 1, exactly
one empty -> 0, else 2TP / (2TP + FP + FN). Leading axes are batched."""

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
