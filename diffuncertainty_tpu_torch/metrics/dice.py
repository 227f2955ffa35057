"""Dice (port of ``diffuncertainty_tpu/metrics/dice.py``): binary Dice with
the reference's edge cases (both masks empty -> 1, exactly one empty -> 0,
else 2TP / (2TP + FP + FN)), the multiclass macro and micro Dice, and the
soft Dice loss of training. Leading axes are batched. ``rater_weights`` and
``rater_mean`` leave out the raters a variable-rater batch pads
(``metrics/ged.py`` of the JAX package)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_from_counts(tp: torch.Tensor, pred_sum: torch.Tensor, gt_sum: torch.Tensor) -> torch.Tensor:
    denom = pred_sum + gt_sum
    both_empty = (pred_sum == 0) & (gt_sum == 0)
    one_empty = (pred_sum == 0) ^ (gt_sum == 0)
    regular = 2.0 * tp / torch.where(denom > 0, denom, torch.ones_like(denom))
    one = torch.ones_like(regular)
    return torch.where(both_empty, one, torch.where(one_empty, torch.zeros_like(regular), regular))


def dice_bin(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Binary Dice of (..., H, W) masks (nonzero is foreground); returns (...)."""
    pred, gt = pred.bool(), gt.bool()
    tp = (pred & gt).sum(dim=(-2, -1)).float()
    return dice_from_counts(tp, pred.sum(dim=(-2, -1)).float(), gt.sum(dim=(-2, -1)).float())


def dice_multiclass_micro(pred_idx: torch.Tensor, target_idx: torch.Tensor, num_classes: int,
                          ignore_index: int | None = 255,
                          include_background: bool = True) -> torch.Tensor:
    """Micro-averaged Dice of (..., H, W) index maps; returns (...).

    With ``include_background`` it is the accuracy over the valid pixels;
    without, the foreground micro Dice over classes >= 1. No valid pixel ->
    1.0; without background, both maps all background -> 1.0.
    """
    valid = (torch.ones_like(target_idx, dtype=torch.bool) if ignore_index is None
             else target_idx != ignore_index)
    n_valid = valid.sum(dim=(-2, -1)).float()
    one = torch.ones_like(n_valid)
    if include_background:
        correct = ((pred_idx == target_idx) & valid).sum(dim=(-2, -1)).float()
        return torch.where(n_valid == 0, one, correct / torch.where(n_valid > 0, n_valid, one))
    pred_fg = (pred_idx >= 1) & valid
    tgt_fg = (target_idx >= 1) & valid
    tp = (pred_fg & tgt_fg & (pred_idx == target_idx)).sum(dim=(-2, -1)).float()
    denom = (pred_fg.sum(dim=(-2, -1)) + tgt_fg.sum(dim=(-2, -1))).float()
    score = 2.0 * tp / torch.where(denom > 0, denom, one)
    return torch.where((n_valid == 0) | (denom == 0), one, score)


def soft_dice_loss(probs: torch.Tensor, target_idx: torch.Tensor,
                   smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice loss of NHWC probabilities against (B, H, W) class indices:
    the mean over batch and classes of ``-(2*intersect + s) / (denom + s)``
    (``loss_modules.py:soft_dice`` of the reference, background included)."""
    num_classes = probs.shape[-1]
    onehot = F.one_hot(target_idx.long().clamp(0, num_classes - 1), num_classes).to(probs.dtype)
    axes = tuple(range(1, probs.ndim - 1))  # spatial
    intersect = (probs * onehot).sum(dim=axes)
    denom = (probs + onehot).sum(dim=axes)
    return (-((2.0 * intersect + smooth) / (denom + smooth))).mean()


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


def rater_weights(n_gt: int, n_raters: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, n): w (..., G) is 1.0 for the true raters (index < ``n_raters``,
    shape (...)) and 0.0 for padding; n (...) their count, at least 1."""
    n_raters = torch.as_tensor(n_raters)
    w = (torch.arange(n_gt, device=n_raters.device) < n_raters.unsqueeze(-1)).float()
    return w, w.sum(dim=-1).clamp(min=1.0)


def rater_mean(scores: torch.Tensor, n_raters: torch.Tensor | None) -> torch.Tensor:
    """Mean of (..., G) per-rater ``scores`` over the true raters (all of
    them when ``n_raters`` is None)."""
    if n_raters is None:
        return scores.mean(dim=-1)
    w, n = rater_weights(scores.shape[-1], n_raters.to(scores.device))
    return (scores * w).sum(dim=-1) / n
