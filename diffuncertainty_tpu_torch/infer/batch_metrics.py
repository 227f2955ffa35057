"""Per-batch metrics on a prediction stack (port of the binary path of
``diffuncertainty_tpu/infer/batch_metrics.py``, without NLL).

Per image: Dice of the mean prediction's argmax against every rater
(averaged), BMA-GED over the group means, grouped GED averaged over groups,
and the TU/AU/EU heatmaps over the group means (1 - MSR for a single group).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..metrics.dice import dice_bin_masked
from ..metrics.ged import ged_binary
from ..ops.entropy import one_minus_msr, uncertainty_heatmaps
from ..sampling.sampler import PredictionStack


def make_batch_metrics(*, num_classes: int, ignore_index: int | None,
                       compute_ged: bool = True) -> Callable:
    """Build ``fn(stack, gt) -> dict`` with gt (B, R, H, W) int labels."""
    if num_classes != 2:
        raise NotImplementedError("only the binary metrics are ported")
    ged_ign = ignore_index if (ignore_index is not None and ignore_index >= 0) else None

    @torch.no_grad()
    def fn(stack: PredictionStack, gt: torch.Tensor) -> dict:
        gp = stack.groups.movedim(2, 0)  # (B, G, S, H, W, C)
        gm = stack.group_means.movedim(1, 0)  # (B, G, H, W, C)
        mean_idx = stack.mean.argmax(dim=-1)  # (B, H, W)
        out: dict = {"mean_idx": mean_idx, "group_idx": gm.argmax(dim=-1)}
        out["dice"] = dice_bin_masked(mean_idx.unsqueeze(1), gt, ignore_index).mean(dim=-1)
        bma = ged_binary(gm, gt, ged_ign)
        for k in ("max_dice_pred", "max_dice_gt", "major_dice"):
            out[k] = bma[k]
        out["ged_bma"] = bma["ged"]
        if compute_ged:  # grouped GED: one GED per group, averaged
            out["ged"] = ged_binary(gp, gt.unsqueeze(1), ged_ign)["ged"].mean(dim=-1)
        if gm.shape[1] > 1:
            out["heatmaps"] = uncertainty_heatmaps(gm, sample_axis=1, class_axis=-1)
        else:
            out["heatmaps"] = {"pred_entropy": one_minus_msr(gm[:, 0], class_axis=-1)}
        return out

    return fn
