"""Per-batch metrics on a prediction stack (port of
``diffuncertainty_tpu/infer/batch_metrics.py``).

Per image:

- Dice of the mean prediction's argmax against every rater (binary Dice, or
  the multiclass macro Dice), averaged over the true raters;
- BMA-GED over the group means (with max_dice_pred, max_dice_gt and
  major_dice) and the grouped GED, one GED per group averaged over groups;
- the TU/AU/EU heatmaps over the group means (1 - MSR for a single group);
- NLL: per (rater, group) the mean negative log probability of the rater's
  label over its valid pixels (``gt_model_NLL``), its mean over groups
  (``gt_NLL``) and over both (``mean_NLL``), and ``gen_NLL`` over the
  samples of the generative groups; probabilities are clipped at ``eps``.

``num_raters`` (B,) is the true rater count of each image: raters padded
past it are left out of the Dice, GED and NLL means. Without it, every rater
counts.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..metrics.dice import dice_bin_masked, dice_multiclass_macro, rater_mean, rater_weights
from ..metrics.ged import ged_binary, ged_multiclass
from ..ops.entropy import one_minus_msr, uncertainty_heatmaps
from ..sampling.sampler import PredictionStack, SamplerMeta


def make_batch_metrics(*, num_classes: int, ignore_index: int | None,
                       meta: SamplerMeta | None = None, compute_dice: bool = True,
                       compute_ged: bool = True, compute_ged_bma: bool = True,
                       compute_likelihood: bool = True, eps: float = 1e-12) -> Callable:
    """Build ``fn(stack, gt, num_raters=None) -> dict`` with gt (B, R, H, W)
    int labels. ``meta`` (the sampler's) marks the generative groups for
    ``gen_NLL``; without it there is no ``gen_NLL``."""
    binary = num_classes == 2
    ged_ign = ignore_index if (ignore_index is not None and ignore_index >= 0) else None
    gen_idx = ([] if meta is None
               else [g for g, gen in enumerate(meta.group_is_generative) if gen])

    def ged(probs, gt, n_raters):
        """GED of (B, P, H, W, C) against (B, R, H, W) -> the dict of (B,) values."""
        if binary:
            return ged_binary(probs, gt, ged_ign, n_raters=n_raters)
        per_image = [ged_multiclass(probs[b], gt[b], num_classes, ged_ign,
                                    n_raters=None if n_raters is None else n_raters[b])
                     for b in range(gt.shape[0])]
        return {k: torch.stack([r[k] for r in per_image])
                for k in ("ged", "max_dice_pred", "max_dice_gt", "major_dice")}

    def nll(probs, gt, valid, vcount, w):
        """(B, K, H, W, C) probabilities -> (B, R, K) NLL of each rater's
        labels over its valid pixels, 0 for a rater without any, times the
        rater's weight."""
        b, k = probs.shape[:2]
        r = gt.shape[1]
        logp = torch.log(probs.clamp(min=eps))
        idx = gt.clamp(0, num_classes - 1)[:, :, None, :, :, None].expand(
            b, r, k, *gt.shape[2:], 1)
        picked = torch.gather(logp.unsqueeze(1).expand(b, r, *logp.shape[1:]), -1, idx)[..., 0]
        out = -((picked * valid.unsqueeze(2)).sum(dim=(-2, -1))
                / vcount.clamp(min=1.0).unsqueeze(-1))
        return torch.where(vcount.unsqueeze(-1) > 0, out, torch.zeros_like(out)) * w.unsqueeze(-1)

    @torch.no_grad()
    def fn(stack: PredictionStack, gt: torch.Tensor, num_raters: torch.Tensor | None = None
           ) -> dict:
        gp = stack.groups.movedim(2, 0)  # (B, G, S, H, W, C)
        gm = stack.group_means.movedim(1, 0)  # (B, G, H, W, C)
        mean_idx = stack.mean.argmax(dim=-1)  # (B, H, W)
        out: dict = {"mean_idx": mean_idx, "group_idx": gm.argmax(dim=-1)}
        if compute_dice:
            pred = mean_idx.unsqueeze(1).expand_as(gt)
            d = (dice_bin_masked(pred, gt, ignore_index) if binary
                 else dice_multiclass_macro(pred, gt, num_classes, ignore_index=ignore_index))
            out["dice"] = rater_mean(d, num_raters)  # (B,)
        if compute_ged_bma:
            bma = ged(gm, gt, num_raters)
            out["ged_bma"] = bma["ged"]
            for k in ("max_dice_pred", "max_dice_gt", "major_dice"):
                out[k] = bma[k]
        if compute_ged:  # grouped GED: one GED per group, averaged over groups
            if binary:
                per_group = ged_binary(gp, gt.unsqueeze(1), ged_ign, n_raters=(
                    None if num_raters is None else num_raters.unsqueeze(1)))["ged"]
            else:
                per_group = torch.stack([ged(gp[:, g], gt, num_raters)["ged"]
                                         for g in range(gp.shape[1])], dim=1)
            out["ged"] = per_group.mean(dim=-1)
        if gm.shape[1] > 1:
            out["heatmaps"] = uncertainty_heatmaps(gm, sample_axis=1, class_axis=-1)
        else:
            out["heatmaps"] = {"pred_entropy": one_minus_msr(gm[:, 0], class_axis=-1)}
        if compute_likelihood:
            valid = (gt != ignore_index if ignore_index is not None and ignore_index >= 0
                     else torch.ones_like(gt, dtype=torch.bool))
            vcount = valid.sum(dim=(-2, -1)).float()  # (B, R)
            n_r = (num_raters if num_raters is not None
                   else torch.full(gt.shape[:1], gt.shape[1], device=gt.device))
            w, n = rater_weights(gt.shape[1], n_r.to(gt.device))
            nll_rg = nll(gm, gt, valid, vcount, w)  # (B, R, G)
            out["gt_model_NLL"] = nll_rg
            out["gt_NLL"] = nll_rg.mean(dim=-1)
            out["mean_NLL"] = nll_rg.sum(dim=(-2, -1)) / (n * nll_rg.shape[-1])
            if gen_idx:
                samples = gp[:, gen_idx].flatten(1, 2)  # (B, gen groups x S, H, W, C)
                nll_rs = nll(samples, gt, valid, vcount, w)
                out["gen_NLL"] = nll_rs.sum(dim=(-2, -1)) / (n * nll_rs.shape[-1])
        return out

    return fn
