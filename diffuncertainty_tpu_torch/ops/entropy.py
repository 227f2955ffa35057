"""TU/AU/EU entropy decomposition (port of ``diffuncertainty_tpu/ops/entropy.py``).

TU = H[mean_p softmax], AU = mean_p H[softmax_p], EU = TU - AU, with
p log p taken as 0 at p == 0.
"""

from __future__ import annotations

import torch


def _xlogx(p: torch.Tensor) -> torch.Tensor:
    safe = torch.where(p > 0, p, torch.ones_like(p))
    return torch.where(p > 0, p * torch.log(safe), torch.zeros_like(p))


def entropy(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return -_xlogx(probs).sum(dim=dim)


def uncertainty_heatmaps(
    softmax_preds: torch.Tensor, *, sample_axis: int = 0, class_axis: int = 1
) -> dict[str, torch.Tensor]:
    """TU/AU/EU from a stack of softmax predictions (axes as in the JAX op)."""
    mean_softmax = softmax_preds.mean(dim=sample_axis)
    mean_class_axis = class_axis if class_axis < 0 else class_axis - (sample_axis < class_axis)
    tu = entropy(mean_softmax, dim=mean_class_axis)
    au = entropy(softmax_preds, dim=class_axis).mean(dim=sample_axis)
    return {"TU": tu, "AU": au, "EU": tu - au}


def one_minus_msr(softmax_pred: torch.Tensor, class_axis: int = 0) -> torch.Tensor:
    """Single-prediction fallback: 1 - max softmax response."""
    return 1.0 - softmax_pred.amax(dim=class_axis)
