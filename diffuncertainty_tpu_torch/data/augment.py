"""Input normalization (``normalize_batch`` of
``diffuncertainty_tpu/data/augment.py``)."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize_batch(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """(x - mean) / std over the channel axis, max_pixel_value 1 (albumentations Normalize)."""
    mean_t = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std_t = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean_t) / std_t
