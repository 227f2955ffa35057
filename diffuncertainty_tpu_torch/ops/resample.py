"""2x up/down-sampling as the DiffUnet uses it (port of
``diffuncertainty_tpu/ops/resample.py``). Layout NHWC."""

from __future__ import annotations

import torch


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of ``(B, H, W, C)`` (each pixel duplicated); the
    bilinear mode of the JAX op belongs to ``new_upsample_method``, not ported."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def downsample_avgpool2x(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on ``(B, H, W, C)``."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
