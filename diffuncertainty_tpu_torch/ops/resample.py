"""2x up/down-sampling as the DiffUnet uses it (port of
``diffuncertainty_tpu/ops/resample.py``). Layout NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x upsample of ``(B, H, W, C)``: ``nearest`` duplicates each pixel (the
    concat-skip scheme), ``bilinear`` is torch's ``align_corners=False``
    (``new_upsample_method``)."""
    if method == "nearest":
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if method == "bilinear":
        return upsample2x_bilinear(x)
    raise NotImplementedError(method)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with ``align_corners=False``: output pixel o samples input
    coordinate (o + 0.5) / 2 - 0.5 with the edge clamped, so output 2i mixes
    inputs (i-1, i) by (0.25, 0.75) and 2i+1 mixes (i, i+1) by (0.75, 0.25),
    the edge repeated; the JAX op's separable weighted sum. One
    ``F.interpolate`` on the channels-last NCHW view."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def downsample_avgpool2x(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on ``(B, H, W, C)``."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
