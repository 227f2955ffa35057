"""Tiled full-frame inference (port of
``diffuncertainty_tpu/infer/sliding_window.py`` without ``mesh``).

A static window grid cuts (B, H, W, C) frames into one stack of tiles, one
model call predicts the whole stack, and the tiles are stitched back with a
separable triangular (tent) weight per window, renormalized exactly, so a
constant field stitches to itself and overlapping windows cross-fade. The
last window of a row or column is moved flush with the edge when the stride
does not divide the frame.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _window_offsets(size: int, window: int, stride: int) -> list[int]:
    if window >= size:
        return [0]
    offs = list(range(0, size - window + 1, stride))
    if offs[-1] != size - window:
        offs.append(size - window)
    return offs


def _tent(window: int) -> np.ndarray:
    ramp = np.minimum(np.arange(1, window + 1), np.arange(window, 0, -1)).astype(np.float64)
    return ramp / ramp.max()


def sliding_window_predict(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    *,
    window: int,
    stride: int | None = None,
) -> torch.Tensor:
    """Tile (B, H, W, C) into windows, predict, and stitch to (B, H, W, C_out).

    ``apply_fn`` maps (N, window, window, C) -> (N, window, window, C_out)
    and is called once on the whole tile stack, whose row ``t*B + i`` is
    window t (row-major over the grid) of image i.
    """
    b, h, w, _ = images.shape
    stride = stride or window // 2
    ys = _window_offsets(h, window, stride)
    xs = _window_offsets(w, window, stride)
    tile_stack = torch.cat([images[:, y:y + window, x:x + window] for y in ys for x in xs])
    preds = apply_fn(tile_stack)
    c_out = preds.shape[-1]

    weight_2d = torch.from_numpy(np.outer(_tent(window), _tent(window))).to(
        dtype=preds.dtype, device=preds.device)[None, :, :, None]
    acc = torch.zeros((b, h, w, c_out), dtype=preds.dtype, device=preds.device)
    norm = torch.zeros((b, h, w, 1), dtype=preds.dtype, device=preds.device)
    idx = 0
    for y in ys:
        for x in xs:
            acc[:, y:y + window, x:x + window] += preds[idx * b:(idx + 1) * b] * weight_2d
            norm[:, y:y + window, x:x + window] += weight_2d
            idx += 1
    return acc / norm.clamp(min=1e-8)
