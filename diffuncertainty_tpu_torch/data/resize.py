"""Pillow's ``Image.resize`` for 8-bit ``BILINEAR`` and 32-bit-integer
``NEAREST`` in numpy (the port has no PIL).

- ``resize_bilinear``: Pillow's separable convolution (``Resample.c``): per
  output sample the triangle filter centred at ``(x + 0.5) * scale`` with its
  support widened by the scale when downscaling, the weights normalized,
  then fixed point with 22 precision bits (``normalize_coeffs_8bpc``);
  rounded (half added) and clipped to 0..255 after the horizontal pass and
  again after the vertical one, as Pillow's two passes do.
- ``resize_nearest``: Pillow's affine nearest (``Geometry.c::
  ImagingScaleAffine``): the source index is ``floor(x0)`` of the position
  that starts at ``scale / 2`` and adds ``scale`` per output sample, in
  double precision.

Sizes are (height, width) here; Pillow's are (width, height).
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point weights of
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the triangle
    filter (support 1) over the whole input."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    weights = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) * ss), 0.0)
        total = 0.0
        for v in w:  # Pillow sums in order
            total += v
        if total != 0.0:
            w = w / total
        weights[xx, xmin:xmax] = np.where(
            w < 0, (-0.5 + w * (1 << PRECISION_BITS)).astype(np.int64),
            (0.5 + w * (1 << PRECISION_BITS)).astype(np.int64))
    return weights


def _pass(samples: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    # in float64, exactly: every product and partial sum is an integer below
    # 255 * 2**22 * (input size) < 2**53, and BLAS is far faster than int64
    acc = np.tensordot(weights.astype(np.float64),
                       np.moveaxis(samples, axis, 0).astype(np.float64), axes=1).astype(np.int64)
    out = np.clip((acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> (h, w[, C]) as Pillow's ``L``/``RGB``
    ``resize((w, h), BILINEAR)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear takes uint8 samples, got {img.dtype}")
    h, w = size
    out = img
    if w != img.shape[1]:  # Pillow runs a pass only where the size changes
        out = _pass(out, bilinear_weights(img.shape[1], w), 1)
    if h != img.shape[0]:
        out = _pass(out, bilinear_weights(img.shape[0], h), 0)
    return out.copy() if out is img else out


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output sample of ``ImagingScaleAffine``."""
    step = float(in_size) / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.clip(np.floor(pos).astype(np.int64), 0, in_size - 1)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> (h, w[, C]) as Pillow's ``resize((w, h), NEAREST)``;
    the dtype is kept (Pillow's ``I`` mode holds int32)."""
    img = np.asarray(img)
    h, w = size
    return img[nearest_index(img.shape[0], h)][:, nearest_index(img.shape[1], w)]
