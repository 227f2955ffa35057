"""Host-side augmentations (port of ``diffuncertainty_tpu/data/augment_extra.py``):
the label-space ambiguity of street scenes (``stochastic_label_switches``,
the reference's ``augmentations.py:8-60``) and the retina artifacts that the
OOD shifts of ``data/ood.py`` apply (``fov_circular_mask``, ``flash_artifact``
(``:332-475``), ``filtered_image_noise`` (``:477-539``)). Pure numpy with an
explicit ``np.random.Generator``."""

from __future__ import annotations

import numpy as np
import scipy.ndimage as nd

from . import cityscapes_labels as cs


def stochastic_label_switches(
    mask: np.ndarray,
    rng: np.random.Generator,
    n_reference_samples: int = 1,
    switch_probs: dict | None = None,
) -> np.ndarray:
    """Per-class Bernoulli switches to the ``*_2`` alternate train ids.

    Returns (H, W) when n_reference_samples == 1 else (N, H, W).
    """
    probs = switch_probs or cs.LABEL_SWITCH_PROBS
    outs = []
    for _ in range(n_reference_samples):
        m = mask.copy()
        for name, p in probs.items():
            if rng.binomial(1, p):
                m[m == cs.name2trainId[name]] = cs.name2trainId[f"{name}_2"]
        outs.append(m)
    return outs[0] if len(outs) == 1 else np.stack(outs)


def _sample_param(rng, param):
    if isinstance(param, (list, tuple)) and len(param) == 2:
        return float(rng.uniform(param[0], param[1]))
    return float(param)


def fov_circular_mask(
    img: np.ndarray,
    rng: np.random.Generator,
    *,
    radius=0.5,
    edge_blur=0.02,
    circle_dist=0.2,
    value_range: float = 255.0,
) -> np.ndarray:
    """Retina camera field-of-view: circular mask with linear edge falloff."""
    orig_dtype = img.dtype
    out = img.astype(np.float32, copy=True)
    h, w = out.shape[:2]
    radius_n = _sample_param(rng, radius)
    edge_n = _sample_param(rng, edge_blur)
    dist_n = _sample_param(rng, circle_dist)
    shift = radius_n - dist_n
    angle = rng.uniform(0, 2 * np.pi)
    cy = 0.0 + shift * np.sin(angle)
    cx = 0.0 + shift * np.cos(angle)
    yy = np.arange(h, dtype=np.float32) / h - 0.5
    xx = np.arange(w, dtype=np.float32) / w - 0.5
    gy, gx = np.meshgrid(yy, xx, indexing="ij")
    d = np.sqrt((gy - cy) ** 2 + (gx - cx) ** 2)
    mask = np.clip((radius_n + edge_n - d) / (2 * edge_n), 0, 1)
    if out.ndim == 3:
        mask = mask[..., None]
    return np.clip(out * mask, 0, value_range).astype(orig_dtype)


def flash_artifact(
    img: np.ndarray,
    rng: np.random.Generator,
    *,
    additive: bool = False,
    additive_range=(-0.3, 1.0),
    multiplicative_range=(0.2, 2.0),
    size: float = 0.3,
    sharpness: float = 8.0,
    eccentricity=(0.0, 0.6),
    center_shift=(0.0, 0.3),
    value_range: float = 255.0,
) -> np.ndarray:
    """Elliptical sigmoid flash spot (``augmentations.py:332-475``)."""
    orig_dtype = img.dtype
    out = img.astype(np.float32, copy=True)
    h, w = out.shape[:2]
    ecc = _sample_param(rng, eccentricity)
    shift = rng.uniform(*(np.asarray(center_shift) * h)) if isinstance(center_shift, (tuple, list)) else center_shift * h
    rot = rng.uniform(0, 2 * np.pi)
    a = size
    b = size * (1 - ecc)
    sangle = rng.uniform(0, 2 * np.pi)
    cy = shift / h * np.sin(sangle)
    cx = shift / h * np.cos(sangle)
    yy = np.arange(h, dtype=np.float32) / h - 0.5
    xx = np.arange(w, dtype=np.float32) / w - 0.5
    gy, gx = np.meshgrid(yy, xx, indexing="ij")
    dx, dy = gx - cx, gy - cy
    dxr = dx * np.cos(rot) + dy * np.sin(rot)
    dyr = -dx * np.sin(rot) + dy * np.cos(rot)
    level = np.clip(sharpness * ((dxr / a) ** 2 + (dyr / b) ** 2 - 1.0), -50, 50)
    sig = 1.0 / (1.0 + np.exp(level))
    if additive:
        lo, hi = additive_range
        intensity = (lo + sig * (hi - lo)) * value_range
        result = out + (intensity[..., None] if out.ndim == 3 else intensity)
    else:
        lo, hi = multiplicative_range
        intensity = lo + sig * (hi - lo)
        result = out * (intensity[..., None] if out.ndim == 3 else intensity)
    return np.clip(result, 0, value_range).astype(orig_dtype)


def filtered_image_noise(
    img: np.ndarray,
    rng: np.random.Generator,
    *,
    noise_scale: float = 0.125,
    sigma: float = 2.3,
    value_range: float = 1.0,
) -> np.ndarray:
    """Intensity-modulated spatially-filtered noise (``:477-539``)."""
    orig_dtype = img.dtype
    out = img.astype(np.float32, copy=True)
    h, w = out.shape[:2]
    noise = nd.gaussian_filter(rng.standard_normal((h, w)).astype(np.float32), sigma)
    std = float(np.std(noise))
    if std > 1e-6:
        noise = (noise - float(np.mean(noise))) / std
    noise = noise_scale * noise
    if out.ndim == 3:
        noise = noise[..., None]
    return np.clip(out + noise * out, 0.0, value_range).astype(orig_dtype)
