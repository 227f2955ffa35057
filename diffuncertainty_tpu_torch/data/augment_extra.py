"""Host-side augmentations (port of ``diffuncertainty_tpu/data/augment_extra.py``):
the label-space ambiguity of street scenes (``stochastic_label_switches``,
the reference's ``augmentations.py:8-60``), the per-sample z-score
(``sample_normalize``), the simulated rater disagreement of nested labels
(``intensity_guided_sdf_deform``: each level's signed distance field moved
by a brightness-guided field plus smoothed noise, ``:70-200``; and the
mask-only elastic deformation ``mask_elastic_deform``) and the retina
artifacts that the OOD shifts of ``data/ood.py`` apply
(``fov_circular_mask``, ``flash_artifact`` (``:332-475``),
``filtered_image_noise`` (``:477-539``)). Pure numpy and scipy with an
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


def sample_normalize(img: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """``img`` less its mean over its std (1 where the std is below ``eps``)."""
    img = img.astype(np.float32, copy=False)
    std = float(np.std(img))
    return (img - float(np.mean(img))) / (std if std >= eps else 1.0)


def _brightness(image: np.ndarray) -> np.ndarray:
    """The luma of an RGB image (ITU-R 601 weights), else its one channel."""
    image = image.astype(np.float32)
    if image.ndim == 3 and image.shape[-1] == 3:
        return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
    if image.ndim == 3 and image.shape[-1] == 1:
        return image[..., 0]
    return image


def _binary_sdf(binary: np.ndarray) -> np.ndarray:
    """The signed distance to the mask's edge: positive inside, half a pixel
    in from the boundary on each side."""
    binary = binary.astype(bool)
    return np.clip(nd.distance_transform_edt(binary) - 0.5, 0, None) - np.clip(
        nd.distance_transform_edt(~binary) - 0.5, 0, None
    )


def intensity_guided_sdf_deform(
    image: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    *,
    std_brightness_deform: float = 10.0,
    std_random_deform: float = 20.0,
    brightness_deform_weight: float = 5.0,
    random_deform_weight: float = 5.0,
) -> np.ndarray:
    """Deform nested integer labels 1..K (or a one-hot (H, W, K) mask) by
    moving each level's SDF with a brightness-guided field plus Gaussian-
    smoothed noise, one normal draw per level; a level with no inside or no
    outside takes the noise alone."""
    brightness = _brightness(image)
    labels = (
        np.argmax(mask, axis=-1).astype(np.int32)
        if mask.ndim == 3
        else mask.astype(np.int32)
    )
    out = np.zeros_like(labels)
    for label_idx in range(1, int(labels.max()) + 1):
        binary = labels >= label_idx
        inside = binary.astype(bool)
        if inside.sum() == 0 or (~inside).sum() == 0:
            delta_brightness = np.zeros_like(brightness, np.float32)
        else:
            sdf = _binary_sdf(binary)
            blur = nd.gaussian_filter(brightness, sigma=std_brightness_deform)
            band_in = brightness[(sdf > 0) & (sdf < std_brightness_deform)]
            band_out = brightness[(sdf < 0) & (sdf > -std_brightness_deform)]
            mean_in = band_in.mean() if band_in.size else 1.0
            mean_out = band_out.mean() if band_out.size else 0.0
            denom = mean_in - mean_out if abs(mean_in - mean_out) > 1e-9 else 1.0
            delta_brightness = 2.0 * ((blur - mean_out) / denom) - 1.0
        noise = rng.standard_normal(brightness.shape).astype(np.float32)
        delta_random = nd.gaussian_filter(noise, sigma=std_random_deform)
        mean_abs = np.mean(np.abs(delta_random))
        delta_random = delta_random / mean_abs if mean_abs > 1e-6 else np.zeros_like(delta_random)
        delta = (
            brightness_deform_weight * delta_brightness
            + random_deform_weight * delta_random
        )
        deformed = (_binary_sdf(binary) + delta) >= 0.0
        out[deformed] = label_idx
    return out.astype(mask.dtype)


def mask_elastic_deform(
    mask: np.ndarray,
    rng: np.random.Generator,
    *,
    alpha: float = 30.0,
    sigma: float = 6.0,
) -> np.ndarray:
    """Mask-only elastic deformation (the reference's
    ``MaskOnlyElasticTransform``): a nearest-neighbour resample of ``mask``
    along smoothed normal displacements scaled by ``alpha``."""
    h, w = mask.shape[:2]
    dx = nd.gaussian_filter(rng.standard_normal((h, w)), sigma) * alpha
    dy = nd.gaussian_filter(rng.standard_normal((h, w)), sigma) * alpha
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([yy + dy, xx + dx])
    return nd.map_coordinates(mask, coords, order=0, mode="nearest").astype(mask.dtype)


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
