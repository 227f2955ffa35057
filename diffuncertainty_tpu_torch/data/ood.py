"""OOD corruption generators (port of ``diffuncertainty_tpu/data/ood.py``).

Reference shifts (``datasets/lidc-idri/gen_splits_lidc.py:232-260``,
``vis_ood_aug.py:221-274``, ``datasets/retina/create_augmented_ood.py``,
``datasets/npc/create_npc_augmented_ood.py``):

- LIDC: ``ood_noise`` (Gaussian, no clip), ``ood_blur`` (sigma proportional
  to resolution), ``ood_contrast`` (adaptive hist-equalization), ``ood_jpeg``
  (compression round-trip);
- retina: ``ood_fov`` (circular field-of-view), ``ood_flash``, ``ood_blur``;
- NPC: ``ood_gibbs`` (k-space truncation ringing).

``generate_ood_split`` applies a shift to every image of a source split and
writes ``preprocessed/augmented/<shift>/images`` + the split entries, the
same contract the dataset reader consumes.

The JAX module compresses ``ood_jpeg``'s images with PIL; here
``data/jpeg.py`` runs the same round trip (libjpeg's integer pipeline, equal
to Pillow's bit for bit). Every other shift is the JAX module's numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.ndimage as nd

from .augment_extra import filtered_image_noise, flash_artifact, fov_circular_mask
from .dataset import load_splits, save_splits
from .jpeg import jpeg_round_trip


# --------------------------------------------------------------------------
# pixel corruptions
# --------------------------------------------------------------------------

def ood_noise(img: np.ndarray, rng: np.random.Generator, std: float = 0.2) -> np.ndarray:
    """Additive Gaussian noise WITHOUT clipping (reference keeps overflow)."""
    return (img + std * rng.standard_normal(img.shape)).astype(np.float32)


def ood_blur(img: np.ndarray, rng: np.random.Generator, sigma_frac: float = 0.02) -> np.ndarray:
    """Gaussian blur with sigma proportional to resolution."""
    sigma = sigma_frac * max(img.shape[:2])
    if img.ndim == 3:
        return np.stack(
            [nd.gaussian_filter(img[..., c], sigma) for c in range(img.shape[-1])], -1
        ).astype(np.float32)
    return nd.gaussian_filter(img, sigma).astype(np.float32)


def ood_contrast(img: np.ndarray, rng: np.random.Generator, clip_limit: float = 0.01,
                 n_bins: int = 256, tiles: int = 8) -> np.ndarray:
    """Tile-based CLAHE (adaptive histogram equalization with clipping)."""
    x = np.clip(img.astype(np.float32), 0.0, 1.0)

    def clahe_channel(ch: np.ndarray) -> np.ndarray:
        h, w = ch.shape
        th, tw = max(1, h // tiles), max(1, w // tiles)
        out = np.zeros_like(ch)
        # per-tile clipped CDF lookup, bilinearly blended via overlapping mean
        for ti in range(tiles):
            for tj in range(tiles):
                ys, xs = ti * th, tj * tw
                ye = h if ti == tiles - 1 else (ti + 1) * th
                xe = w if tj == tiles - 1 else (tj + 1) * tw
                tile = ch[ys:ye, xs:xe]
                hist, edges = np.histogram(tile, bins=n_bins, range=(0, 1))
                hist = hist.astype(np.float64)
                clip = max(clip_limit * tile.size, 1.0)
                excess = np.maximum(hist - clip, 0).sum()
                hist = np.minimum(hist, clip) + excess / n_bins
                cdf = np.cumsum(hist)
                cdf = cdf / cdf[-1]
                idx = np.clip((tile * (n_bins - 1)).astype(int), 0, n_bins - 1)
                out[ys:ye, xs:xe] = cdf[idx]
        return out

    if x.ndim == 3:
        return np.stack([clahe_channel(x[..., c]) for c in range(x.shape[-1])], -1)
    return clahe_channel(x)


def ood_jpeg(img: np.ndarray, rng: np.random.Generator, quality: int = 20) -> np.ndarray:
    """JPEG compression round trip."""
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:  # one channel: an L image
        arr = arr[..., 0]
    back = jpeg_round_trip(arr, quality).astype(np.float32) / 255.0
    if img.ndim == 3 and back.ndim == 2:
        back = back[..., None].repeat(img.shape[-1], -1)
    return back


def ood_gibbs(img: np.ndarray, rng: np.random.Generator, keep_frac: float = 0.35) -> np.ndarray:
    """Gibbs-ringing: truncate high k-space frequencies (NPC MRI shift)."""

    def one(ch):
        f = np.fft.fftshift(np.fft.fft2(ch))
        h, w = ch.shape
        kh, kw = int(h * keep_frac / 2), int(w * keep_frac / 2)
        mask = np.zeros_like(f, dtype=bool)
        mask[h // 2 - kh : h // 2 + kh, w // 2 - kw : w // 2 + kw] = True
        return np.real(np.fft.ifft2(np.fft.ifftshift(f * mask))).astype(np.float32)

    if img.ndim == 3:
        return np.stack([one(img[..., c]) for c in range(img.shape[-1])], -1)
    return one(img)


def ood_fov(img, rng, **kw):
    return fov_circular_mask(img, rng, value_range=1.0, **kw)


def ood_flash(img, rng, **kw):
    return flash_artifact(img, rng, value_range=1.0, **kw)


def ood_filtered_noise(img, rng, **kw):
    return filtered_image_noise(img, rng, value_range=1.0, **kw)


SHIFTS = {
    "ood_noise": ood_noise,
    "ood_blur": ood_blur,
    "ood_contrast": ood_contrast,
    "ood_jpeg": ood_jpeg,
    "ood_gibbs": ood_gibbs,
    "ood_fov": ood_fov,
    "ood_flash": ood_flash,
    "ood_filtered_noise": ood_filtered_noise,
}


# --------------------------------------------------------------------------
# split generation
# --------------------------------------------------------------------------

def generate_ood_split(
    base_dir: str | Path,
    shift: str,
    *,
    source_split: str = "id",
    splits_rel: str = "splits/default/firstCycle/splits.pkl",
    fold: int = 0,
    seed: int = 0,
    add_paired: bool = True,
    **shift_kwargs,
) -> list[str]:
    """Corrupt every image of ``source_split`` with ``shift``; write the
    augmented images and register the new split (+ paired ``id&<shift>``)."""
    base_dir = Path(base_dir)
    fn = SHIFTS[shift]
    rng = np.random.default_rng(seed)
    splits_path = base_dir / splits_rel
    folds = load_splits(splits_path)
    fold_dict = dict(folds[fold])
    source_ids = list(np.asarray(fold_dict[source_split]).tolist())
    out_dir = base_dir / "preprocessed" / "augmented" / shift / "images"
    out_dir.mkdir(parents=True, exist_ok=True)
    new_ids = []
    for rel in source_ids:
        img = np.load(base_dir / "preprocessed" / rel).astype(np.float32)
        shifted = fn(img, rng, **shift_kwargs)
        name = Path(rel).name
        np.save(out_dir / name, shifted.astype(np.float32))
        new_ids.append(f"augmented/{shift}/images/{name}")
    fold_dict[shift] = new_ids
    if add_paired:
        fold_dict[f"{source_split}&{shift}"] = source_ids + new_ids
    folds = list(folds)
    folds[fold] = fold_dict
    save_splits(folds, splits_path)
    return new_ids
