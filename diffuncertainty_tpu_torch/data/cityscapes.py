"""GTA5 -> Cityscapes street-scene dataset (the dataset part of
``diffuncertainty_tpu/data/cityscapes.py``; the reference's
``cityscapes_dataset.py``).

npy images with ONE annotation mask each (``{base_id}_mask.npy``); the
aleatoric ambiguity of the ground truth is synthesized by
``data/augment_extra.py::stochastic_label_switches`` (per-class Bernoulli
switches to the ``*_2`` alternate train ids). With ``return_all_raters``
(evaluation) a sample carries ``n_reference_samples`` switched references
drawn from a generator seeded ``(seed, idx)``, the same every load; without
it (training) one mask switched afresh with the loader's generator.

``preprocess_gta_cityscapes`` (the JAX module's ``:73-110``, the reference's
``datasets/gta_cityscapes/preprocess_gta_cityscapes*.py``) brings raw frames
to a common size: images through ``data/resize.py``'s ``resize_bilinear`` and
masks through its ``resize_nearest``, where JAX calls PIL.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import cityscapes_labels as cs
from .augment_extra import stochastic_label_switches
from .dataset import MultiRaterDataset
from .resize import resize_bilinear, resize_nearest


class CityscapesDataset(MultiRaterDataset):
    """Single-mask dataset with label-switch reference sampling."""

    def __init__(self, splits_path, base_dir, split: str = "train", data_fold_id: int = 0,
                 return_all_raters: bool = True, n_reference_samples: int = 4,
                 switch_probs: dict | None = None, seed: int = 13,
                 dataset_label: str = "cityscapes"):
        super().__init__(splits_path, base_dir, split=split, num_raters=1,
                         data_fold_id=data_fold_id, return_all_raters=False,
                         single_rater=False, rater_pattern="{base_id}_mask.npy",
                         dataset_label=dataset_label)
        self.return_switched_references = return_all_raters
        self.n_reference_samples = n_reference_samples
        self.switch_probs = switch_probs or cs.LABEL_SWITCH_PROBS
        self._seed = seed

    def load(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        sample = super().load(idx, rng)
        mask = sample["seg"]
        if self.return_switched_references:
            stable = np.random.default_rng((self._seed, idx))
            sample["seg"] = np.asarray(stochastic_label_switches(
                mask, stable, self.n_reference_samples, self.switch_probs), np.int32)
        else:
            sample["seg"] = np.asarray(stochastic_label_switches(
                mask, rng or np.random.default_rng(), 1, self.switch_probs), np.int32)
        return sample


def preprocess_gta_cityscapes(
    raw_dir: str | Path,
    out_dir: str | Path,
    *,
    size: tuple[int, int] = (256, 512),
    dataset_name: str = "gta",
) -> list[str]:
    """Downscale raw (image.npy, {id}_mask.npy) pairs to ``size`` (H, W):
    images as 8-bit samples with Pillow's bilinear filter (an ``L`` or
    ``RGB`` image, saved float32 in [0, 1]), masks with Pillow's nearest on
    int32 labels (saved uint8)."""
    raw_dir, out_dir = Path(raw_dir), Path(out_dir)
    img_out = out_dir / "preprocessed" / "images"
    lbl_out = out_dir / "preprocessed" / "labels"
    img_out.mkdir(parents=True, exist_ok=True)
    lbl_out.mkdir(parents=True, exist_ok=True)
    rel_ids = []
    for img_path in sorted(raw_dir.glob("*.npy")):
        if img_path.name.endswith("_mask.npy"):
            continue
        base = img_path.stem
        img = np.load(img_path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
            raise ValueError(f"{img_path}: an image is (H, W) or (H, W, 3), got {img.shape}")
        img_small = resize_bilinear((np.clip(img, 0, 1) * 255).astype(np.uint8), size)
        np.save(img_out / f"{base}.npy", img_small.astype(np.float32) / 255.0)
        mask = np.load(raw_dir / f"{base}_mask.npy")
        mask_small = resize_nearest(mask.astype(np.int32), size)
        np.save(lbl_out / f"{base}_mask.npy", mask_small.astype(np.uint8))
        rel_ids.append(f"images/{base}.npy")
    return rel_ids
