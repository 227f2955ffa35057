"""Synthetic street-scene toy dataset for the multi-class (GTA/Cityscapes)
pipeline (copy of ``diffuncertainty_tpu/data/gta_toy.py``, which writes the
same files for the same seed) — the controlled-environment analog of the
reference's GTA data.

Scenes are horizontal bands (sky / buildings / vegetation / sidewalk / road)
with rectangular cars on the road and elliptical persons on the sidewalk,
labeled with the standard Cityscapes trainIds (``data/cityscapes_labels.py``).
Images are per-class base colors + brightness jitter + Gaussian noise, so a
small net can learn the task quickly while the label-switch machinery
(``StochasticLabelSwitches`` -> ``*_2`` alternate ids, the reference's
aleatoric GT ambiguity for street scenes, ``augmentations.py:8-60``) stays
exactly as in the real pipeline: training consumes switched single raters;
evaluation samples switched references and
compares predicted heatmaps against the ANALYTIC switch-probability map
(``evaluation/utils/gta.py:15-45`` == ``cityscapes_labels.gt_switch_uncertainty_map``).

Train/val samples are square tiles (training shape), test samples are
full-size frames for sliding-window inference.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import cityscapes_labels as cs
from .dataset import save_splits

_CLASS_COLOR = {tid: np.asarray(color, np.float32) / 255.0
                for tid, color in cs.trainId2color.items()}


def _scene(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One street scene as a (h, w) trainId mask."""
    mask = np.full((h, w), cs.name2trainId["sky"], np.uint8)
    # jittered band boundaries (fractions of height)
    b_build = int(h * rng.uniform(0.20, 0.30))
    b_veg = int(h * rng.uniform(0.42, 0.52))
    b_side = int(h * rng.uniform(0.55, 0.62))
    b_road = int(h * rng.uniform(0.66, 0.72))
    mask[b_build:b_veg] = cs.name2trainId["building"]
    mask[b_veg:b_side] = cs.name2trainId["vegetation"]
    mask[b_side:b_road] = cs.name2trainId["sidewalk"]
    mask[b_road:] = cs.name2trainId["road"]
    # cars: rectangles on the road band
    for _ in range(rng.integers(1, 4)):
        ch = rng.integers(h // 10, h // 5)
        cw = rng.integers(w // 10, w // 4)
        y0 = rng.integers(b_road, max(b_road + 1, h - ch))
        x0 = rng.integers(0, max(1, w - cw))
        mask[y0 : y0 + ch, x0 : x0 + cw] = cs.name2trainId["car"]
    # persons: ellipses around the sidewalk band
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(rng.integers(1, 4)):
        ph = rng.integers(h // 8, h // 4)
        pw = max(2, ph // 3)
        cy = rng.integers(b_side, b_road + 1)
        cx = rng.integers(0, w)
        ellipse = ((yy - cy) / ph) ** 2 + ((xx - cx) / pw) ** 2 <= 1.0
        mask[ellipse] = cs.name2trainId["person"]
    return mask


def _render(rng: np.random.Generator, mask: np.ndarray, noise: float) -> np.ndarray:
    h, w = mask.shape
    img = np.zeros((h, w, 3), np.float32)
    for tid in np.unique(mask):
        img[mask == tid] = _CLASS_COLOR[int(tid)]
    img = img * rng.uniform(0.8, 1.2) + rng.uniform(-0.05, 0.05)
    img = img + noise * rng.standard_normal(img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def generate_gta_toy(
    out_dir: str | Path,
    *,
    num_train: int = 48,
    num_val: int = 8,
    num_test: int = 8,
    train_size: tuple[int, int] = (128, 128),
    test_size: tuple[int, int] = (256, 512),
    noise_level: float = 0.04,
    seed: int = 0,
) -> Path:
    """Generate and write the dataset; returns the base dir (idempotent per
    parameter set via ``_manifest.json``, like ``data/toy.py``)."""
    out_dir = Path(out_dir)
    manifest = {
        "num_train": num_train, "num_val": num_val, "num_test": num_test,
        "train_size": list(train_size), "test_size": list(test_size),
        "noise_level": noise_level, "seed": seed,
    }
    manifest_path = out_dir / "_manifest.json"
    if manifest_path.exists():
        try:
            if json.loads(manifest_path.read_text()) == manifest:
                return out_dir
        except (ValueError, OSError):
            pass
    rng = np.random.default_rng(seed)
    img_dir = out_dir / "preprocessed" / "images"
    lbl_dir = out_dir / "preprocessed" / "labels"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)

    def make(case_id: str, size: tuple[int, int]) -> str:
        mask = _scene(rng, *size)
        np.save(img_dir / f"{case_id}.npy", _render(rng, mask, noise_level))
        np.save(lbl_dir / f"{case_id}_mask.npy", mask)
        return f"images/{case_id}.npy"

    fold: dict = {
        "_meta": {
            "schema": "single",
            "dataset_name": "gta_toy",
            "rater_pattern": "{base_id}_mask.npy",
            "num_raters": 1,
        },
        "train": [make(f"train_{i:04d}", train_size) for i in range(num_train)],
        "val": [make(f"val_{i:04d}", train_size) for i in range(num_val)],
        "id": [make(f"test_{i:04d}", test_size) for i in range(num_test)],
    }
    save_splits([fold], out_dir / "splits" / "default" / "firstCycle" / "splits.pkl")
    manifest_path.write_text(json.dumps(manifest, indent=2) + "\n")
    return out_dir
