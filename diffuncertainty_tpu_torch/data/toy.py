"""Synthetic multi-rater shapes dataset (copy of ``diffuncertainty_tpu/data/toy.py``).

2D analog of the reference's toy generator (``datasets/toy_data_generation/``):
blobs (discs / squares) with controlled blur, noise, and *aleatoric ambiguity*
injected as per-rater threshold jitter on a soft boundary — so AU/EU
separation has known ground truth (ValUES R1, ``README.md:19-25``).

Writes the standard on-disk contract (see ``dataset.py``): ``preprocessed/
images/*.npy``, ``preprocessed/labels/{id}_{rater:02d}_mask.npy``, OOD shifts
under ``preprocessed/augmented/<shift>/images``, and ``splits.pkl`` with
train/val/id/ood_* splits — making it a full end-to-end pipeline fixture that
needs no external data.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import scipy.ndimage as ndi

from .dataset import save_splits


def _soft_shape(rng: np.random.Generator, size: int) -> np.ndarray:
    """A random soft-edged blob in [0, 1]: disc or rounded square."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cy, cx = rng.uniform(0.3 * size, 0.7 * size, 2)
    r = rng.uniform(0.12 * size, 0.28 * size)
    kind = rng.integers(2)
    if kind == 0:  # disc
        dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r
    else:  # square (Chebyshev ball)
        dist = np.maximum(np.abs(yy - cy), np.abs(xx - cx)) / r
    edge = rng.uniform(0.08, 0.25) * r
    return 1.0 / (1.0 + np.exp((dist * r - r) / edge))


def generate_toy_dataset(
    out_dir: str | Path,
    *,
    num_train: int = 60,
    num_val: int = 16,
    num_test: int = 24,
    num_ood: int = 24,
    num_raters: int = 4,
    size: int = 64,
    ambiguity: float = 0.15,
    noise_level: float = 0.08,
    seed: int = 0,
    ood_shifts: tuple[str, ...] = ("ood_noise", "ood_blur"),
    num_unlabeled: int = 0,
) -> Path:
    """Generate and write the dataset; returns the base dir.

    Idempotent per parameter set: a ``_manifest.json`` records the generation
    parameters, and a call whose parameters match an existing manifest
    returns immediately without touching the files. A call with DIFFERENT
    parameters against the same directory regenerates everything (the old
    tree's filenames would otherwise survive and mix sizes/seeds — this once
    corrupted a live training run when a 32px smoke reused the 128px
    fixture dir).
    """
    out_dir = Path(out_dir)
    manifest = {
        "num_train": num_train, "num_val": num_val, "num_test": num_test,
        "num_ood": num_ood, "num_raters": num_raters, "size": size,
        "ambiguity": ambiguity, "noise_level": noise_level, "seed": seed,
        "ood_shifts": list(ood_shifts), "num_unlabeled": num_unlabeled,
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
    for shift in ood_shifts:
        (out_dir / "preprocessed" / "augmented" / shift / "images").mkdir(
            parents=True, exist_ok=True
        )

    def make_case(case_id: str) -> str:
        soft = _soft_shape(rng, size)
        image = soft + noise_level * rng.standard_normal((size, size))
        image = np.clip(image * rng.uniform(0.7, 1.0) + rng.uniform(0.0, 0.2), 0, 1)
        np.save(img_dir / f"{case_id}.npy", image.astype(np.float32))
        # rater disagreement: jittered decision thresholds on the soft edge
        for r in range(num_raters):
            thr = 0.5 + ambiguity * (rng.uniform(-1, 1))
            mask = (soft > thr).astype(np.uint8)
            np.save(lbl_dir / f"{case_id}_{r:02d}_mask.npy", mask)
        return f"images/{case_id}.npy"

    train = [make_case(f"train_{i:04d}") for i in range(num_train)]
    val = [make_case(f"val_{i:04d}") for i in range(num_val)]
    id_test = [make_case(f"test_{i:04d}") for i in range(num_test)]
    # active-learning pool: unqueried in-distribution cases (the reference's
    # unlabeled pool moved into train for cycle 2, split_files_second_cycle.py)
    unlabeled = [make_case(f"pool_{i:04d}") for i in range(num_unlabeled)]

    ood_lists: dict[str, list[str]] = {}
    for shift in ood_shifts:
        shift_dir = out_dir / "preprocessed" / "augmented" / shift / "images"
        rel_ids = []
        for i in range(num_ood):
            case_id = f"{shift}_{i:04d}"
            soft = _soft_shape(rng, size)
            image = soft + noise_level * rng.standard_normal((size, size))
            image = np.clip(image, 0, 1)
            if shift == "ood_noise":
                image = image + 0.35 * rng.standard_normal((size, size))
            elif shift == "ood_blur":
                image = ndi.gaussian_filter(image, sigma=2.5)
            np.save(shift_dir / f"{case_id}.npy", image.astype(np.float32))
            for r in range(num_raters):
                thr = 0.5 + ambiguity * rng.uniform(-1, 1)
                np.save(lbl_dir / f"{case_id}_{r:02d}_mask.npy", (soft > thr).astype(np.uint8))
            rel_ids.append(f"augmented/{shift}/images/{case_id}.npy")
        ood_lists[shift] = rel_ids

    fold: dict = {
        "_meta": {
            "schema": "single",
            "dataset_name": "toy64",
            "rater_pattern": "{base_id}_{rater:02d}_mask.npy",
            "num_raters": num_raters,
        },
        "train": train,
        "val": val,
        "id": id_test,
    }
    if unlabeled:
        fold["unlabeled"] = unlabeled
    fold.update(ood_lists)
    # paired splits for OoD detection (id&ood_x convention,
    # experiment_dataloader.py paired-split handling)
    for shift, ids in ood_lists.items():
        fold[f"id&{shift}"] = id_test + ids
    save_splits([fold], out_dir / "splits" / "default" / "firstCycle" / "splits.pkl")
    manifest_path.write_text(json.dumps(manifest, indent=2) + "\n")
    return out_dir
