"""Multi-rater 2D dataset over the on-disk contract (port of the single-schema
path of ``diffuncertainty_tpu/data/dataset.py``).

``{base_dir}/preprocessed/images/*.npy`` float32 or uint8 images (grayscale
replicated to 3 channels, uint8 scaled by 1/255);
``{base_dir}/preprocessed/labels/{base_id}_{rater:02d}_mask.npy`` per-rater
masks (or the fold's ``_meta.rater_pattern``, e.g. the single-rater
``{base_id}_mask.npy`` of ``data/gta_toy.py``); ``splits.pkl`` a list of fold
dicts mapping split names to image paths relative to ``preprocessed/``. The
rater count comes from the caller, the fold's ``_meta.num_raters`` or the
dataset name (``infer_num_raters``).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any

import numpy as np

_RATER_COUNTS = {"lidc": 4, "npc": 4, "chaksu": 5, "riga": 6, "refuge": 7, "toy": 4}


def infer_num_raters(dataset_name: str) -> int | None:
    """``lidc2d_dataset.py:11-28`` name-prefix lookup."""
    name = dataset_name.lower()
    for key, count in _RATER_COUNTS.items():
        if key in name:
            return count
    return None


def load_splits(splits_path: str | Path) -> list[dict]:
    # the splits file is one this package (data/toy.py) or its user wrote
    with open(splits_path, "rb") as f:
        splits = pickle.load(f)
    if not isinstance(splits, (list, tuple)) or not splits:
        raise ValueError("Expected splits.pkl to contain a non-empty list of fold dicts")
    return list(splits)


def save_splits(splits: list[dict], splits_path: str | Path) -> None:
    Path(splits_path).parent.mkdir(parents=True, exist_ok=True)
    with open(splits_path, "wb") as f:
        pickle.dump(splits, f)


class MultiRaterDataset:
    """Index over one split; ``load`` returns the image and all rater masks."""

    def __init__(self, splits_path: str | Path, base_dir: str | Path, split: str = "id",
                 num_raters: int | None = None):
        self.split = split
        self.base_dir = Path(base_dir)
        fold = load_splits(splits_path)[0]
        meta = fold.get("_meta", {})
        if "combined" in str(meta.get("schema") or "").lower():
            raise NotImplementedError("the combined split schema is not ported")
        rater_pattern = meta.get("rater_pattern") or "{base_id}_{rater:02d}_mask.npy"
        if split not in fold:
            available = sorted(k for k in fold if not k.startswith("_"))
            raise ValueError(f"Unknown split '{split}'. Available: {available}")
        label = str(meta.get("dataset_name") or self.base_dir.name)
        self.num_raters = num_raters or meta.get("num_raters") or infer_num_raters(label)
        if self.num_raters is None:
            raise ValueError(f"Cannot infer rater count for dataset '{label}'")
        proc_dir = self.base_dir / "preprocessed"
        self.image_paths: list[Path] = []
        self.label_paths: list[list[Path]] = []
        self.image_ids: list[str] = []
        for rel in list(np.asarray(fold[split]).tolist()):
            base_id = Path(rel).stem
            self.image_paths.append(proc_dir / rel)
            self.label_paths.append([
                proc_dir / "labels" / rater_pattern.format(base_id=base_id, rater=r)
                for r in range(self.num_raters)
            ])
            self.image_ids.append(base_id)

    def __len__(self) -> int:
        return len(self.image_paths)

    def load(self, idx: int) -> dict[str, Any]:
        """image (H, W, 3) float32 and seg (R, H, W) int32."""
        img = np.load(self.image_paths[idx])
        img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        masks = np.stack([np.load(p) for p in self.label_paths[idx]]).astype(np.int32)
        return {"image": img, "seg": masks, "image_id": self.image_ids[idx]}
