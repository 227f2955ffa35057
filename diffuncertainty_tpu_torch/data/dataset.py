"""Multi-rater 2D dataset over the on-disk contract (port of
``diffuncertainty_tpu/data/dataset.py``).

``{base_dir}/preprocessed/images/*.npy`` float32 or uint8 images (grayscale
replicated to 3 channels, uint8 scaled by 1/255);
``{base_dir}/preprocessed/labels/{base_id}_{rater:02d}_mask.npy`` per-rater
masks (or the fold's ``_meta.rater_pattern``, e.g. the single-rater
``{base_id}_mask.npy`` of ``data/gta_toy.py``); ``splits.pkl`` a list of fold
dicts mapping split names to image paths relative to ``preprocessed/``. The
rater count comes from the caller, the fold's ``_meta.num_raters`` or the
dataset name (``infer_num_raters``). ``load`` returns every rater's mask,
one drawn at random, or with ``single_rater`` the one a stable hash of the
image picks (the reference's ``_stable_rater_index``).

A fold whose ``_meta.schema`` names "combined" (the reference's
``lidc2d_dataset.py:197-235``) mixes datasets: its subject ids are
``<dataset>/<path under that dataset's preprocessed/>``, resolved under the
parent of ``base_dir``, and each sample takes its dataset's rater count from
``_meta.dataset_configs[<dataset>]["num_raters"]``, so samples of one split
may carry different counts (the loader pads them, the batch metrics mask the
padding); ``num_raters`` is the largest, ``load`` labels each sample with its
own dataset.
"""

from __future__ import annotations

import hashlib
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
    """Index over one split of fold ``data_fold_id``; ``load`` returns the
    image, the rater masks and the image's dataset label."""

    def __init__(self, splits_path: str | Path, base_dir: str | Path, split: str = "id",
                 num_raters: int | None = None, *, data_fold_id: int = 0,
                 return_all_raters: bool = True, single_rater: bool = False,
                 rater_pattern: str | None = None, dataset_label: str | None = None):
        """``rater_pattern`` and ``dataset_label`` override the fold's
        ``_meta`` (the JAX dataset's arguments of those names)."""
        self.split = split
        self.single_rater = bool(single_rater)
        self.base_dir = Path(base_dir)
        self.return_all_raters = return_all_raters
        folds = load_splits(splits_path)
        if data_fold_id >= len(folds):
            raise ValueError(f"fold {data_fold_id} not in splits ({len(folds)} folds)")
        fold = folds[data_fold_id]
        meta = fold.get("_meta", {})
        rater_pattern = (rater_pattern or meta.get("rater_pattern")
                         or "{base_id}_{rater:02d}_mask.npy")
        if split not in fold:
            available = sorted(k for k in fold if not k.startswith("_"))
            raise ValueError(f"Unknown split '{split}'. Available: {available}")
        self.image_paths: list[Path] = []
        self.label_paths: list[list[Path]] = []
        self.image_ids: list[str] = []
        self.sample_datasets: list[str] = []
        subject_ids = list(np.asarray(fold[split]).tolist())
        if "combined" in str(meta.get("schema") or "").lower():
            self.dataset_label = str(dataset_label or meta.get("dataset_name") or "combined")
            configs = meta.get("dataset_configs", {})
            if not configs:
                raise ValueError("combined split needs _meta.dataset_configs")
            counts = []
            for rel in subject_ids:
                ds_name, sub_rel = str(rel).split("/", 1)
                n_r = int(configs[ds_name].get("num_raters"))
                proc = self.base_dir.parent / ds_name / "preprocessed"
                self._add(proc, sub_rel, rater_pattern, n_r, ds_name)
                counts.append(n_r)
            self.num_raters = max(counts) if counts else (num_raters or 0)
            return
        self.dataset_label = str(dataset_label or meta.get("dataset_name")
                                 or self.base_dir.name)
        self.num_raters = (num_raters or meta.get("num_raters")
                           or infer_num_raters(self.dataset_label))
        if self.num_raters is None:
            raise ValueError(f"Cannot infer rater count for dataset '{self.dataset_label}'")
        for rel in subject_ids:
            self._add(self.base_dir / "preprocessed", rel, rater_pattern, self.num_raters,
                      self.dataset_label)

    def _add(self, proc_dir: Path, rel: str, rater_pattern: str, n_raters: int,
             dataset: str) -> None:
        base_id = Path(rel).stem
        self.image_paths.append(proc_dir / rel)
        self.label_paths.append([proc_dir / "labels" / rater_pattern.format(base_id=base_id,
                                                                             rater=r)
                                 for r in range(n_raters)])
        self.image_ids.append(base_id)
        self.sample_datasets.append(dataset)

    def __len__(self) -> int:
        return len(self.image_paths)

    def stable_rater_index(self, image_id: str, num_raters: int | None = None) -> int:
        seed_key = f"13:{self.dataset_label}:{self.split}:{image_id}"
        value = int.from_bytes(hashlib.sha256(seed_key.encode("utf-8")).digest()[:4], "big")
        return value % (num_raters or self.num_raters)

    def subset(self, keep: set[int]) -> None:
        """Keep only the samples at the positions in ``keep``, in order."""
        for name in ("image_paths", "label_paths", "image_ids", "sample_datasets"):
            setattr(self, name, [v for i, v in enumerate(getattr(self, name)) if i in keep])

    def load(self, idx: int, rng: np.random.Generator | None = None) -> dict[str, Any]:
        """image (H, W, 3) float32, seg (R, H, W) int32 (or one rater's
        (H, W) unless ``return_all_raters``), image_id and dataset."""
        img = np.load(self.image_paths[idx])
        img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        paths = self.label_paths[idx]
        if self.return_all_raters:
            masks = np.stack([np.load(p) for p in paths]).astype(np.int32)
        elif self.single_rater:
            masks = np.load(paths[self.stable_rater_index(self.image_ids[idx], len(paths))]
                            ).astype(np.int32)
        else:
            pick = int((rng or np.random.default_rng()).integers(len(paths)))
            masks = np.load(paths[pick]).astype(np.int32)
        return {"image": img, "seg": masks, "image_id": self.image_ids[idx],
                "dataset": self.sample_datasets[idx]}
