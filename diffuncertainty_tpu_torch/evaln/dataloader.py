"""Disk API over a results split directory (port of
``diffuncertainty_tpu/evaln/dataloader.py``, the reference's
``ExperimentDataloader``).

Reads the tree the inference job writes (``infer/results.py``, or the JAX
job's, which writes through PIL): image ids discovered from ``pred_seg``,
mean and per-sample predictions from PNGs, uncertainty heatmaps from float
TIFFs, reference (rater) segmentations and GT uncertainty maps from the
dataset's npy files. PNGs and TIFFs are read by ``infer/image_io.py``, not
PIL: a grayscale PNG (colour type 0, PIL's mode ``L``) is a binary mask
stored as 0/255 and comes back as 0/1; a palette PNG (colour type 3, mode
``P``) holds class indices and comes back as they are.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data.dataset import MultiRaterDataset
from ..infer.image_io import read_png, read_tiff

UNC_TYPES_MULTI = ("TU", "AU", "EU")


class ResultsReader:
    def __init__(self, split_dir: str | Path, dataset: MultiRaterDataset | None = None):
        self.split_dir = Path(split_dir)
        self.pred_dir = self.split_dir / "pred_seg"
        self.dataset = dataset
        self._id_index = (
            {iid: i for i, iid in enumerate(dataset.image_ids)} if dataset else {})
        self.image_ids = self._discover_image_ids()
        self.unc_types = [u for u in UNC_TYPES_MULTI if (self.split_dir / u).exists()]
        if not self.unc_types and (self.split_dir / "pred_entropy").exists():
            self.unc_types = ["pred_entropy"]

    def _discover_image_ids(self) -> list[str]:
        ids = set()
        if not self.pred_dir.exists():
            return []
        for p in self.pred_dir.glob("*.png"):
            stem = p.stem
            if stem.endswith("_mean"):
                ids.add(stem[: -len("_mean")])
            else:
                base, _, suffix = stem.rpartition("_")
                if suffix.isdigit():
                    ids.add(base)
        return sorted(ids)

    # ---- predictions -----------------------------------------------------

    @staticmethod
    def _decode_pred_png(path: Path) -> np.ndarray:
        """Grayscale masks are 0/255 (rescaled to 0/1); palette masks are
        class indices (returned as they are)."""
        arr, palette = read_png(path, with_palette=True)
        if palette is None:
            return (arr > 0).astype(np.uint8)
        return arr.astype(np.uint8)

    def get_mean_pred_seg(self, image_id: str) -> np.ndarray:
        path = self.pred_dir / f"{image_id}_mean.png"
        if not path.exists():
            path = self.pred_dir / f"{image_id}_01.png"
        return self._decode_pred_png(path)

    def get_pred_segs(self, image_id: str) -> list[np.ndarray]:
        return [self._decode_pred_png(p)
                for p in sorted(self.pred_dir.glob(f"{image_id}_[0-9]*.png"))]

    # ---- uncertainty maps ------------------------------------------------

    def get_unc_map(self, image_id: str, unc_type: str) -> np.ndarray:
        return read_tiff(self.split_dir / unc_type / f"{image_id}.tif")

    # ---- ground truth ----------------------------------------------------

    def _dataset_idx(self, image_id: str) -> int:
        if image_id not in self._id_index:
            raise KeyError(f"{image_id} not in dataset index")
        return self._id_index[image_id]

    def get_reference_segs(self, image_id: str) -> np.ndarray:
        if self.dataset is None:
            raise ValueError("reference segs require a dataset")
        return np.asarray(self.dataset.load(self._dataset_idx(image_id))["seg"])

    def get_gt_unc_map(self, image_id: str) -> np.ndarray:
        """Per-pixel rater variance (the reference's GT ambiguity map)."""
        segs = self.get_reference_segs(image_id).astype(np.float64)
        return np.var(segs, axis=0)

    # ---- scalar artifacts ------------------------------------------------

    def metrics(self) -> dict:
        return json.loads((self.split_dir / "metrics.json").read_text())

    def aggregated(self, unc_type: str) -> dict:
        return json.loads((self.split_dir / f"aggregated_{unc_type}.json").read_text())
