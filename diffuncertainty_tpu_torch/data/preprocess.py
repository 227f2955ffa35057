"""Offline dataset preprocessing & split generation (port of
``diffuncertainty_tpu/data/preprocess.py``, the same numpy).

Reference: ``datasets/preprocess_datasets_2d.py:62-148`` (z-score normalize,
pad to patch multiple, save per-image npy + per-rater masks) and the
per-dataset split generators (``datasets/lidc-idri/gen_splits_lidc.py`` etc.:
patient-disjoint train/val/id splits plus unlabeled pools for AL).

Input contract: a directory of raw images (``.npy``; 2D float/uint8) and
rater masks named ``{base_id}_{rater:02d}_mask.npy``; output is the standard
``preprocessed/{images,labels}`` tree + ``splits.pkl``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dataset import save_splits


def zscore_normalize(img: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    img = img.astype(np.float32)
    std = float(img.std())
    return (img - float(img.mean())) / (std + eps)


def pad_to_multiple(arr: np.ndarray, multiple: int, mode: str = "constant") -> np.ndarray:
    """Symmetric pad of the leading two (spatial) axes to a multiple."""
    h, w = arr.shape[:2]
    th = (h + multiple - 1) // multiple * multiple
    tw = (w + multiple - 1) // multiple * multiple
    ph, pw = th - h, tw - w
    pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad, mode=mode)


def preprocess_dataset_2d(
    raw_dir: str | Path,
    out_dir: str | Path,
    *,
    num_raters: int,
    patch_multiple: int = 32,
    normalize: bool = True,
    dataset_name: str | None = None,
) -> list[str]:
    """Normalize + pad every raw image and its rater masks into the
    ``preprocessed/`` tree; returns the relative image ids."""
    raw_dir, out_dir = Path(raw_dir), Path(out_dir)
    img_out = out_dir / "preprocessed" / "images"
    lbl_out = out_dir / "preprocessed" / "labels"
    img_out.mkdir(parents=True, exist_ok=True)
    lbl_out.mkdir(parents=True, exist_ok=True)
    rel_ids = []
    mask_files = {p.name for p in raw_dir.glob("*_mask.npy")}
    for img_path in sorted(raw_dir.glob("*.npy")):
        if img_path.name.endswith("_mask.npy"):
            continue
        base = img_path.stem
        img = np.load(img_path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if normalize:
            img = zscore_normalize(img)
        img = pad_to_multiple(img, patch_multiple)
        np.save(img_out / f"{base}.npy", img.astype(np.float32))
        for r in range(num_raters):
            mname = f"{base}_{r:02d}_mask.npy"
            if mname not in mask_files:
                raise FileNotFoundError(f"missing rater mask {mname}")
            mask = np.load(raw_dir / mname)
            mask = pad_to_multiple(mask.astype(np.int32), patch_multiple)
            np.save(lbl_out / mname, mask.astype(np.uint8))
        rel_ids.append(f"images/{base}.npy")
    return rel_ids


def preprocess_volumes_to_slices(
    raw_dir: str | Path,
    out_dir: str | Path,
    *,
    num_raters: int,
    mode: str = "center",  # center | foreground | all
    patch_multiple: int = 32,
    normalize: bool = True,
    min_foreground: int = 1,
) -> list[str]:
    """3D volumes -> 2D slice dataset (``save_cropped_nodules_2d.py`` /
    ``preprocess_datasets_3d.py`` analog).

    Input: ``{base}.npy`` (D, H, W) volumes + ``{base}_{r:02d}_mask.npy``
    (D, H, W) rater masks. ``center`` keeps the middle slice, ``foreground``
    keeps slices where any rater has >= min_foreground positive pixels,
    ``all`` keeps everything. Slices are z-scored per slice and padded.
    """
    raw_dir, out_dir = Path(raw_dir), Path(out_dir)
    img_out = out_dir / "preprocessed" / "images"
    lbl_out = out_dir / "preprocessed" / "labels"
    img_out.mkdir(parents=True, exist_ok=True)
    lbl_out.mkdir(parents=True, exist_ok=True)
    rel_ids = []
    for vol_path in sorted(raw_dir.glob("*.npy")):
        if vol_path.name.endswith("_mask.npy"):
            continue
        base = vol_path.stem
        vol = np.load(vol_path).astype(np.float32)
        masks = [
            np.load(raw_dir / f"{base}_{r:02d}_mask.npy") for r in range(num_raters)
        ]
        d = vol.shape[0]
        if mode == "center":
            keep = [d // 2]
        elif mode == "foreground":
            keep = [
                z for z in range(d)
                if any(int((m[z] > 0).sum()) >= min_foreground for m in masks)
            ] or [d // 2]
        elif mode == "all":
            keep = list(range(d))
        else:
            raise ValueError(mode)
        for z in keep:
            sid = f"{base}_z{z:03d}" if len(keep) > 1 else base
            img = vol[z]
            if normalize:
                img = zscore_normalize(img)
            np.save(img_out / f"{sid}.npy", pad_to_multiple(img, patch_multiple))
            for r, m in enumerate(masks):
                np.save(
                    lbl_out / f"{sid}_{r:02d}_mask.npy",
                    pad_to_multiple(m[z].astype(np.int32), patch_multiple).astype(np.uint8),
                )
            rel_ids.append(f"images/{sid}.npy")
    return rel_ids


def _patient_of(image_id: str) -> str:
    """Patient grouping key: everything before the last '_' chunk."""
    stem = Path(image_id).stem
    return stem.rsplit("_", 1)[0] if "_" in stem else stem


def generate_splits(
    out_dir: str | Path,
    rel_ids: list[str],
    *,
    split_name: str = "default",
    val_fraction: float = 0.1,
    test_fraction: float = 0.2,
    unlabeled_fraction: float = 0.0,
    patient_disjoint: bool = True,
    num_raters: int | None = None,
    dataset_name: str | None = None,
    seed: int = 0,
    n_folds: int = 1,
) -> Path:
    """Patient-disjoint train/val/id (+ optional unlabeled pool) splits."""
    out_dir = Path(out_dir)
    folds = []
    for fold in range(n_folds):
        rng = np.random.default_rng((seed, fold))
        if patient_disjoint:
            patients = sorted({_patient_of(r) for r in rel_ids})
            rng.shuffle(patients)
            n = len(patients)
            n_test = max(1, int(round(n * test_fraction)))
            n_val = max(1, int(round(n * val_fraction)))
            n_unlab = int(round(n * unlabeled_fraction))
            groups = {
                "id": set(patients[:n_test]),
                "val": set(patients[n_test : n_test + n_val]),
                "unlabeled": set(patients[n_test + n_val : n_test + n_val + n_unlab]),
            }

            def split_of(rid):
                p = _patient_of(rid)
                for name, members in groups.items():
                    if p in members:
                        return name
                return "train"

            fold_dict: dict = {"train": [], "val": [], "id": []}
            if unlabeled_fraction > 0:
                fold_dict["unlabeled"] = []
            for rid in rel_ids:
                fold_dict[split_of(rid)].append(rid)
        else:
            ids = list(rel_ids)
            rng.shuffle(ids)
            n = len(ids)
            n_test = max(1, int(round(n * test_fraction)))
            n_val = max(1, int(round(n * val_fraction)))
            fold_dict = {
                "id": ids[:n_test],
                "val": ids[n_test : n_test + n_val],
                "train": ids[n_test + n_val :],
            }
        fold_dict["_meta"] = {
            "schema": "single",
            "dataset_name": dataset_name,
            "rater_pattern": "{base_id}_{rater:02d}_mask.npy",
            **({"num_raters": num_raters} if num_raters else {}),
        }
        folds.append(fold_dict)
    path = out_dir / "splits" / split_name / "firstCycle" / "splits.pkl"
    save_splits(folds, path)
    return path
