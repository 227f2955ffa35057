"""Original-LIDC importer: aggregated nodule-crop pickle -> on-disk contract
(port of ``diffuncertainty_tpu/data/lidc_import.py``, the same numpy).

The reference ingests the public pre-aggregated LIDC-IDRI pickle (one entry
per 128x128 nodule crop: ``image``, four rater ``masks``, ``series_uid``),
maps series to patients via the LIDC metadata CSV, block-reduces to the
target size (mean for images, max for masks) and writes per-patient npy
folders plus ``metadata.csv`` (``datasets/lidc-idri/process_orig_lidc.py:91-151,
154-231``). Patient-level k-fold CV splits with a held-out test set and
offline OOD-augmented copies of the test images come from
``datasets/lidc-idri/gen_splits_lidc.py:96-173,232-260``.

Rebuilt here against this framework's ``MultiRaterDataset`` on-disk contract
(``data/dataset.py``) — which intentionally shares the reference layout
(``preprocessed/images``, ``labels/{stem}_{rater:02d}_mask.npy``,
``augmented/<shift>/images``) — with the OOD shifts taken from ``data/ood.py``
instead of a separate augmentation script.

Expected input artifact
-----------------------
This importer starts from the *aggregated pickle* (the one the reference's
``process_orig_lidc.py`` consumes): a Python pickle containing a dict (or
list of dicts) with, per nodule crop, keys ``image`` (2D float array,
128x128), ``masks`` (list/stack of 4 binary rater masks), and ``series_uid``
(DICOM series id used for patient mapping), plus a metadata CSV with
``Series UID`` -> ``Patient ID`` columns. That pickle is produced upstream by
the DICOM->crop stage — rebuilt in ``data/lidc_raw.py`` (clustering, crop,
resample, slice extraction, with ``crops_to_aggregated_pickle`` emitting
exactly this pickle) — whose pylidc/DICOM *reader* still needs the ~120 GB
LIDC-IDRI archive and the pylidc package (imported only by that reader).
Run ``python -m diffuncertainty_tpu_torch.data.lidc_raw`` against the
archive (or fetch the aggregated pickle) and point ``--pickle-path`` and
``--metadata-csv`` here.
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
import random
import zlib
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .dataset import save_splits
from .ood import SHIFTS

BASE_IMAGE_SIZE = 128
RATER_COUNT = 4
DEFAULT_OOD_SPLITS = ("ood_noise", "ood_blur", "ood_contrast", "ood_jpeg")


def block_reduce_2d(arr: np.ndarray, target_size: int, reduce: str) -> np.ndarray:
    """Downsample a square 2D array by integer block reduction (mean/max)."""
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"expected square 2D array, got {arr.shape}")
    src = arr.shape[0]
    if src == target_size:
        return np.array(arr, copy=True)
    if src % target_size != 0:
        raise ValueError(f"cannot block-reduce {src} -> {target_size}")
    f = src // target_size
    blocks = np.ascontiguousarray(arr).reshape(target_size, f, target_size, f)
    if reduce == "mean":
        return blocks.mean(axis=(1, 3))
    if reduce == "max":
        return blocks.max(axis=(1, 3))
    raise ValueError(f"unknown reduce: {reduce}")


def load_series_to_subject(metadata_csv: str | Path) -> Dict[str, str]:
    """LIDC-IDRI_MetaData.csv -> {series_uid: subject_id} (first occurrence wins)."""
    mapping: Dict[str, str] = {}
    with open(metadata_csv, newline="") as fh:
        for row in csv.DictReader(fh):
            subject = (row.get("Subject ID") or "").strip()
            series = (row.get("Series ID") or "").strip()
            if subject and series:
                mapping.setdefault(series, subject)
    if not mapping:
        raise ValueError(f"no (Subject ID, Series ID) rows in {metadata_csv}")
    return mapping


def patient_code(subject_id: str) -> str:
    """'LIDC-IDRI-0042' -> '0042' (digits of the last dash segment, zfilled)."""
    tail = subject_id.strip().split("-")[-1]
    digits = "".join(c for c in tail if c.isdigit()) or "".join(
        c for c in subject_id if c.isdigit()
    )
    if not digits:
        raise ValueError(f"no numeric code in subject_id={subject_id!r}")
    return digits.zfill(4)


def convert_lidc_pickle(
    pickle_path: str | Path,
    metadata_csv: str | Path,
    out_root: str | Path,
    *,
    image_size: int = 128,
    dataset_name: str | None = None,
    overwrite: bool = False,
) -> Tuple[Path, Dict[str, List[str]]]:
    """Write the aggregated pickle as a MultiRaterDataset directory.

    Returns (dataset_root, {subject_id: [image_name, ...]}).
    """
    if BASE_IMAGE_SIZE % image_size != 0:
        raise ValueError(f"image_size={image_size} must divide {BASE_IMAGE_SIZE}")
    dataset_name = dataset_name or f"origlidc{image_size}"
    root = Path(out_root) / dataset_name
    images_dir = root / "preprocessed" / "images"
    labels_dir = root / "preprocessed" / "labels"
    images_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)

    series_to_subject = load_series_to_subject(metadata_csv)
    with open(pickle_path, "rb") as fh:
        payload = pickle.load(fh)

    patient_images: Dict[str, List[str]] = defaultdict(list)
    per_code_counter: Dict[str, int] = defaultdict(int)
    rows: List[Tuple[str, str]] = []
    for key in payload:
        sample = payload[key]
        series_uid = str(sample.get("series_uid", "")).strip()
        if not series_uid:
            raise KeyError(f"sample {key!r} missing series_uid")
        subject = series_to_subject.get(series_uid)
        if subject is None:
            raise KeyError(f"series {series_uid} not in metadata CSV")
        code = patient_code(subject)

        image = np.asarray(sample["image"])
        if image.shape != (BASE_IMAGE_SIZE, BASE_IMAGE_SIZE):
            raise ValueError(f"sample {key!r}: image shape {image.shape}")
        masks = sample["masks"]
        if len(masks) != RATER_COUNT:
            raise ValueError(f"sample {key!r}: expected {RATER_COUNT} masks")

        idx = per_code_counter[code]
        per_code_counter[code] += 1
        stem = f"{code}_{idx:03d}"
        img_path = images_dir / f"{stem}.npy"
        if not img_path.exists() or overwrite:
            np.save(img_path, block_reduce_2d(image, image_size, "mean").astype(np.float32))
            for r, m in enumerate(masks):
                np.save(
                    labels_dir / f"{stem}_{r:02d}_mask.npy",
                    block_reduce_2d(np.asarray(m, np.uint8), image_size, "max").astype(np.uint8),
                )
        patient_images[subject].append(f"{stem}.npy")
        rows.append((f"{stem}.npy", subject))

    with open(root / "metadata.csv", "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["image_name", "patient_id"])
        writer.writerows(rows)
    (root / "meta.json").write_text(
        json.dumps({"num_raters": RATER_COUNT, "num_classes": 2}) + "\n"
    )
    return root, dict(patient_images)


def build_cv_splits(
    patient_images: Dict[str, List[str]],
    *,
    num_splits: int = 4,
    test_ratio: float = 0.2,
    seed: int = 7,
    ood_splits: Sequence[str] = DEFAULT_OOD_SPLITS,
    meta: dict | None = None,
) -> List[dict]:
    """Patient-disjoint k-fold CV with one shared held-out test set.

    Each fold dict has ``train``/``val``/``id`` lists of ``images/<name>``
    paths (sorted within each patient group) plus one entry per OOD split
    pointing at ``augmented/<split>/images/<name>`` copies of the test set.
    """
    if not (0.0 < test_ratio < 1.0):
        raise ValueError("test_ratio must be in (0, 1)")
    if num_splits < 2:
        raise ValueError("num_splits must be >= 2")
    patients = sorted(patient_images)
    if len(patients) < num_splits + 1:
        raise ValueError("not enough patients for the requested folds + test set")

    shuffled = list(patients)
    random.Random(seed).shuffle(shuffled)
    n_test = min(max(1, int(round(len(shuffled) * test_ratio))), len(shuffled) - 1)
    test_patients = sorted(shuffled[:n_test])
    pool = sorted(p for p in patients if p not in set(test_patients))

    def collect(group: Sequence[str]) -> List[str]:
        names: List[str] = []
        for p in group:
            names.extend(patient_images[p])
        return sorted(f"images/{n}" for n in names)

    test_images = collect(test_patients)
    rng = np.random.default_rng(seed)
    order = np.arange(len(pool))
    rng.shuffle(order)
    chunks = np.array_split(order, num_splits)
    pool_arr = np.array(pool, dtype=object)

    folds: List[dict] = []
    for k in range(num_splits):
        val_p = pool_arr[chunks[k]].tolist()
        train_p = pool_arr[np.concatenate([chunks[i] for i in range(num_splits) if i != k])].tolist()
        fold = {
            "train": collect(train_p),
            "val": collect(val_p),
            "id": list(test_images),
        }
        for s in ood_splits:
            fold[s] = [p.replace("images/", f"augmented/{s}/images/") for p in test_images]
        if meta:
            fold["_meta"] = dict(meta)
        folds.append(fold)
    return folds


def generate_ood_test_files(
    dataset_root: str | Path,
    test_images: Sequence[str],
    *,
    shifts: Sequence[str] = DEFAULT_OOD_SPLITS,
    seed: int = 7,
    overwrite: bool = False,
) -> None:
    """Write OOD-shifted copies of the test images under augmented/<shift>/images."""
    proc = Path(dataset_root) / "preprocessed"
    for shift in shifts:
        fn = SHIFTS[shift]
        out_dir = proc / "augmented" / shift / "images"
        out_dir.mkdir(parents=True, exist_ok=True)
        for rel in test_images:
            name = Path(rel).name
            target = out_dir / name
            if target.exists() and not overwrite:
                continue
            img = np.load(proc / "images" / name)
            # stable per-(shift, image) stream: string hashes are salted per
            # process, so derive the offset from a crc instead
            offset = zlib.crc32(f"{shift}/{name}".encode()) & 0x7FFFFFFF
            rng = np.random.default_rng(np.int64(seed) + offset)
            np.save(target, fn(img.astype(np.float32), rng).astype(np.float32))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pickle-path", required=True)
    ap.add_argument("--metadata-csv", required=True)
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--dataset-name", default=None)
    ap.add_argument("--num-splits", type=int, default=4)
    ap.add_argument("--test-ratio", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--split-name", default="ood_aug")
    ap.add_argument("--cycle-name", default="firstCycle")
    ap.add_argument("--skip-ood-files", action="store_true")
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)

    root, patient_images = convert_lidc_pickle(
        args.pickle_path, args.metadata_csv, args.out_root,
        image_size=args.image_size, dataset_name=args.dataset_name,
        overwrite=args.overwrite,
    )
    folds = build_cv_splits(
        patient_images, num_splits=args.num_splits,
        test_ratio=args.test_ratio, seed=args.seed,
        meta={"num_raters": RATER_COUNT, "num_classes": 2,
              "dataset_name": root.name},
    )
    split_path = root / "splits" / args.split_name / args.cycle_name / "splits.pkl"
    split_path.parent.mkdir(parents=True, exist_ok=True)
    save_splits(folds, split_path)
    print(f"wrote {len(folds)} folds to {split_path}")
    if not args.skip_ood_files:
        generate_ood_test_files(root, folds[0]["id"], seed=args.seed,
                                overwrite=args.overwrite)
        print("wrote OOD-augmented test copies")


if __name__ == "__main__":
    main()
