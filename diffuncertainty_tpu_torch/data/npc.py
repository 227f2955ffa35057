"""NPC (nasopharyngeal carcinoma MRI, MMIS-2024 task 1) 3D pipeline (port of
``diffuncertainty_tpu/data/npc.py``, the same numpy and scipy; h5py is
imported only by ``process_npc``, which reads the raw H5 volumes).

Rebuilds the reference's NPC dataset scripts:

- ``process_npc``: H5 volumes (keys t1/t1c/t2 + 4 annotator labels) ->
  per-slice 3-channel float npy images + 4 rater masks, center-square
  cropped and zoom-resized, empty slices dropped
  — the reference's ``datasets/npc/process_npc.py:104-433``;
- ``gen_splits_npc``: patient-disjoint train/val/test split over slice files
  with ood_noise/ood_hist/ood_gibbs splits pointing at ``augmented/`` copies
  — ``gen_splits_npc.py:119-344``;
- ``create_npc_augmented_ood``: the three MRI OOD shifts (Rician noise,
  histogram shift, Gibbs ringing), numpy re-implementations of the MONAI
  transforms the reference applies per channel
  — ``create_npc_augmented_ood.py:49-260``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from .ood import ood_gibbs

logger = logging.getLogger(__name__)

# reference MONAI parameters (create_npc_augmented_ood.py:49-62)
RICIAN_NOISE_STD = 0.2
HISTOGRAM_SHIFT_CONTROL_POINTS = 10
GIBBS_ALPHA = 0.75

NPC_LABEL_KEYS = ("label_a1", "label_a2", "label_a3", "label_a4")
NPC_CHANNEL_KEYS = ("t1", "t1c", "t2")


# --------------------------------------------------------------------------
# volume -> slices
# --------------------------------------------------------------------------

def normalize_volume(volume: np.ndarray) -> np.ndarray:
    """Min-max normalize a 3D volume to [0, 1] (process_npc.py:181-189)."""
    v_min, v_max = volume.min(), volume.max()
    if v_max == v_min:
        return np.zeros_like(volume, dtype=np.float32)
    return (volume.astype(np.float32) - v_min) / (v_max - v_min)


def crop_largest_square(array: np.ndarray, crop_size: int) -> np.ndarray:
    """Center square crop of a 2D slice (process_npc.py:109-134)."""
    height, width = array.shape[:2]
    cy, cx = height // 2, width // 2
    half = crop_size // 2
    return array[cy - half : cy - half + crop_size, cx - half : cx - half + crop_size]


def zoom_resize(arr: np.ndarray, size: int, order: str) -> np.ndarray:
    """scipy.ndimage.zoom resize preserving float values (process_npc.py:137-161)."""
    scipy_order = 1 if order == "bilinear" else 0
    zh, zw = size / arr.shape[0], size / arr.shape[1]
    factors = (zh, zw) if arr.ndim == 2 else (zh, zw, 1)
    return ndimage.zoom(arr, factors, order=scipy_order)


def process_npc(
    training_dir: Path,
    validation_dir: Path,
    save_path: Path,
    *,
    image_size: int = 128,
    save_empty: bool = False,
    patient_prefix_len: int = 7,
) -> List[dict]:
    """MMIS-2024 H5 volumes -> per-slice npy tree + metadata.csv.

    Sample ids are ``{split}{patient}_slice{idx:03d}`` where ``patient`` is
    the H5 stem with its first ``patient_prefix_len`` chars stripped
    (reference: ``h5_path.stem[7:]`` for stems like ``patientNN``).
    Images are saved float32 (3 channels, [0,1]); labels uint8 per rater.
    """
    import h5py

    save_path = Path(save_path)
    images_dir = save_path / "images"
    labels_dir = save_path / "labels"
    images_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)

    rows: List[dict] = []
    for split_name, split_dir in [("train", Path(training_dir)), ("val", Path(validation_dir))]:
        if not split_dir.exists():
            logger.info("split dir %s missing, skipping", split_dir)
            continue
        for h5_path in sorted(split_dir.glob("*.h5")):
            with h5py.File(h5_path, "r") as f:
                try:
                    channels = [f[k][:] for k in NPC_CHANNEL_KEYS]
                    labels = [f[k][:] for k in NPC_LABEL_KEYS]
                except KeyError as exc:
                    logger.error("missing key in %s: %s", h5_path, exc)
                    continue
            shape = channels[0].shape
            if any(v.shape != shape for v in channels + labels):
                logger.error("shape mismatch in %s", h5_path)
                continue

            normed = [normalize_volume(v) for v in channels]
            _, height, width = shape
            crop_size = min(height, width)
            patient = h5_path.stem[patient_prefix_len:]

            for slice_idx in range(shape[0]):
                label_slices = [lab[slice_idx] for lab in labels]
                if not save_empty and not any(l.any() for l in label_slices):
                    continue
                sample_id = f"{split_name}{patient}_slice{slice_idx:03d}"
                image_3ch = np.stack(
                    [crop_largest_square(ch[slice_idx], crop_size) for ch in normed],
                    axis=2,
                )
                image_resized = zoom_resize(image_3ch, image_size, "bilinear")
                label_resized = [
                    zoom_resize(crop_largest_square(l.astype(np.uint8), crop_size),
                                image_size, "nearest")
                    for l in label_slices
                ]
                if not save_empty and not any(l.any() for l in label_resized):
                    continue
                image_file = f"{sample_id}.npy"
                label_files = [f"{sample_id}_{i:02d}_mask.npy" for i in range(4)]
                np.save(images_dir / image_file, image_resized.astype(np.float32))
                for lab, lf in zip(label_resized, label_files):
                    np.save(labels_dir / lf, lab.astype(np.uint8))
                rows.append({
                    "sample_id": sample_id,
                    "split": split_name,
                    "source_volume": str(h5_path),
                    "slice_index": slice_idx,
                    "image_file": image_file,
                    "label_files": ",".join(label_files),
                    "crop_size": crop_size,
                })

    if rows:
        meta = save_path / "metadata.csv"
        with meta.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return rows


# --------------------------------------------------------------------------
# patient-disjoint splits
# --------------------------------------------------------------------------

def extract_patient_id(sample_id: str) -> str:
    """``train0_slice000`` -> ``0`` (gen_splits_npc.py:119-142)."""
    prefix = sample_id.split("_")[0]
    for split_name in ("train", "val"):
        if prefix.startswith(split_name):
            return prefix[len(split_name):]
    raise ValueError(f"Cannot parse sample_id: {sample_id}")


def gen_splits_npc(
    dataset_root: Path,
    *,
    train_ratio: float = 0.64,
    val_ratio: float = 0.16,
    test_ratio: float = 0.20,
    seed: int = 123,
) -> Path:
    """Patient-disjoint random split; ood_* splits reference ``augmented/``
    copies of the id images (gen_splits_npc.py:162-344)."""
    dataset_root = Path(dataset_root)
    meta_path = dataset_root / "preprocessed" / "metadata.csv"
    with meta_path.open() as f:
        rows = list(csv.DictReader(f))

    by_patient: Dict[str, List[str]] = {}
    for row in rows:
        pid = extract_patient_id(row["sample_id"])
        by_patient.setdefault(pid, []).append(f"images/{row['image_file']}")

    patient_ids = sorted(by_patient)
    total = train_ratio + val_ratio + test_ratio
    train_ratio, val_ratio = train_ratio / total, val_ratio / total
    rng = np.random.default_rng(seed)
    shuffled = [patient_ids[i] for i in rng.permutation(len(patient_ids))]
    n_train = int(np.round(len(shuffled) * train_ratio))
    n_val = int(np.round(len(shuffled) * val_ratio))

    def collect(pids):
        out: List[str] = []
        for p in pids:
            out.extend(by_patient[p])
        return sorted(out)

    train = collect(shuffled[:n_train])
    val = collect(shuffled[n_train : n_train + n_val])
    test = collect(shuffled[n_train + n_val :])

    id_array = np.array(test, dtype=object)
    splits = [{
        "train": np.array(train, dtype=object),
        "val": np.array(val, dtype=object),
        "id": id_array,
        "ood_noise": np.array([f"augmented/ood_noise/{p}" for p in id_array], dtype=object),
        "ood_hist": np.array([f"augmented/ood_hist/{p}" for p in id_array], dtype=object),
        "ood_gibbs": np.array([f"augmented/ood_gibbs/{p}" for p in id_array], dtype=object),
    }]
    out = dataset_root / "splits" / "ood_aug" / "firstCycle" / "splits.pkl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("wb") as f:
        pickle.dump(splits, f)
    return out


# --------------------------------------------------------------------------
# MRI OOD shifts (numpy ports of the MONAI transforms)
# --------------------------------------------------------------------------

def rician_noise(img: np.ndarray, rng: np.random.Generator, std: float = RICIAN_NOISE_STD) -> np.ndarray:
    """RandRicianNoise(std, sample_std=True): per call sigma ~ U(0, std),
    out = sqrt((img + n1)^2 + n2^2), n1/n2 ~ N(0, sigma^2)."""
    sigma = rng.uniform(0, std)
    n1 = rng.normal(0, sigma, img.shape)
    n2 = rng.normal(0, sigma, img.shape)
    return np.sqrt((img + n1) ** 2 + n2 ** 2).astype(np.float32)


def histogram_shift(
    img: np.ndarray, rng: np.random.Generator,
    num_control_points: int = HISTOGRAM_SHIFT_CONTROL_POINTS,
) -> np.ndarray:
    """RandHistogramShift: monotone random remap of the intensity range via
    ``num_control_points`` jittered control points + linear interpolation."""
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        return img.astype(np.float32)
    ref = np.linspace(lo, hi, num_control_points)
    floating = ref.copy()
    for i in range(1, num_control_points - 1):
        floating[i] = rng.uniform(floating[i - 1], ref[i + 1])
    return np.interp(img, ref, floating).astype(np.float32)


def gibbs_noise(img: np.ndarray, rng: np.random.Generator, alpha: float = GIBBS_ALPHA) -> np.ndarray:
    """RandGibbsNoise(alpha): truncate the outer (alpha) fraction of k-space."""
    return ood_gibbs(img, rng, keep_frac=max(1e-3, 1.0 - alpha))


NPC_OOD_SHIFTS = {
    "ood_noise": rician_noise,
    "ood_hist": histogram_shift,
    "ood_gibbs": gibbs_noise,
}


def create_npc_augmented_ood(
    dataset_root: Path,
    *,
    seed: int = 0,
    shifts: Optional[Sequence[str]] = None,
) -> Dict[str, int]:
    """Write the three shifted copies of every ``id`` image under
    ``preprocessed/augmented/<shift>/`` (create_npc_augmented_ood.py:186-260).
    Transforms are applied per channel, as the reference does."""
    dataset_root = Path(dataset_root)
    splits_path = dataset_root / "splits" / "ood_aug" / "firstCycle" / "splits.pkl"
    with splits_path.open("rb") as f:
        splits = pickle.load(f)
    id_paths = splits[0]["id"]
    image_dir = dataset_root / "preprocessed" / "images"

    shifts = list(shifts or NPC_OOD_SHIFTS)
    aug_dirs = {}
    for s in shifts:
        d = dataset_root / "preprocessed" / "augmented" / s / "images"
        d.mkdir(parents=True, exist_ok=True)
        aug_dirs[s] = d

    rng = np.random.default_rng(seed)
    counts = {s: 0 for s in shifts}
    for rel in id_paths:
        filename = Path(rel).name
        src = image_dir / filename
        if not src.exists():
            logger.warning("missing id image %s", src)
            continue
        img = np.load(src)
        for s in shifts:
            fn = NPC_OOD_SHIFTS[s]
            out = np.stack(
                [fn(img[..., c], rng) for c in range(img.shape[-1])], axis=-1
            ) if img.ndim == 3 else fn(img, rng)
            np.save(aug_dirs[s] / filename, out.astype(np.float32))
            counts[s] += 1
    return counts


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="NPC 3D MRI pipeline")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process")
    p.add_argument("--training-dir", type=Path, required=True)
    p.add_argument("--validation-dir", type=Path, required=True)
    p.add_argument("--save-path", type=Path, required=True)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--save-empty", action="store_true")

    p = sub.add_parser("splits")
    p.add_argument("--dataset-root", type=Path, required=True)
    p.add_argument("--seed", type=int, default=123)

    p = sub.add_parser("ood")
    p.add_argument("--dataset-root", type=Path, required=True)
    p.add_argument("--seed", type=int, default=0)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cmd == "process":
        rows = process_npc(args.training_dir, args.validation_dir, args.save_path,
                           image_size=args.image_size, save_empty=args.save_empty)
        print(f"saved {len(rows)} slices")
    elif args.cmd == "splits":
        out = gen_splits_npc(args.dataset_root, seed=args.seed)
        print(f"splits -> {out}")
    elif args.cmd == "ood":
        counts = create_npc_augmented_ood(args.dataset_root, seed=args.seed)
        print(counts)


if __name__ == "__main__":
    main()
