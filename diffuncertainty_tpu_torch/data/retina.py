"""Retina-family raw-data cleaning and preprocessing (port of
``diffuncertainty_tpu/data/retina.py``, function for function): Chaksu,
RIGA and REFUGE raw trees to the ``MultiRaterDataset`` npy trees, and their
splits.

- Chaksu fundus images with 5 expert Disc/Cup binary annotations, grouped by
  scanner machine (Bosch/Forus/Remidio) (the reference's
  ``datasets/chaksu/process_chaksu.py``);
- RIGA prime images with 6 pencil-annotated variants whose contours are
  recovered by image differencing + concentric-ring labeling
  (``datasets/riga/clean_riga.py`` and ``process_riga.py``);
- REFUGE-Multirater case folders with 7 disc/cup annotation pairs
  (``datasets/refuge/process_refuge.py``);
- scanner-balanced Chaksu CV splits and the combined-retina random splits
  (``gen_splits_chaksu.py``, ``datasets/retina/gen_splits_retina.py``).

Shared semantics (those of the JAX module):
- every mask keeps only its largest connected component;
- disc := disc | cup, cup := cup & disc (cup never exceeds disc);
- multi-class label: 0 background, 1 disc-only, 2 cup;
- crops are squares centered on the (bbox-center of the) disc union, sized by
  a per-scanner/per-clinic mean disc diameter times a multiplier, zero-padded
  at image borders;
- images resize bilinearly, labels nearest, as Pillow does.

Without PIL: files open through ``infer/image_io.py::read_image`` (PNG, TIFF
and baseline JPEG, each decoded as Pillow decodes it) and its
``convert_rgb`` / ``convert_l`` (Pillow's ``convert("RGB")`` and
``convert("L")``); the resizes are ``data/resize.py``'s Pillow ``BILINEAR``
and ``NEAREST``; the cleaned RIGA PNGs are written by
``infer/image_io.py::write_png`` (the prime as ``L`` or ``RGB``, the labels
as ``P`` with the JAX module's palette); the Chaksu folds are
``data/toy3d.py::kfold_indices`` (scikit-learn's ``KFold``). A file in a form
the decoders do not read raises with its path.

The trees written equal the JAX module's file for file
(``tests/test_torch_port_retina.py``). The raw-layout assumptions of the JAX
module hold here too: ``<root>/<Machine>/**/<image>`` with per-expert
annotations at ``.../Expert_{1..5}/(Disc|Cup)/<stem>.png`` for Chaksu;
``<clinic>/.../{case}prime<ext>`` with variants ``{case}-{1..6}<ext>`` beside
it for RIGA; one folder per case for REFUGE (``REFUGE_IMAGE_NAME``,
``*_seg_disc_{idx}.png``, ``*_seg_cup_{idx}.png``, idx 1..7).
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi

from ..infer.image_io import convert_l, convert_rgb, read_image, read_png, write_png
from .resize import resize_bilinear, resize_nearest
from .toy3d import kfold_indices

logger = logging.getLogger(__name__)

# Chaksu per-scanner constants (process_chaksu.py:38-41)
CIRCLE_WIDTHS: Dict[str, int] = {"Bosch": 1440, "Forus": 1900, "Remidio": 2200}
MEAN_DISC_DIAM: Dict[str, float] = {"Bosch": 225.29, "Forus": 325.02, "Remidio": 448.05}
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".tif", ".tiff"}
RIGA_CLINICS = ("BinRushed", "MESSIDOR", "Magrabi")

# REFUGE case-folder file templates (process_refuge.py:43-47)
REFUGE_IMAGE_NAME = "{stem}.jpg"
REFUGE_DISC_ANNOTATION = "{stem}_seg_disc_{idx}.png"
REFUGE_CUP_ANNOTATION = "{stem}_seg_cup_{idx}.png"


# --------------------------------------------------------------------------
# shared geometry helpers
# --------------------------------------------------------------------------

def keep_largest_component(mask: np.ndarray) -> np.ndarray:
    """True only on the biggest 4-connected blob of ``mask``.

    Semantic contract shared with the reference cleaners (every rater mask is
    reduced to its dominant blob before any geometry is derived); selection
    here goes through ``np.unique`` label counts on the labeled foreground.
    """
    blobs, n_blobs = ndi.label(np.asarray(mask, dtype=bool))
    if n_blobs < 2:
        return blobs > 0
    label_ids, label_sizes = np.unique(blobs[blobs > 0], return_counts=True)
    return blobs == label_ids[label_sizes.argmax()]


def build_label(disc_mask: np.ndarray, cup_mask: np.ndarray) -> np.ndarray:
    """Class map 0/1/2 = background / disc-only / cup, built arithmetically:
    one count for being inside the disc∪cup, a second for being in the cup."""
    disc_or_cup = np.asarray(disc_mask, bool) | np.asarray(cup_mask, bool)
    in_cup = np.asarray(cup_mask, bool) & disc_or_cup
    return disc_or_cup.astype(np.uint8) + in_cup.astype(np.uint8)


def _mask_extent(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Row/column index ranges of the mask via axis projections."""
    rows = np.flatnonzero(np.asarray(mask, bool).any(axis=1))
    cols = np.flatnonzero(np.asarray(mask, bool).any(axis=0))
    return rows, cols


def get_bbox_center(mask: np.ndarray) -> Tuple[float, float]:
    """(row, col) midpoint of the mask's bounding box."""
    rows, cols = _mask_extent(mask)
    if rows.size == 0:
        raise ValueError("Cannot compute center from empty mask")
    return ((rows[0] + rows[-1]) / 2.0, (cols[0] + cols[-1]) / 2.0)


def get_bbox_diameter(mask: np.ndarray) -> float:
    """Mean of bounding-box height and width — the per-rater disc size that
    drives crop normalization (reference crop-size semantics)."""
    rows, cols = _mask_extent(mask)
    if rows.size == 0:
        return 1.0
    height = rows[-1] - rows[0] + 1
    width = cols[-1] - cols[0] + 1
    return (height + width) / 2.0


def crop_square(array: np.ndarray, center: Tuple[float, float], size: int) -> np.ndarray:
    """``size``x``size`` window centered at ``center`` (row, col).

    Implemented by pasting the in-bounds intersection onto a zero canvas, so
    out-of-frame regions read as 0 without ever padding the source array.
    """
    if size <= 0:
        raise ValueError("Crop size must be positive")
    row0 = int(round(center[0] - size / 2.0))
    col0 = int(round(center[1] - size / 2.0))
    canvas = np.zeros((size, size) + array.shape[2:], dtype=array.dtype)
    src_rows = slice(min(max(row0, 0), array.shape[0]), max(min(row0 + size, array.shape[0]), 0))
    src_cols = slice(min(max(col0, 0), array.shape[1]), max(min(col0 + size, array.shape[1]), 0))
    canvas[src_rows.start - row0:src_rows.stop - row0,
           src_cols.start - col0:src_cols.stop - col0] = array[src_rows, src_cols]
    return canvas


def resize_array(arr: np.ndarray, size: int, order: str) -> np.ndarray:
    """Pillow's resize to ``size``x``size`` of the uint8 array: bilinear for
    images, nearest for labels; C order, as PIL's arrays are (``np.save``
    records the order)."""
    resize = {"bilinear": resize_bilinear, "nearest": resize_nearest}[order]
    return np.ascontiguousarray(resize(np.asarray(arr, np.uint8), (size, size)))


def _load_image_rgb(path: Path) -> np.ndarray:
    return convert_rgb(read_image(path))


def _load_binary_mask(path: Path) -> np.ndarray:
    return (convert_l(read_image(path)) > 0).astype(np.uint8)


def _ensure_output_dirs(root: Path) -> Tuple[Path, Path]:
    images_dir = root / "images"
    labels_dir = root / "labels"
    images_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)
    return images_dir, labels_dir


def _crop_resize_save(
    image: np.ndarray,
    labels: Sequence[np.ndarray],
    center: Tuple[float, float],
    crop_size: int,
    image_size: int,
    image_target: Path,
    label_targets: Sequence[Path],
) -> None:
    resized = resize_array(crop_square(image, center, crop_size), image_size, "bilinear")
    np.save(image_target, resized.astype(np.uint8))
    for label, target in zip(labels, label_targets):
        rl = resize_array(
            crop_square(label.astype(np.uint8), center, crop_size), image_size, "nearest"
        )
        np.save(target, rl.astype(np.uint8))


# --------------------------------------------------------------------------
# Chaksu (5 raters, 3 scanner machines)
# --------------------------------------------------------------------------

def _chaksu_experts(label_dir: Path) -> List[str]:
    experts = [p.name for p in sorted(label_dir.iterdir()) if p.is_dir()]
    return [e for e in experts if e.lower().startswith("expert")]


def _chaksu_machine_images(image_root: Path, machine: str) -> List[Path]:
    machine_dir = image_root / machine
    if not machine_dir.is_dir():
        return []
    return sorted(
        p for p in machine_dir.rglob("*")
        if p.is_file() and p.suffix.lower() in IMAGE_EXTENSIONS
    )


def _find_mask_file(root: Path, stem: str) -> Path:
    exact = root / f"{stem}.png"
    if exact.exists():
        return exact
    matches = sorted(root.glob(f"{stem}.*"))
    if matches:
        return matches[0]
    raise FileNotFoundError(f"Missing mask for {stem} in {root}")


def process_chaksu(
    train_image_dir: Path,
    test_image_dir: Path,
    train_label_dir: Path,
    test_label_dir: Path,
    save_path: Path,
    *,
    image_size: int = 128,
    rel_sidelength: float = 0.30,
    disc_crop_dia: float = 2.0,
    skip_existing: bool = False,
) -> List[dict]:
    """Chaksu raw tree -> preprocessed npy tree + metadata.csv.

    Raw layout per split: ``<image_dir>/<Machine>/**.png`` and
    ``<label_dir>/Expert{k}/<Machine>/{Cup,Disc}/{stem}.png``. Crop size is
    ``disc_crop_dia * MEAN_DISC_DIAM[machine]`` (or ``rel_sidelength *
    CIRCLE_WIDTHS[machine]`` when disc_crop_dia <= 0).
    Matches ``process_chaksu.py:283-356`` sample processing.
    """
    save_path = Path(save_path)
    images_dir, labels_dir = _ensure_output_dirs(save_path)
    rows: List[dict] = []
    sample_index = 0

    for split_name, image_root, label_root in [
        ("train", Path(train_image_dir), Path(train_label_dir)),
        ("test", Path(test_image_dir), Path(test_label_dir)),
    ]:
        if not image_root.exists():
            logger.info("split %s: image dir %s missing, skipping", split_name, image_root)
            continue
        experts = _chaksu_experts(label_root)
        if not experts:
            logger.warning("no expert folders in %s", label_root)
            continue
        prefix = split_name[0]
        for machine in CIRCLE_WIDTHS:
            for image_path in _chaksu_machine_images(image_root, machine):
                sample_id = f"{prefix}_{sample_index:06d}"
                image_file = f"{sample_id}.npy"
                label_files = [f"{sample_id}_{i:02d}_mask.npy" for i in range(len(experts))]
                targets = [images_dir / image_file] + [labels_dir / f for f in label_files]
                if skip_existing and all(t.exists() for t in targets):
                    sample_index += 1
                    continue

                stem = image_path.stem
                disc_masks, label_arrays = [], []
                ok = True
                for expert in experts:
                    cup_root = label_root / expert / machine / "Cup"
                    disc_root = label_root / expert / machine / "Disc"
                    try:
                        cup = keep_largest_component(
                            _load_binary_mask(_find_mask_file(cup_root, stem)))
                        disc = keep_largest_component(
                            _load_binary_mask(_find_mask_file(disc_root, stem)))
                    except FileNotFoundError as exc:
                        logger.warning("%s", exc)
                        ok = False
                        break
                    disc = np.logical_or(disc, cup)
                    cup = np.logical_and(cup, disc)
                    disc_masks.append(disc)
                    label_arrays.append(build_label(disc, cup))
                if not ok:
                    continue

                union_disc = np.any(np.stack(disc_masks), axis=0)
                if not union_disc.any():
                    logger.warning("empty disc union for %s", image_path)
                    continue
                center = get_bbox_center(union_disc)
                if disc_crop_dia > 0.0:
                    crop_size = int(round(MEAN_DISC_DIAM[machine] * disc_crop_dia))
                else:
                    crop_size = int(round(rel_sidelength * CIRCLE_WIDTHS[machine]))

                image = _load_image_rgb(image_path)
                _crop_resize_save(
                    image, label_arrays, center, crop_size, image_size,
                    images_dir / image_file, [labels_dir / f for f in label_files],
                )
                rows.append({
                    "sample_id": sample_id,
                    "machine": machine,
                    "split": split_name,
                    "source_image": str(image_path),
                    "image_file": image_file,
                    "label_files": ",".join(label_files),
                    "crop_size": crop_size,
                })
                sample_index += 1

    if rows:
        meta_path = save_path / "metadata.csv"
        with meta_path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return rows


def gen_splits_chaksu(
    dataset_root: Path,
    *,
    num_splits: int = 5,
    seed: int = 123,
    overwrite: bool = True,
) -> Path:
    """Scanner-balanced CV splits (gen_splits_chaksu.py:129-244).

    Remidio train samples -> ``num_splits`` KFold train/val folds; every fold
    shares ``id`` = Remidio test and ``ood`` = all Bosch+Forus samples.
    """
    dataset_root = Path(dataset_root)
    meta_path = dataset_root / "preprocessed" / "metadata.csv"
    with meta_path.open() as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError("metadata.csv empty")

    def rel(row):
        return f"images/{row['image_file']}"

    remidio_train = [rel(r) for r in rows if r["split"] == "train" and r["machine"] == "Remidio"]
    remidio_test = [rel(r) for r in rows if r["split"] == "test" and r["machine"] == "Remidio"]
    ood = [rel(r) for r in rows if r["machine"] in ("Bosch", "Forus")]
    if len(remidio_train) < num_splits:
        raise ValueError("num_splits cannot exceed the number of Remidio train samples")

    arr = np.array(remidio_train)
    folds: List[dict] = []
    for train_idx, val_idx in kfold_indices(len(arr), num_splits, seed):
        folds.append({
            "train": arr[train_idx],
            "val": arr[val_idx],
            "id": np.array(remidio_test, dtype=object),
            "ood": np.array(ood, dtype=object),
        })

    out = dataset_root / "splits" / "scanner" / "firstCycle" / "splits.pkl"
    if out.exists() and not overwrite:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("wb") as f:
        pickle.dump(folds, f)
    return out


# --------------------------------------------------------------------------
# RIGA cleaning (pencil annotations -> ring labels) and processing
# --------------------------------------------------------------------------

def label_concentric_rings(
    rings: np.ndarray,
    noise_tol: float = 0.05,
    inner_hole_tol: float = 0.05,
    std: float = 1.0,
) -> np.ndarray:
    """Classify a plane cut by two concentric annotation rings into
    0 outside / 1 donut / 2 center.

    Semantic contract (shared with the reference's RIGA cleaning stage): the
    non-ring pixels fall into three dominant connected regions; pencil noise
    beyond those and holes inside the innermost region are rejected by the
    two tolerances; with ``std > 0`` the leftover ring/noise pixels are
    absorbed into whichever of the three regions is closest (argmax of a
    Gaussian-blurred one-hot), otherwise they stay -1.

    The region roles here are resolved *topologically* instead of by sorting
    hole areas: filling the ring complex itself marks everything the outer
    ring encloses, which splits off the outside region; between the two
    enclosed regions, the donut is the one whose filled silhouette swallows
    the other.
    """
    rings = np.asarray(rings, dtype=bool)
    regions, n_regions = ndi.label(~rings)
    if n_regions < 3:
        raise ValueError(f"Expected at least 3 non-ring CCs, found {n_regions}")

    region_ids, region_sizes = np.unique(regions[regions > 0], return_counts=True)
    descending = np.argsort(region_sizes)[::-1]
    kept = region_ids[descending[:3]]
    kept_sizes = region_sizes[descending[:3]]
    clutter = int(region_sizes.sum() - kept_sizes.sum())
    if clutter > noise_tol * kept_sizes[2]:
        raise ValueError(
            f"Pencil-noise components too large: {clutter} px vs "
            f"{noise_tol} * {kept_sizes[2]} allowed"
        )

    # Everything the outer ring encloses (donut + inner ring + center):
    enclosed = ndi.binary_fill_holes(rings)
    interior = [rid for rid in kept if enclosed[regions == rid].mean() > 0.5]
    if len(interior) != 2:
        raise ValueError(
            f"Ring topology not concentric: {len(interior)} of the 3 main "
            "regions are enclosed by the outer ring (expected 2)"
        )
    (outside_id,) = [rid for rid in kept if rid not in interior]
    first, second = interior
    if ndi.binary_fill_holes(regions == first)[regions == second].any():
        donut_id, center_id = first, second
    else:
        donut_id, center_id = second, first

    center_mask = regions == center_id
    center_area = int(np.count_nonzero(center_mask))
    center_hole = int(np.count_nonzero(ndi.binary_fill_holes(center_mask))) - center_area
    if center_hole > inner_hole_tol * center_area:
        raise ValueError(
            f"Innermost region is not simply connected: hole of {center_hole} px "
            f"vs {inner_hole_tol} * {center_area} allowed"
        )

    role_ids = np.array([outside_id, donut_id, center_id])
    if std > 0:
        # one-hot over the three roles, blurred per-channel in a single
        # vectorized call; argmax assigns ring/noise pixels to the nearest role
        onehot = (regions[None, :, :] == role_ids[:, None, None]).astype(np.float32)
        blurred = ndi.gaussian_filter(onehot, sigma=(0.0, std, std))
        return blurred.argmax(axis=0).astype(np.int8)

    out = np.full(rings.shape, -1, dtype=np.int8)
    for role, rid in enumerate(role_ids):
        out[regions == rid] = role
    return out


def extract_riga_gt_label(prime_img: np.ndarray, gt_img: np.ndarray) -> np.ndarray:
    """Annotation rings = |prime - gt| summed over RGB > 50 (clean_riga.py:104-128)."""
    diff = np.abs(prime_img.astype(float) - gt_img.astype(float)).sum(axis=2)
    return label_concentric_rings(diff > 50)


def clean_riga(input_path: Path, output_path: Optional[Path] = None) -> Path:
    """RIGA raw tree -> cleaned prime PNGs + palette GT PNGs.

    Finds ``*prime.{tif,tiff,jpg,jpeg}`` recursively; each must have variants
    ``{base}-{1..6}.*`` next to it. Output names are
    ``{counter:03d}_{parent}_{cleanedname}_{prime|gtK}.png``
    (clean_riga.py:189-330).
    """
    input_path = Path(input_path)
    output_path = Path(output_path) if output_path else input_path.parent / (input_path.name + "_cleaned")
    output_path.mkdir(parents=True, exist_ok=True)
    prime_files: List[str] = []
    for ext in ("tif", "tiff", "jpg", "jpeg"):
        prime_files.extend(str(p) for p in input_path.rglob(f"*prime.{ext}"))

    seen = set()
    counter = 0
    for prime_path in sorted(prime_files):
        pp = Path(prime_path)
        base = pp.stem[: -len("prime")]
        out_base = f"{pp.parent.name}_{pp.stem.replace('prime', '').replace('image', 'im')}"
        if out_base in seen:
            logger.warning("naming conflict for %s; skipping", out_base)
            continue
        seen.add(out_base)

        variants = {}
        for k in range(1, 7):
            for ext in (".tif", ".tiff", ".jpg", ".jpeg"):
                cand = pp.parent / f"{base}-{k}{ext}"
                if cand.exists():
                    variants[k] = cand
                    break
        if len(variants) < 6:
            logger.warning("missing GT variants for %s", prime_path)
            continue

        prime_img = read_image(prime_path).array
        write_png(output_path / f"{counter:03d}_{out_base}_prime.png", prime_img,
                  mode="L" if prime_img.ndim == 2 else "RGB")
        for k in range(1, 7):
            try:
                label = extract_riga_gt_label(prime_img, read_image(variants[k]).array)
            except ValueError as exc:
                logger.warning("variant %d of %s failed: %s", k, prime_path, exc)
                continue
            label_u8 = label.astype(np.uint8)
            g1, g2 = (label_u8 == 1).sum(), (label_u8 == 2).sum()
            if g1 < 0.01 * g2 or g2 < 0.01 * g1:
                logger.warning("label areas too different for %s gt%d", prime_path, k)
                continue
            palette = [0, 0, 0, 0, 255, 0, 255, 0, 0] + [0] * (768 - 9)
            write_png(output_path / f"{counter:03d}_{out_base}_gt{k}.png", label_u8, palette,
                      mode="P")
        counter += 1
    return output_path


def _riga_clinic(filename: str) -> str:
    found = [c for c in RIGA_CLINICS if c in filename]
    if len(found) != 1:
        raise ValueError(f"Filename '{filename}' must contain exactly one of {RIGA_CLINICS}")
    return found[0]


def process_riga(
    data_path: Path,
    save_path: Path,
    *,
    image_size: int = 128,
    crop_multiplier: float = 2.0,
    min_raters: int = 6,
    mean_diam_cache: Optional[Path] = None,
) -> int:
    """Cleaned RIGA PNGs -> preprocessed npy tree (process_riga.py:376-545).

    Mean disc diameters are computed per clinic over all individual rater
    bbox diameters (cached as JSON) and set the crop size.
    """
    data_path, save_path = Path(data_path), Path(save_path)
    cases = []
    for prime_file in sorted(data_path.glob("*_prime.png")):
        stem = prime_file.stem.replace("_prime", "")
        try:
            clinic = _riga_clinic(prime_file.name)
        except ValueError as exc:
            logger.warning("%s", exc)
            continue
        gt_files = []
        for k in range(1, 7):
            gt = data_path / f"{stem}_gt{k}.png"
            if not gt.exists():
                break
            gt_files.append(gt)
        if len(gt_files) >= min_raters:
            cases.append((clinic, prime_file, gt_files[:6]))

    # per-clinic mean diameters over individual rater discs
    cache = Path(mean_diam_cache) if mean_diam_cache else save_path.parent / "mean_diam.json"
    if cache.exists():
        mean_diam = {k: float(v) for k, v in json.loads(cache.read_text()).items()}
    else:
        diam: Dict[str, List[float]] = {c: [] for c in RIGA_CLINICS}
        for clinic, _, gt_files in cases:
            for gt in gt_files:
                label = read_png(gt)
                disc = keep_largest_component(label >= 1)
                if disc.any():
                    diam[clinic].append(get_bbox_diameter(disc))
        mean_diam = {c: float(np.mean(v)) if v else float("nan") for c, v in diam.items()}
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(mean_diam, indent=2) + "\n")

    images_dir, labels_dir = _ensure_output_dirs(save_path)
    n_saved = 0
    for clinic, prime_file, gt_files in cases:
        sample_id = f"s_{n_saved:06d}"
        labels, discs = [], []
        for gt in gt_files:
            label = read_png(gt)
            labels.append(label)
            discs.append(keep_largest_component(label >= 1))
        union = np.any(np.stack(discs), axis=0)
        if not union.any():
            continue
        center = get_bbox_center(union)
        crop_size = max(1, int(round(mean_diam[clinic] * crop_multiplier)))
        _crop_resize_save(
            _load_image_rgb(prime_file), labels, center, crop_size, image_size,
            images_dir / f"{sample_id}.npy",
            [labels_dir / f"{sample_id}_{i:02d}_mask.npy" for i in range(len(labels))],
        )
        n_saved += 1
    return n_saved


# --------------------------------------------------------------------------
# REFUGE (7 raters, case folders)
# --------------------------------------------------------------------------

def process_refuge(
    data_root: Path,
    save_path: Path,
    *,
    image_size: int = 128,
    crop_multiplier: float = 2.0,
    split_dirs: Sequence[Tuple[str, str]] = (
        ("train", "Training-400"),
        ("val", "Validation-400"),
        ("test", "Test-400"),
    ),
    all_split_normalization: bool = True,
    mean_diam_cache: Optional[Path] = None,
) -> int:
    """REFUGE-Multirater case folders -> preprocessed npy tree.

    Each case folder holds ``{stem}.jpg`` and 7 ``{stem}_seg_{disc,cup}_{k}.png``
    annotations. Mean disc diameter over individual annotators sets the crop
    (dataset-wide with ``all_split_normalization``, else per train/valtest) —
    ``process_refuge.py:233-439``.
    """
    data_root, save_path = Path(data_root), Path(save_path)
    cases: List[Tuple[str, Path]] = []
    for split_name, dirname in split_dirs:
        split_root = data_root / dirname
        if not split_root.exists():
            continue
        for case_dir in sorted(split_root.iterdir()):
            if case_dir.is_dir() and not case_dir.name.startswith("."):
                cases.append((split_name, case_dir))

    def load_annotations(folder: Path):
        stem = folder.name
        discs, cups = [], []
        for k in range(1, 8):
            disc = keep_largest_component(
                _load_binary_mask(folder / REFUGE_DISC_ANNOTATION.format(stem=stem, idx=k)))
            cup = keep_largest_component(
                _load_binary_mask(folder / REFUGE_CUP_ANNOTATION.format(stem=stem, idx=k)))
            disc = np.logical_or(disc, cup)
            cup = np.logical_and(cup, disc)
            discs.append(disc)
            cups.append(cup)
        return discs, cups

    cache = Path(mean_diam_cache) if mean_diam_cache else save_path.parent / "mean_diam.json"
    if cache.exists():
        mean_diam = {k: float(v) for k, v in json.loads(cache.read_text()).items()}
    else:
        by_split: Dict[str, List[float]] = {"train": [], "valtest": []}
        for split_name, folder in cases:
            discs, _ = load_annotations(folder)
            key = "train" if split_name == "train" else "valtest"
            by_split[key].extend(
                get_bbox_diameter(d) for d in discs if d.any()
            )
        mean_diam = {
            "train": float(np.mean(by_split["train"])) if by_split["train"] else float("nan"),
            "valtest": float(np.mean(by_split["valtest"])) if by_split["valtest"] else float("nan"),
        }
        allv = by_split["train"] + by_split["valtest"]
        mean_diam["all"] = float(np.mean(allv)) if allv else float("nan")
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(mean_diam, indent=2) + "\n")

    images_dir, labels_dir = _ensure_output_dirs(save_path)
    n_saved = 0
    for split_name, folder in cases:
        sample_id = f"{split_name}_{n_saved:06d}"
        discs, cups = load_annotations(folder)
        labels = [build_label(d, c) for d, c in zip(discs, cups)]
        union = np.any(np.stack(discs), axis=0)
        if not union.any():
            continue
        center = get_bbox_center(union)
        key = "all" if all_split_normalization else ("train" if split_name == "train" else "valtest")
        crop_size = max(1, int(round(mean_diam[key] * crop_multiplier)))
        image = _load_image_rgb(folder / REFUGE_IMAGE_NAME.format(stem=folder.name))
        _crop_resize_save(
            image, labels, center, crop_size, image_size,
            images_dir / f"{sample_id}.npy",
            [labels_dir / f"{sample_id}_{i:02d}_mask.npy" for i in range(7)],
        )
        n_saved += 1
    return n_saved


# --------------------------------------------------------------------------
# combined-retina random splits
# --------------------------------------------------------------------------

def gen_splits_retina(
    dataset_roots: Dict[str, Path],
    output_path: Path,
    *,
    train_ratio: float = 0.5,
    val_ratio: float = 0.1,
    seed: int = 123,
) -> Path:
    """Combined random splits over prefixed paths (gen_splits_retina.py).

    ``dataset_roots`` maps dataset names (e.g. ``chaksu128``) to their roots;
    sample paths are prefixed ``<name>/images/<image>.npy`` (resolved as
    ``parent_dir/<name>/preprocessed/<rel>`` by the combined loader). The
    three retina OOD splits (fov/flash/blur) are copies of ``id_test`` — the
    shifted images are generated from them by ``data/ood.py``. Per-dataset
    rater counts (Chaksu 5 / RIGA 6 / REFUGE 7) are counted from the label
    tree and recorded in ``_meta.dataset_configs``.
    """
    samples: List[str] = []
    dataset_configs: Dict[str, dict] = {}
    for name, root in sorted(dataset_roots.items()):
        image_dir = Path(root) / "preprocessed" / "images"
        label_dir = Path(root) / "preprocessed" / "labels"
        found = sorted(p.name for p in image_dir.glob("*.npy"))
        if not found:
            raise RuntimeError(f"no samples found in {image_dir}")
        base0 = Path(found[0]).stem
        n_raters = len(list(label_dir.glob(f"{base0}_*_mask.npy")))
        if n_raters == 0:
            raise RuntimeError(f"no rater masks for {base0} in {label_dir}")
        dataset_configs[name] = {"num_raters": n_raters}
        samples.extend(f"{name}/images/{fname}" for fname in found)

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples))
    arr = np.array(samples, dtype=object)[order]
    n_train = int(round(train_ratio * len(arr)))
    n_val = int(round(val_ratio * len(arr)))
    train, val, test = arr[:n_train], arr[n_train:n_train + n_val], arr[n_train + n_val:]

    fold = {
        "train": train,
        "val": val,
        "id_test": test,
        "ood_fov": test.copy(),
        "ood_flash": test.copy(),
        "ood_blur": test.copy(),
        "ood_unlabeled_pool": np.array([], dtype=object),
        "_meta": {
            "schema": "combined_retina_random",
            "seed": seed,
            "dataset_configs": dataset_configs,
        },
    }
    output_path = Path(output_path)
    if output_path.suffix != ".pkl":
        output_path = output_path / "splits.pkl"
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with output_path.open("wb") as f:
        pickle.dump([fold], f)
    return output_path


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Retina-family raw-data pipelines")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("chaksu")
    p.add_argument("--train-image-dir", type=Path, required=True)
    p.add_argument("--test-image-dir", type=Path, required=True)
    p.add_argument("--train-label-dir", type=Path, required=True)
    p.add_argument("--test-label-dir", type=Path, required=True)
    p.add_argument("--save-path", type=Path, required=True)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--disc-crop-dia", type=float, default=2.0)

    p = sub.add_parser("chaksu-splits")
    p.add_argument("--dataset-root", type=Path, required=True)
    p.add_argument("--num-splits", type=int, default=5)
    p.add_argument("--seed", type=int, default=123)

    p = sub.add_parser("clean-riga")
    p.add_argument("--input", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)

    p = sub.add_parser("riga")
    p.add_argument("--data-path", type=Path, required=True)
    p.add_argument("--save-path", type=Path, required=True)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--crop-multiplier", type=float, default=2.0)

    p = sub.add_parser("refuge")
    p.add_argument("--data-root", type=Path, required=True)
    p.add_argument("--save-path", type=Path, required=True)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--crop-multiplier", type=float, default=2.0)

    p = sub.add_parser("retina-splits")
    p.add_argument("--roots", nargs="+", required=True, help="name=path pairs")
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--seed", type=int, default=123)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cmd == "chaksu":
        rows = process_chaksu(
            args.train_image_dir, args.test_image_dir,
            args.train_label_dir, args.test_label_dir, args.save_path,
            image_size=args.image_size, disc_crop_dia=args.disc_crop_dia,
        )
        print(f"processed {len(rows)} samples")
    elif args.cmd == "chaksu-splits":
        out = gen_splits_chaksu(args.dataset_root, num_splits=args.num_splits, seed=args.seed)
        print(f"splits -> {out}")
    elif args.cmd == "clean-riga":
        out = clean_riga(args.input, args.output)
        print(f"cleaned -> {out}")
    elif args.cmd == "riga":
        n = process_riga(args.data_path, args.save_path,
                         image_size=args.image_size, crop_multiplier=args.crop_multiplier)
        print(f"processed {n} cases")
    elif args.cmd == "refuge":
        n = process_refuge(args.data_root, args.save_path,
                           image_size=args.image_size, crop_multiplier=args.crop_multiplier)
        print(f"processed {n} cases")
    elif args.cmd == "retina-splits":
        roots = dict(pair.split("=", 1) for pair in args.roots)
        out = gen_splits_retina({k: Path(v) for k, v in roots.items()}, args.output,
                                seed=args.seed)
        print(f"splits -> {out}")


if __name__ == "__main__":
    main()
