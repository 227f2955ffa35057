"""Toy 3D controlled environment (ValUES R1 Cases 1-3b; port of
``diffuncertainty_tpu/data/toy3d.py``).

Rebuilds the reference's toy-data generator
(``datasets/toy_data_generation/dataset_generation.py:1-261``,
``stl_to_nifty.py:1-167``, ``create_splits.py:1-128``) without the STL
dependency: the two reference meshes (ballSphere.stl, Cube.stl) are replaced
by analytic voxelizations, everything else — random object sizing between
``image/min_ratio`` and ``image/max_ratio``, in-frame or over-border
placement with the 3-bit sign pattern + random flips, gray-value rendering,
Gaussian blur, background noise, and the *rater-threshold ambiguity
mechanism* (n_raters segmentation thresholds spread over image quantiles of
the blurred object) — follows the reference exactly, using the same
``random``/``numpy.random`` call sequence so configs reproduce the study
design:

- **Case 1**: blurred spheres (sigma 2), no noise, 3 raters — pure aleatoric
  ambiguity from the threshold spread;
- **Case 2**: crisp spheres + background noise, 1 rater; OoD tests add gray
  rendering, cubes, and over-border placement;
- **Case 3a/3b**: mixed blurred+crisp training (3 raters) with the Case-2
  style OoD test suite (3b adds a blurred 3-rater test chunk).

Volumes are written as ``.npy`` (the repo's dataset contract; the reference
wrote ``.nii.gz``) with rater masks ``{id}_{rater:02d}_mask.npy`` next to
them, ready for ``preprocess.preprocess_volumes_to_slices``.

The JAX module seeds the global ``random`` and ``np.random`` with each
chunk's seed and draws from them; here each chunk draws the same streams
from its own ``random.Random(seed)`` and ``np.random.RandomState(seed)``, so
the volumes and masks are the same and the global states are left as they
were. ``create_splits_toy`` shuffles as scikit-learn's ``KFold(shuffle=True,
random_state=seed)`` does (``kfold_indices``), without scikit-learn.
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
import random
from dataclasses import dataclass, asdict, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# analytic shape voxelization (replaces stltovoxel meshes_to_numpy)
# --------------------------------------------------------------------------

def shape_to_volume(shape: str, resolution: int) -> np.ndarray:
    """Voxelize the named shape into a cube of side ``resolution``.

    ``sphere`` fills voxels within the inscribed ball (the reference's
    ballSphere.stl voxelized); ``cube`` fills the whole block (Cube.stl)."""
    if shape == "cube":
        return np.ones((resolution,) * 3, np.float32)
    if shape == "sphere":
        c = (resolution - 1) / 2.0
        r = resolution / 2.0
        zz, yy, xx = np.mgrid[:resolution, :resolution, :resolution]
        return (((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2) <= r * r).astype(np.float32)
    raise ValueError(f"unknown shape '{shape}'")


def embed_object(offset: Sequence[int], obj: np.ndarray, image_size: Sequence[int],
                 allow_negative: bool = False) -> np.ndarray:
    """Place the object volume at ``offset`` inside a zero image
    (stl_to_nifty.py:95-143); negative offsets clip the object."""
    image = np.zeros(tuple(image_size), np.float32)
    if not allow_negative:
        image[offset[0]:offset[0] + obj.shape[0],
              offset[1]:offset[1] + obj.shape[1],
              offset[2]:offset[2] + obj.shape[2]] = obj
        return image
    starts = [max(o, 0) for o in offset]
    obj_starts = [0 if o > 0 else -o for o in offset]
    image[starts[0]:offset[0] + obj.shape[0],
          starts[1]:offset[1] + obj.shape[1],
          starts[2]:offset[2] + obj.shape[2]] = obj[obj_starts[0]:, obj_starts[1]:, obj_starts[2]:]
    return image


def add_background_noise(noise_prob: float, image: np.ndarray,
                         rs: np.random.RandomState) -> np.ndarray:
    """Uniform noise on ~half the background voxels (stl_to_nifty.py:146-151)."""
    prob = rs.rand(*image.shape)
    noise = rs.rand(*image.shape)
    noise[prob <= noise_prob] = 0
    image[image < 0.1] = noise[image < 0.1]
    return image


def rater_thresholds(image: np.ndarray, n_raters: int, all_raters_same: bool) -> np.ndarray:
    """The ValUES controlled-ambiguity mechanism (dataset_generation.py:144-166):
    rater k's threshold is the image quantile at (1 - k'th fraction of the
    object ratio), so raters systematically under/over-segment the blurred
    boundary."""
    if n_raters == 1:
        return np.asarray([0.1])
    if all_raters_same:
        return np.asarray([0.1] * n_raters)
    perc_step = (1 - 0.1) / (n_raters - 1)
    perc_thresholds = np.arange(0.1, 1 + perc_step, perc_step)
    object_ratio = np.count_nonzero(image >= 0.1) / image.size
    return np.quantile(image, 1 - perc_thresholds * object_ratio)


# --------------------------------------------------------------------------
# sample generation
# --------------------------------------------------------------------------

@dataclass
class ToyCaseConfig:
    """One generation chunk — mirrors the reference JSON configs."""

    shapes: Tuple[str, ...] = ("sphere",)
    save_dir: str = "imagesTr"  # relative to the case root
    n_samples: int = 10
    image_size: Tuple[int, int, int] = (64, 64, 64)
    min_object_ratio: int = 5
    max_object_ratio: int = 2
    gauss_sigma: float = 8.0
    object_gray: bool = False
    blur: bool = False
    noise: bool = False
    segmentation: bool = True
    n_raters: int = 1
    all_raters_same: bool = False
    object_over_border: bool = False
    sample_offset: int = 0
    seed: int = 22


def generate_chunk(cfg: ToyCaseConfig, case_root: Path) -> List[str]:
    """Generate one config chunk of volumes + rater masks under ``case_root``."""
    py = random.Random(cfg.seed)
    rs = np.random.RandomState(cfg.seed)
    out_dir = case_root / cfg.save_dir
    # rater masks live next to the volumes (the reference nests a
    # segmentation/ subdir; the flat layout feeds
    # preprocess.preprocess_volumes_to_slices directly)
    seg_dir = out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    size = tuple(cfg.image_size)
    saved: List[str] = []

    for i in range(cfg.n_samples):
        resolution = py.randint(
            int(max(size) / cfg.min_object_ratio), int(max(size) / cfg.max_object_ratio)
        )
        obj = shape_to_volume(cfg.shapes[i % len(cfg.shapes)], resolution)
        max_off = [size[d] - obj.shape[d] for d in range(3)]
        if not cfg.object_over_border:
            offset = [py.randint(0, max_off[d]) for d in range(3)]
            image = embed_object(offset, obj, size)
        else:
            min_off = [int(-2 * obj.shape[d] / 3) for d in range(3)]
            bits = format(py.randint(1, 7), "b").zfill(3)
            offset = [
                py.randint(min_off[d], 0) if int(bits[d])
                else py.randint(0, max_off[d])
                for d in range(3)
            ]
            image = embed_object(offset, obj, size, allow_negative=True)
            if py.random() > 0.5:
                image = np.fliplr(image)
            if py.random() > 0.5:
                image = np.flipud(image)
        if cfg.object_gray:
            image = image * py.uniform(0.5, 0.9)
        if cfg.blur:
            image = gaussian_filter(image, sigma=cfg.gauss_sigma)

        sample_idx = cfg.sample_offset + i
        sample_id = f"{sample_idx:04d}"
        if cfg.segmentation:
            for rater_idx, thr in enumerate(
                rater_thresholds(image, cfg.n_raters, cfg.all_raters_same)
            ):
                seg = np.where(image >= thr, 1, 0).astype(np.uint8)
                np.save(seg_dir / f"{sample_id}_{rater_idx:02d}_mask.npy", seg)
        if cfg.noise:
            image = add_background_noise(0.5, image, rs)
        np.save(out_dir / f"{sample_id}.npy", image.astype(np.float32))
        saved.append(sample_id)
    return saved


# --------------------------------------------------------------------------
# the four ValUES controlled cases
# --------------------------------------------------------------------------

def _case(shapes="sphere", **kw) -> ToyCaseConfig:
    return ToyCaseConfig(shapes=(shapes,) if isinstance(shapes, str) else tuple(shapes), **kw)


CASE_CONFIGS: Dict[str, List[ToyCaseConfig]] = {
    # Case 1: blurred spheres, 3 raters, no noise (configs/Case_1)
    "Case_1": [
        _case(save_dir="imagesTr", n_samples=200, gauss_sigma=2, blur=True,
              noise=False, n_raters=3, seed=16),
        _case(save_dir="imagesTs", n_samples=20, gauss_sigma=2, blur=True,
              noise=False, n_raters=3, seed=5),
    ],
    # Case 2: crisp spheres + noise; OoD tests gray/cube/over-border/plain
    "Case_2": [
        _case(save_dir="imagesTr", n_samples=200, noise=True, n_raters=1, seed=1),
        _case(save_dir="imagesTs", n_samples=7, object_gray=True, noise=True,
              n_raters=1, sample_offset=0, seed=14),
        _case("cube", save_dir="imagesTs", n_samples=7, noise=True, n_raters=1,
              sample_offset=7, seed=17),
        _case(save_dir="imagesTs", n_samples=7, noise=True, n_raters=1,
              object_over_border=True, sample_offset=14, seed=19),
        _case(save_dir="imagesTs", n_samples=21, noise=True, n_raters=1,
              sample_offset=21, seed=24),
    ],
    # Case 3a: mixed blurred+crisp 3-rater training, Case-2 OoD tests
    "Case_3a": [
        _case(save_dir="imagesTr", n_samples=100, blur=True, noise=True,
              n_raters=3, sample_offset=0, seed=63),
        _case(save_dir="imagesTr", n_samples=100, blur=False, noise=True,
              n_raters=3, sample_offset=100, seed=36),
        _case(save_dir="imagesTs", n_samples=7, object_gray=True, noise=True,
              n_raters=1, sample_offset=0, seed=14),
        _case("cube", save_dir="imagesTs", n_samples=7, noise=True, n_raters=1,
              sample_offset=7, seed=17),
        _case(save_dir="imagesTs", n_samples=7, noise=True, n_raters=1,
              object_over_border=True, sample_offset=14, seed=19),
        _case(save_dir="imagesTs", n_samples=21, noise=True, n_raters=1,
              sample_offset=21, seed=24),
    ],
    # Case 3b: 3a + an extra blurred 3-rater test chunk
    "Case_3b": [
        _case(save_dir="imagesTr", n_samples=100, blur=True, noise=True,
              n_raters=3, sample_offset=0, seed=63),
        _case(save_dir="imagesTr", n_samples=100, blur=False, noise=True,
              n_raters=3, sample_offset=100, seed=36),
        _case(save_dir="imagesTs", n_samples=7, object_gray=True, noise=True,
              n_raters=1, sample_offset=0, seed=14),
        _case("cube", save_dir="imagesTs", n_samples=7, noise=True, n_raters=1,
              sample_offset=7, seed=17),
        _case(save_dir="imagesTs", n_samples=7, noise=True, n_raters=1,
              object_over_border=True, sample_offset=14, seed=19),
        _case(save_dir="imagesTs", n_samples=21, noise=True, n_raters=1,
              sample_offset=21, seed=24),
        _case(save_dir="imagesTs", n_samples=21, blur=True, noise=True,
              n_raters=3, sample_offset=42, seed=34),
    ],
}


def generate_case(case: str, save_root: Path, *, scale: float = 1.0) -> Dict[str, int]:
    """Generate a full controlled case. ``scale`` shrinks n_samples (and the
    64^3 volumes stay) for quick fixtures; 1.0 reproduces the study sizes."""
    if case not in CASE_CONFIGS:
        raise ValueError(f"unknown case '{case}'; have {sorted(CASE_CONFIGS)}")
    case_root = Path(save_root) / case
    counts: Dict[str, int] = {}
    for cfg in CASE_CONFIGS[case]:
        n = max(1, int(round(cfg.n_samples * scale)))
        offset = int(round(cfg.sample_offset * scale))
        chunk = ToyCaseConfig(**{**asdict(cfg), "n_samples": n, "sample_offset": offset})
        ids = generate_chunk(chunk, case_root)
        counts[cfg.save_dir] = counts.get(cfg.save_dir, 0) + len(ids)
        info_path = case_root / f"dataset_info_{len(counts)}_{cfg.seed}.json"
        info_path.parent.mkdir(parents=True, exist_ok=True)
        info_path.write_text(json.dumps(asdict(chunk), indent=2))
    return counts


def kfold_indices(n: int, n_splits: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train, test) index arrays of scikit-learn's ``KFold(n_splits,
    shuffle=True, random_state=seed).split``: ``RandomState(seed)`` shuffles
    ``arange(n)``, the first ``n % n_splits`` folds take one more, and both
    index sets come back in ascending order."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def create_splits_toy(
    case_root: Path, *, seed: int = 123, n_splits: int = 5,
    splits_path: Optional[Path] = None,
) -> Path:
    """KFold train/val folds over imagesTr + shared test (create_splits.py:52-81)."""
    case_root = Path(case_root)

    def volumes(d):
        return sorted(p.name for p in d.glob("*.npy") if not p.name.endswith("_mask.npy"))

    train_files = volumes(case_root / "imagesTr")
    test_files = volumes(case_root / "imagesTs")
    if len(train_files) < n_splits:
        raise ValueError("n_splits exceeds number of training volumes")
    arr = np.array(train_files)
    splits = []
    for train_idx, val_idx in kfold_indices(len(arr), n_splits, seed):
        splits.append({
            "train": arr[train_idx],
            "val": arr[val_idx],
            "test": np.array(test_files),
        })
    out = Path(splits_path) if splits_path else case_root / "splits.pkl"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("wb") as f:
        pickle.dump(splits, f)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Toy 3D controlled cases (ValUES R1)")
    parser.add_argument("case", choices=sorted(CASE_CONFIGS) + ["all"])
    parser.add_argument("--save-root", type=Path, required=True)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--n-splits", type=int, default=5)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cases = sorted(CASE_CONFIGS) if args.case == "all" else [args.case]
    for case in cases:
        counts = generate_case(case, args.save_root, scale=args.scale)
        out = create_splits_toy(args.save_root / case,
                                n_splits=min(args.n_splits, max(2, counts.get("imagesTr", 2))))
        print(f"{case}: {counts} splits -> {out}")


if __name__ == "__main__":
    main()
