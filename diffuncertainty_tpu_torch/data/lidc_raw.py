"""Raw LIDC-IDRI DICOM->nodule-crop stage (the reference's pylidc pipeline;
port of ``diffuncertainty_tpu/data/lidc_raw.py``, the same numpy and scipy).

Rebuilds the behavior of the reference's ``datasets/lidc-idri/
save_cropped_nodules_2d.py`` (and the 3D variant's cropping core) without a
hard pylidc dependency: the scan source is an adapter interface, so the
geometry/clustering/resampling/slice-extraction logic — the actual pipeline —
is real, tested code here, and only the DICOM/annotation *reader* is
delegated to pylidc when the ~120 GB archive is present.

Pipeline (matching the reference stage's observable behavior):

1. For every CT scan, cluster the per-rater nodule annotations into physical
   nodules (union-find over pairwise centroid distance; the reference uses
   pylidc's ``Scan.cluster_annotations``).
2. Skip nodules whose 10%-consensus mask spans more than ``max_mask_extent``
   (64) voxels in any dimension (``save_cropped_nodules_2d.py:30-36``).
3. Resample a fixed 63 mm cube centered on the first annotation's centroid
   onto an isotropic grid — 1 mm voxels for the 64px variant, 63/127 mm for
   the 128px variant, i.e. ``side_mm/voxel_mm + 1`` samples per axis
   (``save_cropped_nodules_2d.py:72-76,91-97``) — trilinear for the image
   volume, with ALL rater masks sampled on the same interpolation points
   (nearest/thresholded); raters without an annotation get zero masks.
   ``raw_z_sampling`` snaps z-coordinates to the nearest acquired slice
   instead of interpolating across the (coarse) z-axis.
4. Save every axial slice on which at least one rater is positive:
   ``images/{scan_id:04d}_{idx:03d}.npy`` + four
   ``labels/{scan_id:04d}_{idx:03d}_{rater:02d}_mask.npy`` files, where
   ``idx`` is a per-scan running crop counter (the reference increments its
   ``local_nod_idx`` once per saved slice), plus a ``metadata.csv`` carrying
   the nine pylidc semantic features as per-rater lists (None-padded) and
   list-repr segmentation paths, cell-format-matching the reference's
   pandas-written CSV (``save_cropped_nodules_2d.py:38-58,118-144``).

``crops_to_aggregated_pickle`` additionally bundles a crop tree into the
aggregated-pickle format consumed by ``data/lidc_import.py``, so the full
chain raw scans -> crops -> pickle -> on-disk MultiRater contract runs end
to end (held to the JAX module on synthetic scans in
``tests/test_torch_port_lidc.py``).
"""

from __future__ import annotations

import csv
import dataclasses
import pickle
from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np
from scipy import ndimage as ndi

FEATURE_NAMES = (
    "subtlety",
    "internal Structure",
    "calcification",
    "sphericity",
    "margin",
    "lobulation",
    "spiculation",
    "texture",
    "malignancy",
)
RATER_COUNT = 4
SIDE_MM = 63.0  # physical crop side; 64 samples at 1 mm, 128 at 63/127 mm


@dataclasses.dataclass
class RaterAnnotation:
    """One rater's delineation of one nodule, in voxel space.

    ``mask`` is a boolean array over the full scan grid OR a smaller array
    placed at ``offset`` (voxel index of mask[0,0,0] in the scan) — the
    sparse form mirrors how contour rasterizations are stored.
    """

    mask: np.ndarray  # bool, (d0, d1, d2) with axes (y, x, z) like pylidc
    offset: tuple[int, int, int] = (0, 0, 0)
    features: dict | None = None  # subtlety, malignancy, ... (ints)

    def centroid_vox(self) -> np.ndarray:
        idx = np.argwhere(self.mask)
        if idx.size == 0:
            raise ValueError("empty annotation mask")
        return idx.mean(axis=0) + np.asarray(self.offset, float)

    def dense(self, shape: tuple[int, int, int]) -> np.ndarray:
        out = np.zeros(shape, bool)
        o = self.offset
        s = self.mask.shape
        out[o[0]:o[0] + s[0], o[1]:o[1] + s[1], o[2]:o[2] + s[2]] = self.mask
        return out


@dataclasses.dataclass
class ScanRecord:
    """One CT scan with its rater annotations (adapter output)."""

    scan_id: int
    patient_id: str
    volume: np.ndarray  # float, (y, x, z) Hounsfield units
    spacing: tuple[float, float, float]  # mm per voxel along (y, x, z)
    annotations: list[RaterAnnotation]
    series_uid: str = ""


def cluster_annotations(
    annotations: Sequence[RaterAnnotation],
    spacing: Sequence[float],
    max_dist_mm: float = 10.0,
) -> list[list[RaterAnnotation]]:
    """Group annotations of the same physical nodule (union-find on pairwise
    physical centroid distance).

    The reference delegates this to pylidc's ``Scan.cluster_annotations``
    (agglomerative on annotation distance); centroid distance with a 10 mm
    default reproduces its grouping for the compact (<=64 voxel) nodules this
    stage keeps. Groups are ordered by first-annotation appearance; at most
    ``RATER_COUNT`` members are kept per group (the reference reads
    ``nod[ann_idx]`` for ann_idx < 4 only).
    """
    n = len(annotations)
    if n == 0:
        return []
    cents = np.stack([a.centroid_vox() for a in annotations])  # (n, 3) voxels
    mm = cents * np.asarray(spacing, float)[None, :]
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if np.linalg.norm(mm[i] - mm[j]) <= max_dist_mm:
                parent[find(i)] = find(j)

    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    ordered = sorted(groups.values(), key=lambda idxs: min(idxs))
    return [[annotations[i] for i in idxs[:RATER_COUNT]] for idxs in ordered]


def consensus_mask(
    masks: Sequence[np.ndarray], clevel: float = 0.5
) -> np.ndarray:
    """Fraction-of-raters consensus: voxel on iff >= clevel of raters mark it."""
    stack = np.stack([m.astype(np.float32) for m in masks])
    return stack.mean(axis=0) >= max(clevel, 1e-9)


def consensus_extent_vox(group: Sequence[RaterAnnotation], clevel: float = 0.1) -> int:
    """Max bounding-box side (voxels) of the group's clevel consensus mask.

    Mirrors the reference's oversize filter (it measures the shape of
    pylidc's consensus *crop*, i.e. the consensus bbox) —
    ``save_cropped_nodules_2d.py:30-36``.
    """
    # work in a local frame covering all offsets to avoid full-scan allocs
    mins = np.min([a.offset for a in group], axis=0)
    maxs = np.max(
        [np.asarray(a.offset) + a.mask.shape for a in group], axis=0)
    shape = tuple(int(x) for x in (maxs - mins))
    dense = []
    for a in group:
        local = RaterAnnotation(
            a.mask, tuple(int(x) for x in (np.asarray(a.offset) - mins)))
        dense.append(local.dense(shape))
    cons = consensus_mask(dense, clevel)
    idx = np.argwhere(cons)
    if idx.size == 0:
        return 0
    return int((idx.max(axis=0) - idx.min(axis=0) + 1).max())


def uniform_cubic_resample(
    volume: np.ndarray,
    spacing: Sequence[float],
    center_vox: Sequence[float],
    side_mm: float = SIDE_MM,
    voxel_mm: float = 1.0,
    raw_z_sampling: bool = True,
    order: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Resample an isotropic cube around ``center_vox``.

    Returns ``(cube, coords)`` where cube has ``round(side_mm/voxel_mm)+1``
    samples per axis and ``coords`` (3, n, n, n) are the voxel-space
    interpolation points — pass them back via ``resample_mask_at`` so every
    rater mask lands on the IDENTICAL grid (the reference reuses pylidc's
    ``irp_pts`` the same way, ``save_cropped_nodules_2d.py:88-108``).

    ``raw_z_sampling`` snaps the z interpolation coordinates to the nearest
    acquired slice (CT z-spacing is coarse and anisotropic; interpolating
    across slices smears the image).
    """
    n = int(round(side_mm / voxel_mm)) + 1
    spacing = np.asarray(spacing, float)
    center_mm = np.asarray(center_vox, float) * spacing
    half = side_mm / 2.0
    axes_mm = [center_mm[d] + np.linspace(-half, half, n) for d in range(3)]
    axes_vox = [axes_mm[d] / spacing[d] for d in range(3)]
    if raw_z_sampling:
        axes_vox[2] = np.round(axes_vox[2])
    grid = np.meshgrid(*axes_vox, indexing="ij")
    coords = np.stack(grid)  # (3, n, n, n)
    cube = ndi.map_coordinates(
        volume.astype(np.float32), coords, order=order, mode="nearest")
    return cube, coords


def resample_mask_at(mask: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Sample a boolean mask on shared interpolation points (>=0.5 rule)."""
    vals = ndi.map_coordinates(
        mask.astype(np.float32), coords, order=1, mode="constant", cval=0.0)
    return vals >= 0.5


@dataclasses.dataclass
class CropConfig:
    voxel_mm: float = 1.0  # 1.0 -> 64px crops; 63/127 -> 128px crops
    side_mm: float = SIDE_MM
    max_mask_extent: int = 64  # consensus-bbox oversize filter (voxels)
    consensus_clevel: float = 0.1
    cluster_max_dist_mm: float = 10.0
    raw_z_sampling: bool = True

    @classmethod
    def large(cls) -> "CropConfig":
        return cls(voxel_mm=SIDE_MM / 127.0)  # 128 samples per axis

    @property
    def samples_per_axis(self) -> int:
        return int(round(self.side_mm / self.voxel_mm)) + 1


def extract_nodule_crops(
    scan: ScanRecord, cfg: CropConfig
) -> list[dict]:
    """All positive 2D slices of every kept nodule of one scan.

    Returns dicts with ``image`` (n, n) float32, ``masks`` (RATER_COUNT, n, n)
    bool, ``features`` (per-rater value lists, None-padded to RATER_COUNT),
    and group/slice indices.
    """
    groups = cluster_annotations(
        scan.annotations, scan.spacing, cfg.cluster_max_dist_mm)
    out = []
    for g_idx, group in enumerate(groups):
        if consensus_extent_vox(group, cfg.consensus_clevel) > cfg.max_mask_extent:
            continue
        center = group[0].centroid_vox()
        cube, coords = uniform_cubic_resample(
            scan.volume, scan.spacing, center,
            side_mm=cfg.side_mm, voxel_mm=cfg.voxel_mm,
            raw_z_sampling=cfg.raw_z_sampling,
        )
        shape = scan.volume.shape
        rater_cubes = []
        for r in range(RATER_COUNT):
            if r < len(group):
                rater_cubes.append(resample_mask_at(group[r].dense(shape), coords))
            else:
                rater_cubes.append(np.zeros(cube.shape, bool))
        positive = [
            z for z in range(cube.shape[2])
            if any(m[:, :, z].any() for m in rater_cubes)
        ]
        # per-rater feature lists, None-padded to RATER_COUNT, matching the
        # reference's append_metadata accumulation over all annotations of
        # the cluster (save_cropped_nodules_2d.py:38-58,100-116)
        features: dict[str, list] = {}
        for name in FEATURE_NAMES:
            key = name.replace(" ", "")
            features[key] = [
                (group[r].features or {}).get(key) if r < len(group) else None
                for r in range(RATER_COUNT)
            ]
        for z in positive:
            out.append({
                "image": cube[:, :, z],
                "masks": np.stack([m[:, :, z] for m in rater_cubes]),
                "features": features,
                "nodule": g_idx,
                "slice": z,
            })
    return out


def save_crops(
    scans: Iterable[ScanRecord],
    save_path: str | Path,
    cfg: CropConfig | None = None,
    progress: Callable[[str], None] | None = None,
) -> Path:
    """Run the stage over scans; write the reference's crop-tree contract.

    Layout: ``images/{scan:04d}_{idx:03d}.npy``,
    ``labels/{scan:04d}_{idx:03d}_{rater:02d}_mask.npy``, ``metadata.csv``
    (``save_cropped_nodules_2d.py:118-144``); ``idx`` counts saved slices
    per scan.
    """
    cfg = cfg or CropConfig()
    root = Path(save_path)
    images_dir = root / "images"
    labels_dir = root / "labels"
    images_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    for scan in scans:
        if progress:
            progress(f"scan {scan.scan_id} ({scan.patient_id})")
        crops = extract_nodule_crops(scan, cfg)
        for idx, crop in enumerate(crops):
            stem = f"{scan.scan_id:04d}_{idx:03d}"
            np.save(images_dir / f"{stem}.npy", crop["image"].astype(np.float32))
            seg_paths = []
            for r in range(RATER_COUNT):
                p = labels_dir / f"{stem}_{r:02d}_mask.npy"
                np.save(p, crop["masks"][r].astype(np.intc))
                seg_paths.append(str(p))
            # feature cells are per-rater LISTS and Segmentation Save Paths a
            # list too — csv str()s them to the same list-repr cells the
            # reference's pandas to_csv writes (save_cropped_nodules_2d.py:
            # 38-58,131-144)
            row = {
                "Patient ID": scan.patient_id,
                "Scan ID": f"{scan.scan_id:04d}",
                "Nodule Index": f"{idx:03d}",
                "Image Save Path": str(images_dir / f"{stem}.npy"),
                "Segmentation Save Paths": seg_paths,
            }
            for name in FEATURE_NAMES:
                row[name] = crop["features"].get(name.replace(" ", ""), "")
            rows.append(row)
    header = ["Patient ID", "Scan ID", "Nodule Index",
              *FEATURE_NAMES, "Image Save Path", "Segmentation Save Paths"]
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=header)
        w.writeheader()
        w.writerows(rows)
    return root


def crops_to_aggregated_pickle(
    crop_root: str | Path,
    out_pickle: str | Path,
    series_uid_by_scan: dict[str, str],
) -> Path:
    """Bundle a crop tree into the aggregated pickle ``data/lidc_import.py``
    consumes (per entry: ``image``, ``masks``, ``series_uid``) so the chain
    raw -> pickle -> on-disk contract runs without the reference scripts."""
    root = Path(crop_root)
    entries: dict[str, dict] = {}
    for img_path in sorted((root / "images").glob("*.npy")):
        stem = img_path.stem
        scan_id = stem.split("_")[0]
        masks = [
            np.load(root / "labels" / f"{stem}_{r:02d}_mask.npy")
            for r in range(RATER_COUNT)
        ]
        entries[stem] = {
            "image": np.load(img_path),
            "masks": np.stack(masks),
            "series_uid": series_uid_by_scan[scan_id],
        }
    out = Path(out_pickle)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(entries, f)
    return out


def iter_pylidc_scans(large: bool = False) -> Iterable[ScanRecord]:
    """Adapter over the pylidc annotation DB + DICOM archive.

    Requires the external LIDC-IDRI archive and the pylidc package, which
    is imported here and nowhere else: every other part of the stage runs
    without it.
    """
    try:
        import pylidc as pl  # type: ignore
    except ImportError as e:  # pragma: no cover - external dependency
        raise ImportError(
            "pylidc (and the LIDC-IDRI DICOM archive) are required for the "
            "raw stage's reader; the rest of the pipeline is local. Install "
            "pylidc and configure ~/.pylidcrc, or start from the aggregated "
            "pickle via data/lidc_import.py."
        ) from e
    for scan in pl.query(pl.Scan):  # pragma: no cover - external dependency
        vol = scan.to_volume(verbose=False)
        anns = []
        for ann in scan.annotations:
            mask = ann.boolean_mask()
            offset = tuple(int(s.start) for s in ann.bbox())
            feats = {name.replace(" ", ""): getattr(ann, name.replace(" ", ""))
                     for name in FEATURE_NAMES}
            anns.append(RaterAnnotation(mask=mask, offset=offset, features=feats))
        yield ScanRecord(
            scan_id=int(scan.id), patient_id=str(scan.patient_id),
            volume=vol,
            spacing=(float(scan.pixel_spacing), float(scan.pixel_spacing),
                     float(scan.slice_spacing)),
            annotations=anns, series_uid=str(scan.series_instance_uid),
        )


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save_path", "-s", required=True)
    ap.add_argument("-large", action="store_true",
                    help="128px crops (63/127 mm voxels) instead of 64px")
    args = ap.parse_args(argv)
    cfg = CropConfig.large() if args.large else CropConfig()
    save_crops(iter_pylidc_scans(args.large), args.save_path, cfg,
               progress=print)


if __name__ == "__main__":
    main()
