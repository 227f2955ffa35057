"""The port's dataset modules against the JAX package's on the same seeded
inputs: the OOD shifts, preprocessing, the raw LIDC stage, the LIDC importer,
the toy-3D cases and the NPC pipeline. Every tree is compared file by file,
byte for byte (npy, pickles, CSV and JSON alike)."""

import csv
import pickle
import random
import shutil

import numpy as np
import pytest

from diffuncertainty_tpu.data import lidc_import as j_import
from diffuncertainty_tpu.data import lidc_raw as j_raw
from diffuncertainty_tpu.data import ood as j_ood
from diffuncertainty_tpu.data import preprocess as j_pre
from diffuncertainty_tpu.data import toy3d as j_toy3d
from diffuncertainty_tpu.data.toy import generate_toy_dataset
from diffuncertainty_tpu_torch.data import lidc_import as t_import
from diffuncertainty_tpu_torch.data import lidc_raw as t_raw
from diffuncertainty_tpu_torch.data import ood as t_ood
from diffuncertainty_tpu_torch.data import preprocess as t_pre
from diffuncertainty_tpu_torch.data import toy3d as t_toy3d
from torch_threads import one_torch_thread  # noqa: F401


def assert_same_tree(a, b):
    """The same relative files under ``a`` and ``b``, each byte-equal."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b
    assert files_a
    for rel in files_a:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def in_place(tmp_path, name, fn):
    """Run ``fn(directory)`` in ``tmp_path/work`` (so that paths written into
    files agree between the two packages), then move the tree to ``name``."""
    work = tmp_path / "work"
    fn(work)
    shutil.move(str(work), str(tmp_path / name))
    return tmp_path / name


# ---------------------------------------------------------------- OOD shifts

SHIFT_INPUTS = {"gray": (40, 36), "rgb": (32, 28, 3), "one": (24, 24, 1)}


@pytest.mark.parametrize("shift", sorted(set(j_ood.SHIFTS) - {"ood_jpeg"}))
def test_ood_shift_equals_jax(shift):
    assert set(t_ood.SHIFTS) == set(j_ood.SHIFTS)
    for i, shape in enumerate(SHIFT_INPUTS.values()):
        img = np.random.default_rng(i).random(shape).astype(np.float32)
        got = t_ood.SHIFTS[shift](img.copy(), np.random.default_rng(7))
        ref = j_ood.SHIFTS[shift](img.copy(), np.random.default_rng(7))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (shift, shape)


def test_generate_ood_split_equals_jax(tmp_path):
    def build(root, module):
        generate_toy_dataset(root, num_train=2, num_val=1, num_test=3, num_ood=1, size=32,
                             seed=4, ood_shifts=())
        for k, shift in enumerate(("ood_contrast", "ood_gibbs", "ood_fov")):
            module.generate_ood_split(root, shift, seed=k, add_paired=k != 1)

    assert_same_tree(in_place(tmp_path, "jax", lambda d: build(d, j_ood)),
                     in_place(tmp_path, "port", lambda d: build(d, t_ood)))


# ------------------------------------------------------------- preprocessing

def write_raw_2d(raw, rng):
    raw.mkdir(parents=True)
    for i, (shape, dtype) in enumerate((((30, 45), np.float32), ((32, 32), np.uint8),
                                        ((17, 40), np.float64))):
        base = f"p{i % 2}_{i:02d}"
        img = rng.random(shape) * (255 if dtype == np.uint8 else 3.0)
        np.save(raw / f"{base}.npy", img.astype(dtype))
        for r in range(2):
            np.save(raw / f"{base}_{r:02d}_mask.npy", (rng.random(shape) > 0.6).astype(np.uint8))


def write_raw_3d(raw, rng):
    raw.mkdir(parents=True)
    for i in range(3):
        base = f"v{i}"
        np.save(raw / f"{base}.npy", rng.standard_normal((6, 20, 24)).astype(np.float32))
        for r in range(2):
            m = np.zeros((6, 20, 24), np.uint8)
            m[1 + i:4, 5:12, 6 + r:14] = 1
            np.save(raw / f"{base}_{r:02d}_mask.npy", m)


@pytest.mark.parametrize("mode", ["center", "foreground", "all"])
def test_preprocess_equals_jax(tmp_path, mode):
    rng = np.random.default_rng(11)
    write_raw_2d(tmp_path / "raw2d", rng)
    write_raw_3d(tmp_path / "raw3d", rng)
    img = rng.random((13, 9)).astype(np.float32)
    assert np.array_equal(t_pre.zscore_normalize(img), j_pre.zscore_normalize(img))
    assert np.array_equal(t_pre.pad_to_multiple(img, 8, "reflect"),
                          j_pre.pad_to_multiple(img, 8, "reflect"))

    def build(out, module):
        ids = module.preprocess_dataset_2d(tmp_path / "raw2d", out, num_raters=2,
                                           patch_multiple=16)
        ids += module.preprocess_volumes_to_slices(tmp_path / "raw3d", out, num_raters=2,
                                                   mode=mode, patch_multiple=32)
        module.generate_splits(out, ids, num_raters=2, seed=3, n_folds=2, val_fraction=0.3,
                               unlabeled_fraction=0.2)
        module.generate_splits(out, ids, split_name="flat", patient_disjoint=False, seed=5)
        return ids

    ids = {}
    jax_tree = in_place(tmp_path, "jax", lambda d: ids.setdefault("jax", build(d, j_pre)))
    port_tree = in_place(tmp_path, "port", lambda d: ids.setdefault("port", build(d, t_pre)))
    assert ids["jax"] == ids["port"]
    assert_same_tree(jax_tree, port_tree)


# --------------------------------------------------------- the raw LIDC stage

SPACING = (1.0, 1.0, 2.0)  # mm per voxel (y, x, z), as tests/test_lidc_raw.py


def ball(module, shape, center_vox, radius_mm, features):
    c = np.asarray(center_vox, float)
    s = np.asarray(SPACING, float)
    r_vox = np.ceil(radius_mm / s).astype(int) + 1
    lo = np.maximum((c - r_vox).astype(int), 0)
    hi = np.minimum((c + r_vox).astype(int) + 1, shape)
    grids = np.meshgrid(*[np.arange(lo[d], hi[d]) for d in range(3)], indexing="ij")
    dist2 = sum(((g - c[d]) * s[d]) ** 2 for d, g in enumerate(grids))
    return module.RaterAnnotation(mask=dist2 <= radius_mm ** 2,
                                  offset=tuple(int(x) for x in lo), features=features)


def scans(module, seed):
    """Two scans at the shapes of ``tests/test_lidc_raw.py:47-60`` (80x80x40,
    nodules of 3 and 2 raters) with seeded HU noise and rater features."""
    rng = np.random.default_rng(seed)
    out = []
    shape = (80, 80, 40)
    for k in range(2):
        vol = (rng.standard_normal(shape) * 40 - 600).astype(np.float32)
        feats = [{"subtlety": int(rng.integers(1, 6)), "malignancy": int(rng.integers(1, 6)),
                  "texture": int(rng.integers(1, 6))} for _ in range(5)]
        anns = [ball(module, shape, (30 + k, 30, 20), 4.0, feats[0]),
                ball(module, shape, (30 + k, 30, 20), 5.0, feats[1]),
                ball(module, shape, (31, 30 + k, 20), 6.0, feats[2]),
                ball(module, shape, (62, 62, 10 + k), 5.0, feats[3]),
                ball(module, shape, (62, 63, 10), 4.0, feats[4])]
        out.append(module.ScanRecord(scan_id=k + 1, patient_id=f"LIDC-IDRI-{k + 1:04d}",
                                     volume=vol, spacing=SPACING, annotations=anns,
                                     series_uid=f"1.2.3.{k}"))
    return out


def test_lidc_raw_stage_equals_jax(tmp_path):
    j_scans, t_scans = scans(j_raw, 5), scans(t_raw, 5)
    jg = j_raw.cluster_annotations(j_scans[0].annotations, SPACING)
    tg = t_raw.cluster_annotations(t_scans[0].annotations, SPACING)
    assert [len(g) for g in jg] == [len(g) for g in tg] == [3, 2]
    assert (t_raw.consensus_extent_vox(tg[0], 0.1) == j_raw.consensus_extent_vox(jg[0], 0.1))
    center = t_scans[0].annotations[0].centroid_vox()
    for kw in ({}, {"raw_z_sampling": False, "voxel_mm": 2.0}):
        got = t_raw.uniform_cubic_resample(t_scans[0].volume, SPACING, center, **kw)
        ref = j_raw.uniform_cubic_resample(j_scans[0].volume, SPACING, center, **kw)
        assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    uid_by_scan = {f"{s.scan_id:04d}": s.series_uid for s in t_scans}

    def build(root, module, scan_list):
        module.save_crops(scan_list, root / "crops", module.CropConfig())
        module.crops_to_aggregated_pickle(root / "crops", root / "agg.pickle", uid_by_scan)

    jax_tree = in_place(tmp_path, "jax", lambda d: build(d, j_raw, j_scans))
    port_tree = in_place(tmp_path, "port", lambda d: build(d, t_raw, t_scans))
    assert (port_tree / "crops" / "metadata.csv").read_bytes() == (
        jax_tree / "crops" / "metadata.csv").read_bytes()
    assert len(list((port_tree / "crops" / "images").glob("*.npy"))) > 10
    assert_same_tree(jax_tree, port_tree)
    assert t_raw.CropConfig.large().samples_per_axis == 128


def test_pylidc_reader_names_pylidc(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "pylidc", None)
    with pytest.raises(ImportError, match="pylidc"):
        next(iter(t_raw.iter_pylidc_scans()))


# --------------------------------------------------------- the LIDC importer

def lidc_fixture(root, n_patients=7, crops_per_patient=(1, 3)):
    rng = np.random.default_rng(9)
    payload, rows, k = {}, [], 0
    for p in range(n_patients):
        subject, series = f"LIDC-IDRI-{p + 3:04d}", f"1.2.840.{p}"
        rows.append((subject, series))
        for _ in range(int(rng.integers(*crops_per_patient))):
            img = np.clip(rng.normal(0.45, 0.2, (128, 128)), -0.2, 1.3)
            payload[f"entry{k}"] = {
                "series_uid": series, "image": img.astype(np.float32),
                "masks": [(rng.random((128, 128)) < 0.1).astype(np.uint8) for _ in range(4)]}
            k += 1
    root.mkdir(parents=True)
    with open(root / "agg.pickle", "wb") as fh:
        pickle.dump(payload, fh)
    with open(root / "meta.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Subject ID", "Series ID"])
        w.writerows(rows)


@pytest.mark.parametrize("size", [128, 64])
def test_lidc_import_equals_jax(tmp_path, size):
    lidc_fixture(tmp_path / "in")
    argv = ["--pickle-path", str(tmp_path / "in" / "agg.pickle"), "--metadata-csv",
            str(tmp_path / "in" / "meta.csv"), "--image-size", str(size), "--num-splits", "3",
            "--test-ratio", "0.3", "--seed", "5"]
    jax_tree = in_place(tmp_path, "jax", lambda d: j_import.main(argv + ["--out-root", str(d)]))
    port_tree = in_place(tmp_path, "port", lambda d: t_import.main(argv + ["--out-root", str(d)]))
    assert_same_tree(jax_tree, port_tree)
    folds = pickle.loads((port_tree / f"origlidc{size}" / "splits" / "ood_aug" / "firstCycle"
                          / "splits.pkl").read_bytes())
    assert len(folds) == 3 and set(t_import.DEFAULT_OOD_SPLITS) <= set(folds[0])
    for shift in t_import.DEFAULT_OOD_SPLITS:
        copies = list((port_tree / f"origlidc{size}" / "preprocessed" / "augmented" / shift
                       / "images").glob("*.npy"))
        assert len(copies) == len(folds[0]["id"]) > 0


def test_cv_splits_and_ood_seeds_equal_jax(tmp_path):
    images = {f"LIDC-IDRI-{p:04d}": [f"{p:04d}_{i:03d}.npy" for i in range(p % 3 + 1)]
              for p in range(1, 12)}
    for seed in (0, 7, 123):
        got = t_import.build_cv_splits(images, num_splits=4, seed=seed, meta={"a": 1})
        ref = j_import.build_cv_splits(images, num_splits=4, seed=seed, meta={"a": 1})
        assert pickle.dumps(got) == pickle.dumps(ref)
    for bad in (dict(test_ratio=1.0), dict(num_splits=1)):
        with pytest.raises(ValueError):
            t_import.build_cv_splits(images, **bad)


# ------------------------------------------------------------------- toy 3D

@pytest.mark.parametrize("case", sorted(j_toy3d.CASE_CONFIGS))
def test_toy3d_case_equals_jax_and_keeps_the_global_streams(tmp_path, case):
    state = (random.getstate(), np.random.get_state())

    def build(root, module):
        module.generate_case(case, root, scale=0.02)
        module.create_splits_toy(root / case, n_splits=2)

    port_tree = in_place(tmp_path, "port", lambda d: build(d, t_toy3d))
    py_after, np_after = random.getstate(), np.random.get_state()
    assert py_after == state[0]
    assert all(np.array_equal(a, b) for a, b in zip(np_after, state[1]))
    jax_tree = in_place(tmp_path, "jax", lambda d: build(d, j_toy3d))
    assert_same_tree(jax_tree, port_tree)


def test_kfold_indices_equal_scikit_learn():
    from sklearn.model_selection import KFold

    for n, k, seed in ((10, 2, 123), (11, 3, 0), (7, 7, 5)):
        ref = list(KFold(k, shuffle=True, random_state=seed).split(np.arange(n)))
        got = t_toy3d.kfold_indices(n, k, seed)
        assert len(got) == len(ref)
        for (gt, gv), (rt, rv) in zip(got, ref):
            assert np.array_equal(gt, rt) and np.array_equal(gv, rv)


# ---------------------------------------------------------------------- NPC

def write_npc_raw(raw):
    """The synthetic MMIS-2024 tree of ``tests/test_npc.py:28-45``."""
    h5py = pytest.importorskip("h5py")
    d, h, w = 6, 40, 48

    def write_volume(path, seed, labeled_slices):
        r = np.random.default_rng(seed)
        with h5py.File(path, "w") as f:
            for key, scale in [("t1", 900.0), ("t1c", 1.3), ("t2", 400.0)]:
                f[key] = (r.random((d, h, w)) * scale).astype(np.float32)
            for a in range(1, 5):
                lab = np.zeros((d, h, w), np.uint8)
                for s in labeled_slices:
                    cy, cx = 20 + a, 24 - a
                    yy, xx = np.mgrid[:h, :w]
                    lab[s] = (((yy - cy) ** 2 + (xx - cx) ** 2) <= 36).astype(np.uint8)
                f[f"label_a{a}"] = lab

    for sub in ("training", "validation"):
        (raw / sub).mkdir(parents=True)
    write_volume(raw / "training" / "patient0.h5", 1, labeled_slices=[1, 2])
    write_volume(raw / "training" / "patient1.h5", 2, labeled_slices=[3])
    write_volume(raw / "validation" / "patient7.h5", 3, labeled_slices=[0, 4])


def test_npc_pipeline_equals_jax(tmp_path):
    from diffuncertainty_tpu.data import npc as j_npc
    from diffuncertainty_tpu_torch.data import npc as t_npc

    write_npc_raw(tmp_path / "raw")

    def build(root, module):
        rows = module.process_npc(tmp_path / "raw" / "training", tmp_path / "raw" / "validation",
                                  root / "preprocessed", image_size=32)
        module.gen_splits_npc(root, seed=3)
        module.create_npc_augmented_ood(root, seed=2)
        return rows

    rows = {}
    jax_tree = in_place(tmp_path, "jax", lambda d: rows.setdefault("jax", build(d, j_npc)))
    port_tree = in_place(tmp_path, "port", lambda d: rows.setdefault("port", build(d, t_npc)))
    assert rows["jax"] == rows["port"] and len(rows["port"]) == 5
    assert_same_tree(jax_tree, port_tree)
    img = np.random.default_rng(0).random((24, 20)).astype(np.float32)
    for name, fn in t_npc.NPC_OOD_SHIFTS.items():
        ref = j_npc.NPC_OOD_SHIFTS[name](img, np.random.default_rng(1))
        assert np.array_equal(fn(img, np.random.default_rng(1)), ref), name


def test_npc_reader_names_h5py(tmp_path, monkeypatch):
    from diffuncertainty_tpu_torch.data import npc as t_npc

    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        t_npc.process_npc(tmp_path, tmp_path, tmp_path / "out")
