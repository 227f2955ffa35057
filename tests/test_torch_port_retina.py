"""The port's retina pipelines (``diffuncertainty_tpu_torch/data/retina.py``)
against the JAX module on the same raw trees, written by Pillow as
``tests/test_retina.py`` writes them (and in the other forms the decoders
read: JPEG images, 1-bit, palette and RGBA masks, PackBits TIFFs). The
preprocessed trees are compared file by file, byte for byte (npy, CSV, JSON,
pickles); the cleaned RIGA PNGs decoded (Pillow and the port compress
differently)."""

import shutil

import numpy as np
import pytest
from PIL import Image

from diffuncertainty_tpu.data import retina as j_retina
from diffuncertainty_tpu_torch.data import retina as t_retina
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset
from diffuncertainty_tpu_torch.infer.image_io import read_image
from torch_threads import one_torch_thread  # noqa: F401

SIZE = 96


def disk(cy, cx, r, h=SIZE, w=SIZE):
    yy, xx = np.mgrid[:h, :w]
    return ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r


def fundus_image(cy, cx, seed, h=SIZE, w=SIZE):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = 90
    img[disk(cy, cx, 20, h, w)] = (200, 120, 60)
    img += rng.integers(0, 10, img.shape).astype(np.uint8)
    return img


def save_mask(mask: np.ndarray, path, form: str) -> None:
    """A binary mask in one of the forms a raw tree may hold."""
    if form == "L":
        Image.fromarray(mask.astype(np.uint8) * 255).save(path)
    elif form == "1":
        Image.fromarray(mask.astype(bool)).save(path)
    elif form == "P":
        im = Image.fromarray(mask.astype(np.uint8), mode="P")
        im.putpalette([0, 0, 0, 255, 255, 255])
        im.save(path)
    else:  # RGBA: white strokes, alpha everywhere
        rgba = np.zeros(mask.shape + (4,), np.uint8)
        rgba[mask.astype(bool), :3] = 255
        rgba[..., 3] = 255
        Image.fromarray(rgba).save(path)


def in_place(tmp_path, name, fn):
    """Run ``fn(directory)`` in ``tmp_path/work`` (``metadata.csv`` holds
    absolute source paths), then move the tree to ``name``."""
    work = tmp_path / "work"
    fn(work)
    shutil.move(str(work), str(tmp_path / name))
    return tmp_path / name


def tree_files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def assert_same_tree(a, b, decode=(".png",)):
    """The same relative files under ``a`` and ``b``: byte-equal, or for
    ``decode`` suffixes the same array and mode as Pillow opens them."""
    files = tree_files(a)
    assert files == tree_files(b) and files
    for rel in files:
        if rel.suffix in decode:
            ia, ib = Image.open(a / rel), Image.open(b / rel)
            assert ia.mode == ib.mode, rel
            assert np.array_equal(np.array(ia), np.array(ib)), rel
            got = read_image(b / rel)
            assert np.array_equal(got.array, np.array(ib)), rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# --------------------------------------------------------------- raw trees

@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    experts = [f"Expert{i}" for i in range(1, 6)]
    mask_forms = ["L", "1", "P", "RGBA", "L"]

    def chaksu_sample(image_dir, label_dir, machine, stem, seed, ext):
        rng = np.random.default_rng(seed)
        cy, cx = 48 + rng.integers(-6, 6), 48 + rng.integers(-6, 6)
        (image_dir / machine).mkdir(parents=True, exist_ok=True)
        Image.fromarray(fundus_image(cy, cx, seed)).save(image_dir / machine / f"{stem}{ext}")
        for k, expert in enumerate(experts):
            for kind, r in (("Disc", 18 + k), ("Cup", 8 + (k % 3))):
                d = label_dir / expert / machine / kind
                d.mkdir(parents=True, exist_ok=True)
                m = disk(cy, cx, r)
                m[2:4, 2:4] = True  # a speckle for the largest-component cleaning
                save_mask(m, d / f"{stem}.png", mask_forms[k])

    chaksu = root / "chaksu_raw"
    for split, stems in (("Train", ["im1", "im2", "im4"]), ("Test", ["im3"])):
        img_dir, lab_dir = chaksu / split / "images", chaksu / split / "labels"
        for i, stem in enumerate(stems):
            chaksu_sample(img_dir, lab_dir, "Remidio", stem, 10 * i + 1, ".png")
        if split == "Train":
            chaksu_sample(img_dir, lab_dir, "Bosch", "imb", 99, ".png")
            chaksu_sample(img_dir, lab_dir, "Forus", "imf", 98, ".jpg")

    riga = root / "riga_raw"
    for clinic, ext, kw in (("MESSIDOR", ".tif", {}),
                            ("BinRushed", ".tif", {"compression": "packbits"})):
        folder = riga / clinic
        folder.mkdir(parents=True)
        for case in (1, 2):
            prime = fundus_image(48, 48, seed=case + 10 * len(clinic))
            Image.fromarray(prime).save(folder / f"image{case}prime{ext}", **kw)
            for k in range(1, 7):
                gt = prime.copy()
                for r in (20 + k, 9 + (k % 4)):
                    gt[disk(48, 48, r) & ~disk(48, 48, r - 2)] = (30, 30, 255)
                Image.fromarray(gt).save(folder / f"image{case}-{k}{ext}", **kw)

    refuge = root / "refuge_raw"
    for n, (split_dir, stems) in enumerate((("Training-400", ["T0001", "T0002"]),
                                            ("Validation-400", ["V0001"]),
                                            ("Test-400", ["S0001"]))):
        for j, stem in enumerate(stems):
            case = refuge / split_dir / stem
            case.mkdir(parents=True)
            Image.fromarray(fundus_image(48, 48, 7 * n + j)).save(case / f"{stem}.jpg")
            for k in range(1, 8):
                save_mask(disk(48, 48, 17 + k % 5), case / f"{stem}_seg_disc_{k}.png",
                          mask_forms[k % 5])
                save_mask(disk(48, 48, 8 + k % 3), case / f"{stem}_seg_cup_{k}.png", "L")
    return {"chaksu": chaksu, "riga": riga, "refuge": refuge}


def run_chaksu(module, raw, work, **kw):
    c = raw["chaksu"]
    module.process_chaksu(c / "Train" / "images", c / "Test" / "images",
                          c / "Train" / "labels", c / "Test" / "labels",
                          work / "preprocessed", image_size=32, **kw)
    module.gen_splits_chaksu(work, num_splits=2, seed=0)


@pytest.mark.parametrize("crop", [{}, {"disc_crop_dia": 0.0, "rel_sidelength": 0.05}])
def test_chaksu_tree_equals_jax(tmp_path, raw, crop):
    ref = in_place(tmp_path, "jax", lambda w: run_chaksu(j_retina, raw, w, **crop))
    got = in_place(tmp_path, "port", lambda w: run_chaksu(t_retina, raw, w, **crop))
    assert len(list((got / "preprocessed" / "images").glob("*.npy"))) == 6
    assert_same_tree(ref, got)


def test_riga_clean_and_process_equal_jax(tmp_path, raw):
    ref_clean = j_retina.clean_riga(raw["riga"], tmp_path / "jax_cleaned")
    got_clean = t_retina.clean_riga(raw["riga"], tmp_path / "port_cleaned")
    assert len(list(got_clean.glob("*_gt*.png"))) == 24
    assert_same_tree(ref_clean, got_clean)
    ref = in_place(tmp_path, "jax", lambda w: j_retina.process_riga(
        ref_clean, w / "preprocessed", image_size=32))
    got = in_place(tmp_path, "port", lambda w: t_retina.process_riga(
        got_clean, w / "preprocessed", image_size=32))
    assert len(list((got / "preprocessed" / "images").glob("*.npy"))) == 4
    assert_same_tree(ref, got)
    # the port's pipeline on the Pillow-written (filtered) cleaned PNGs too
    again = in_place(tmp_path, "port_on_jax", lambda w: t_retina.process_riga(
        ref_clean, w / "preprocessed", image_size=32))
    assert_same_tree(ref, again)


def test_refuge_and_combined_splits_equal_jax(tmp_path, raw):
    def build(module, work):
        for name, key in (("refuge32", "refuge"),):
            module.process_refuge(raw[key], work / name / "preprocessed", image_size=32)
        run_chaksu(module, raw, work / "chaksu32")
        module.gen_splits_retina({"chaksu32": work / "chaksu32", "refuge32": work / "refuge32"},
                                 work / "retina32" / "splits" / "random" / "firstCycle",
                                 train_ratio=0.5, val_ratio=0.2, seed=0)

    ref = in_place(tmp_path, "jax", lambda w: build(j_retina, w))
    got = in_place(tmp_path, "port", lambda w: build(t_retina, w))
    assert len(list((got / "refuge32" / "preprocessed" / "images").glob("*.npy"))) == 4
    assert_same_tree(ref, got)
    splits = got / "retina32" / "splits" / "random" / "firstCycle" / "splits.pkl"
    ds = MultiRaterDataset(splits, got / "retina32", split="train", return_all_raters=True)
    counts = {ds.load(i)["seg"].shape[0] for i in range(len(ds))}
    assert counts <= {5, 7} and counts


def rings(seed):
    rng = np.random.default_rng(seed)
    cy, cx = 40 + rng.integers(-4, 5, 2)
    r_out, r_in = int(rng.integers(22, 27)), int(rng.integers(9, 14))
    ring = ((disk(cy, cx, r_out, 80, 80) & ~disk(cy, cx, r_out - 2, 80, 80))
            | (disk(cy, cx, r_in, 80, 80) & ~disk(cy, cx, r_in - 2, 80, 80)))
    noise = rng.random((80, 80)) < 0.002 * seed
    return ring | noise


@pytest.mark.parametrize("seed", range(4))
def test_label_concentric_rings_equals_jax(seed):
    r = rings(seed)
    for kw in ({}, {"std": 0.0}, {"std": 2.0}, {"noise_tol": 0.5}):
        try:
            ref = j_retina.label_concentric_rings(r, **kw)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc).split(":")[0]):
                t_retina.label_concentric_rings(r, **kw)
            continue
        got = t_retina.label_concentric_rings(r, **kw)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_extract_riga_gt_label_equals_jax(seed):
    prime = fundus_image(40, 40, seed, 80, 80).astype(np.uint8)
    gt = prime.copy()
    gt[rings(seed)] = (30, 30, 255)
    gt = np.clip(gt.astype(int) + np.random.default_rng(seed).integers(-20, 21, gt.shape),
                 0, 255).astype(np.uint8)
    ref = j_retina.extract_riga_gt_label(prime, gt)
    assert np.array_equal(t_retina.extract_riga_gt_label(prime, gt), ref)


def test_geometry_helpers_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        m = rng.random((30, 40)) < 0.3
        assert np.array_equal(t_retina.keep_largest_component(m),
                              j_retina.keep_largest_component(m))
        assert t_retina.get_bbox_center(m) == j_retina.get_bbox_center(m)
        assert t_retina.get_bbox_diameter(m) == j_retina.get_bbox_diameter(m)
        a, b = rng.random((30, 40)) < 0.4, rng.random((30, 40)) < 0.2
        assert np.array_equal(t_retina.build_label(a, b), j_retina.build_label(a, b))
        img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
        center, size = (float(rng.integers(-5, 35)), float(rng.integers(-5, 45))), 23
        crop = t_retina.crop_square(img, center, size)
        assert np.array_equal(crop, j_retina.crop_square(img, center, size))
        for order in ("bilinear", "nearest"):
            for arr in (crop, crop[..., 0]):
                assert np.array_equal(t_retina.resize_array(arr, 17, order),
                                      j_retina.resize_array(arr, 17, order)), order


def test_cli_chaksu_equals_jax(tmp_path, raw):
    c = raw["chaksu"]
    argv = ["chaksu", "--train-image-dir", str(c / "Train" / "images"),
            "--test-image-dir", str(c / "Test" / "images"),
            "--train-label-dir", str(c / "Train" / "labels"),
            "--test-label-dir", str(c / "Test" / "labels"), "--image-size", "24"]
    ref = in_place(tmp_path, "jax", lambda w: j_retina.main(argv + ["--save-path", str(w)]))
    got = in_place(tmp_path, "port", lambda w: t_retina.main(argv + ["--save-path", str(w)]))
    assert_same_tree(ref, got)
