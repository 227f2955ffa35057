"""The port's native batch reader (``data/native_loader.py`` over
``csrc/npy_batch_loader.cpp``): ``BatchLoader(use_native=True)`` gives the
batches of ``use_native=False`` bit for bit, shuffled and in order, for a
random rater, for every rater and for the stable single rater; the choice
comes from the dataset's files; a failed build or read raises."""

import shutil

import numpy as np
import pytest

from diffuncertainty_tpu_torch.data import native_loader
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset, save_splits
from diffuncertainty_tpu_torch.data.loader import BatchLoader, native_plan
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    not any(shutil.which(c) for c in ("g++", "c++")), reason="no C++ compiler on PATH")


def write_tree(root, image_dtype, mask_dtype, n=7, raters=3, hw=(12, 10), channels=None):
    rng = np.random.default_rng(7)
    (root / "preprocessed" / "images").mkdir(parents=True)
    (root / "preprocessed" / "labels").mkdir(parents=True)
    ids = []
    for i in range(n):
        shape = hw + ((channels,) if channels else ())
        img = rng.random(shape) * (255 if image_dtype == np.uint8 else 2.0)
        np.save(root / "preprocessed" / "images" / f"s{i:02d}.npy", img.astype(image_dtype))
        for r in range(raters):
            np.save(root / "preprocessed" / "labels" / f"s{i:02d}_{r:02d}_mask.npy",
                    rng.integers(0, 3, hw).astype(mask_dtype))
        ids.append(f"images/s{i:02d}.npy")
    save_splits([{"train": ids, "_meta": {"num_raters": raters}}],
                root / "splits.pkl")
    return root / "splits.pkl"


def assert_same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], list):
                assert x[k] == y[k], k
            else:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("dtypes", [(np.float32, np.uint8), (np.uint8, np.int32),
                                    (np.float64, np.int64), (np.int32, np.int8)])
def test_native_batches_equal_the_python_path(tmp_path, dtypes):
    splits = write_tree(tmp_path, *dtypes, channels=3 if dtypes[0] == np.float64 else None)
    native_loader.reset_read_count()
    reads = 0
    for kw in (dict(return_all_raters=False), dict(), dict(return_all_raters=False,
                                                           single_rater=True)):
        for shuffle in (False, True):
            def loader(use_native):
                ds = MultiRaterDataset(splits, tmp_path, split="train", **kw)
                return BatchLoader(ds, 3, shuffle=shuffle, seed=5, drop_last=False,
                                   use_native=use_native)
            fast, slow = loader(True), loader(False)
            assert fast.native and not slow.native
            for _ in range(2):  # two epochs: new orders and new rater draws
                assert_same(list(fast), list(slow))
                reads += 2 * len(fast)
    assert native_loader.read_count() == reads


def test_the_choice_comes_from_the_files(tmp_path):
    splits = write_tree(tmp_path / "a", np.float32, np.uint8)
    ds = MultiRaterDataset(splits, tmp_path / "a", split="train")
    assert native_plan(ds) == {"image": (12, 10), "mask": (12, 10)}
    # another image shape, a dtype the reader does not take, Fortran order
    np.save(tmp_path / "a" / "preprocessed" / "images" / "s03.npy", np.zeros((12, 11), np.float32))
    assert native_plan(MultiRaterDataset(splits, tmp_path / "a", split="train")) is None
    splits = write_tree(tmp_path / "b", np.float32, bool)
    ds = MultiRaterDataset(splits, tmp_path / "b", split="train")
    assert native_plan(ds) is None
    assert not BatchLoader(ds, 2).native
    assert len(list(BatchLoader(ds, 2))) == 3  # the python path reads it
    splits = write_tree(tmp_path / "c", np.float32, np.uint8)
    np.save(tmp_path / "c" / "preprocessed" / "images" / "s01.npy",
            np.asfortranarray(np.ones((12, 10), np.float32)))
    assert native_plan(MultiRaterDataset(splits, tmp_path / "c", split="train")) is None


def test_a_failed_read_or_build_raises(tmp_path):
    splits = write_tree(tmp_path, np.float32, np.uint8)
    loader = BatchLoader(MultiRaterDataset(splits, tmp_path, split="train"), 4)
    assert loader.native
    (tmp_path / "preprocessed" / "labels" / "s02_01_mask.npy").unlink()
    with pytest.raises(IOError, match="s02_01_mask.npy"):
        list(loader)
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int npy_load_batch( { return 0; }\n')
    with pytest.raises(RuntimeError, match="building the native batch reader"):
        native_loader.build(bad)
    assert not native_loader.library_path(bad).exists()
    assert native_loader.library_path().parent == native_loader.BUILD_DIR


@pytest.mark.parametrize("version", [(1, 0), (2, 0), (3, 0)])
def test_header_reads_what_numpy_reads(tmp_path, version):
    """``header`` finds the three fields by name; it gives numpy's own
    reading of the header for every shape, dtype, order and version."""
    arrays = [np.zeros((128, 128), np.float32), np.zeros((3,), np.uint8),
              np.zeros((), np.int64), np.asfortranarray(np.zeros((4, 5))),
              np.zeros((2, 3, 4), np.int8), np.zeros((5,), ">f4"), np.zeros((0, 7), np.int32)]
    for i, a in enumerate(arrays):
        path = tmp_path / f"a{i}.npy"
        with open(path, "wb") as f:
            np.lib.format.write_array(f, a, version=version)
        with open(path, "rb") as f:
            major, _ = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if major == 1
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
        assert native_loader.header(path) == (tuple(shape), dtype.str, bool(fortran))
    (tmp_path / "bad.npy").write_bytes(b"not an npy file at all")
    with pytest.raises(ValueError, match="not an npy file"):
        native_loader.header(tmp_path / "bad.npy")
