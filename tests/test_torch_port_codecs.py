"""The port's JPEG round trip and resize against Pillow, and the modules that
use them against the JAX package: ``ood_jpeg`` and
``preprocess_gta_cityscapes``.

Measured on Pillow 12.1 (libjpeg-turbo) with these inputs: the JPEG round
trip equals Pillow's bit for bit in ``L`` and in ``RGB`` (max |d| = 0, no
pixel differs), and ``resize_bilinear`` equals Pillow's ``BILINEAR`` in
every pixel, downscale and upscale, odd sizes included. The tests hold
``L`` to equality and ``RGB`` to 2/255, ``BILINEAR`` to one level and
``NEAREST`` to equality."""

import io

import numpy as np
import pytest
import scipy.ndimage as ndi
from PIL import Image

from diffuncertainty_tpu_torch.data.jpeg import jpeg_round_trip
from diffuncertainty_tpu_torch.data.resize import resize_bilinear, resize_nearest
from torch_threads import one_torch_thread  # noqa: F401


def pillow_jpeg(arr, quality):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return np.asarray(Image.open(buf))


def ct_like(rng, shape):
    """A smooth field with noise, as a CT crop: 8-bit samples."""
    smooth = ndi.gaussian_filter(rng.random(shape), 2.0) * 1.5 - 0.25
    return (np.clip(smooth + 0.1 * rng.standard_normal(shape), 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jpeg_round_trip_equals_pillow(seed):
    rng = np.random.default_rng(seed)
    gray = ct_like(rng, (128, 128))
    got = jpeg_round_trip(gray, 20)
    assert got.dtype == np.uint8 and np.array_equal(got, pillow_jpeg(gray, 20))
    rgb = ct_like(rng, (64, 64, 3))
    diff = np.abs(jpeg_round_trip(rgb, 20).astype(int) - pillow_jpeg(rgb, 20).astype(int))
    assert diff.max() <= 2, diff.max()
    # odd sizes (edge padding, chroma at the MCU edge), other qualities and
    # the narrow chroma that takes box upsampling: measured equal too
    for shape, quality in (((37, 53), 75), ((23, 9, 3), 95), ((17, 4, 3), 50),
                           ((1, 1, 3), 5)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        diff = np.abs(jpeg_round_trip(img, quality).astype(int)
                      - pillow_jpeg(img, quality).astype(int))
        assert diff.max() <= (0 if img.ndim == 2 else 2), (shape, quality, diff.max())


def test_ood_jpeg_equals_jax():
    from diffuncertainty_tpu.data.ood import ood_jpeg as j_ood_jpeg
    from diffuncertainty_tpu_torch.data.ood import ood_jpeg

    rng = np.random.default_rng(4)
    for shape in ((128, 128), (32, 48, 1), (40, 40, 3)):
        img = (rng.standard_normal(shape) * 0.4 + 0.5).astype(np.float32)
        got, ref = ood_jpeg(img, None), j_ood_jpeg(img, None)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if len(shape) == 3 and shape[2] == 3:
            assert np.abs(got - ref).max() <= 2 / 255 + 1e-7
        else:
            assert np.array_equal(got, ref), shape


@pytest.mark.parametrize("src", [(64, 96), (37, 53), (256, 512)])
def test_resize_equals_pillow(src):
    rng = np.random.default_rng(sum(src))
    differing = 0
    for dst in ((32, 48), (128, 192), (19, 23), (11, 3), (src[0] + 7, src[1] - 5)):
        for shape in (src, src + (3,)):
            img = (rng.random(shape) * 255).astype(np.uint8)
            ref = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR)).astype(int)
            diff = np.abs(resize_bilinear(img, dst).astype(int) - ref)
            assert diff.max() <= 1, (src, dst, diff.max())
            differing += int((diff > 0).sum())
        labels = rng.integers(-3, 40, src).astype(np.int32)
        ref = np.asarray(Image.fromarray(labels, mode="I").resize(dst[::-1], Image.NEAREST))
        got = resize_nearest(labels, dst)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (src, dst)
    assert differing == 0  # measured: equal in every pixel


def test_preprocess_gta_cityscapes_equals_jax(tmp_path):
    from diffuncertainty_tpu.data.cityscapes import preprocess_gta_cityscapes as j_pre
    from diffuncertainty_tpu_torch.data.cityscapes import preprocess_gta_cityscapes

    rng = np.random.default_rng(12)
    raw = tmp_path / "raw"
    raw.mkdir()
    frames = {"f0": (rng.random((90, 140, 3)) * 255).astype(np.uint8),
              "f1": rng.random((61, 123, 3)).astype(np.float32),
              "f2": rng.random((50, 77)).astype(np.float64) * 1.2}
    for name, img in frames.items():
        np.save(raw / f"{name}.npy", img)
        np.save(raw / f"{name}_mask.npy", rng.integers(0, 34, img.shape[:2]).astype(np.int64))
    ids = preprocess_gta_cityscapes(raw, tmp_path / "port", size=(32, 64))
    assert ids == j_pre(raw, tmp_path / "jax", size=(32, 64))
    for name in frames:
        for sub, suffix in (("images", ""), ("labels", "_mask")):
            got = np.load(tmp_path / "port" / "preprocessed" / sub / f"{name}{suffix}.npy")
            ref = np.load(tmp_path / "jax" / "preprocessed" / sub / f"{name}{suffix}.npy")
            assert got.dtype == ref.dtype and got.shape == ref.shape
            tol = 1 / 255 + 1e-7 if sub == "images" else 0
            assert np.abs(got.astype(np.float64) - ref).max() <= tol, (name, sub)
