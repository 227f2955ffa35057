"""The port's rater-disagreement simulators and per-sample z-score
(``diffuncertainty_tpu_torch/data/augment_extra.py``: ``sample_normalize``,
``intensity_guided_sdf_deform``, ``mask_elastic_deform``) against the JAX
package's numpy functions, on the same inputs and the same
``np.random.default_rng(seed)``: integer masks exactly equal, the z-score to
1e-6, and both generators left in the same state (the same draws taken)."""

import numpy as np
import pytest

from diffuncertainty_tpu.data import augment_extra as j_aug
from diffuncertainty_tpu_torch.data import augment_extra as t_aug
from torch_threads import one_torch_thread  # noqa: F401

HW = 48


def nested_labels(seed: int, levels: int = 3) -> np.ndarray:
    """Nested discs: label k inside label k-1 (1..levels), off-centre."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:HW, :HW]
    cy, cx = rng.uniform(18, 30, 2)
    out = np.zeros((HW, HW), np.uint8)
    for k in range(1, levels + 1):
        out[(yy - cy) ** 2 + (xx - cx) ** 2 < (20 - 5 * k) ** 2] = k
    return out


def image(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = {"rgb": (HW, HW, 3), "gray": (HW, HW, 1), "plain": (HW, HW)}[kind]
    return (rng.random(shape) * 255).astype(np.float32)


def assert_same_state(a: np.random.Generator, b: np.random.Generator) -> None:
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("kind", ["rgb", "gray", "constant"])
def test_sample_normalize_matches_jax(kind):
    img = (np.full((HW, HW, 3), 7.0, np.float32) if kind == "constant"
           else image(kind if kind == "rgb" else "gray", 1).astype(np.float64))
    got, ref = t_aug.sample_normalize(img), j_aug.sample_normalize(img)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if kind == "constant":  # std below eps: the mean removed, nothing scaled
        assert not got.any()


# (image kind, mask): nested labels 1..3, a one-hot mask, a mask that is all
# foreground at level 1 (the level with no outside takes the noise alone),
# and one with no foreground at all
SDF_CASES = {
    "rgb_nested": ("rgb", "nested"),
    "gray_nested": ("gray", "nested"),
    "plain_one_hot": ("plain", "one_hot"),
    "rgb_full_level": ("rgb", "full"),
    "gray_empty": ("gray", "empty"),
}


def sdf_mask(kind: str) -> np.ndarray:
    labels = nested_labels(2)
    if kind == "one_hot":
        return np.eye(4, dtype=np.uint8)[labels]
    if kind == "full":
        return np.maximum(labels, 1)
    if kind == "empty":
        return np.zeros_like(labels)
    return labels


@pytest.mark.parametrize("case", sorted(SDF_CASES))
def test_intensity_guided_sdf_deform_matches_jax(case):
    kind, mask_kind = SDF_CASES[case]
    img, mask = image(kind, 3), sdf_mask(mask_kind)
    kw = dict(std_brightness_deform=4.0, std_random_deform=6.0) if kind == "plain" else {}
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    got = t_aug.intensity_guided_sdf_deform(img, mask, rng_t, **kw)
    ref = j_aug.intensity_guided_sdf_deform(img, mask, rng_j, **kw)
    assert got.dtype == ref.dtype == mask.dtype and got.shape == ref.shape == (HW, HW)
    np.testing.assert_array_equal(got, ref)
    assert_same_state(rng_t, rng_j)
    if mask_kind == "empty":
        assert not got.any()
    else:  # labels stay in 0..3 and the deformation moved some pixels
        assert set(np.unique(got)) <= {0, 1, 2, 3}
        base = mask.argmax(-1) if mask.ndim == 3 else mask
        assert (got != base).any()


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_mask_elastic_deform_matches_jax(dtype):
    mask = nested_labels(4).astype(dtype)
    rng_t, rng_j = np.random.default_rng(6), np.random.default_rng(6)
    got = t_aug.mask_elastic_deform(mask, rng_t, alpha=12.0, sigma=3.0)
    ref = j_aug.mask_elastic_deform(mask, rng_j, alpha=12.0, sigma=3.0)
    assert got.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(got, ref)
    assert_same_state(rng_t, rng_j)
    assert set(np.unique(got)) <= set(np.unique(mask)) and (got != mask).any()
