"""Port parity: affine warps and TTA.

The same (B, 2, 3) matrices, built in numpy, go through the JAX warp and its
port. Float32 on the CPU; tolerance 2e-5 (the warps are a few f32 products
and sums per output, plus an f32 matmul in the separable passes; values are
O(1)). ``sample_tta_params`` draws with torch's generator, so it is checked
by distribution, and its matrices against the same formula in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.ops import warp as jwarp
from diffuncertainty_tpu.sampling import tta as jtta
from diffuncertainty_tpu_torch.ops import warp as twarp
from diffuncertainty_tpu_torch.sampling import tta as ttta

ATOL = 2e-5


def tta_matrices(rng, n, h, w, hflip_p=0.5, rot=22.5, scale=(-0.2, 0.2)):
    """Forward src->dst TTA affines in numpy: flip, then rotate+scale about the center."""
    flip = rng.random(n) < hflip_p
    ang = np.deg2rad(rng.uniform(-rot, rot, n))
    sc = 1.0 + rng.uniform(scale[0], scale[1], n)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    out = np.zeros((n, 2, 3), np.float64)
    for i in range(n):
        a, b = sc[i] * np.cos(ang[i]), sc[i] * np.sin(ang[i])
        r = np.array([[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy], [0, 0, 1.0]])
        f = np.array([[-1.0, 0, w - 1.0], [0, 1.0, 0], [0, 0, 1.0]]) if flip[i] else np.eye(3)
        out[i] = (r @ f)[:2]
    return out.astype(np.float32)


def inverse(m):
    full = np.concatenate([m, np.broadcast_to([[[0, 0, 1.0]]], (m.shape[0], 1, 3))], axis=1)
    return np.linalg.inv(full)[:, :2].astype(np.float32)


@pytest.mark.parametrize("border", ["replicate", "constant"])
def test_warp_affine_matches_jax(rng, border):
    x = rng.standard_normal((4, 12, 10, 3)).astype(np.float32)
    m = inverse(tta_matrices(rng, 4, 12, 10))
    m[1, :, 2] += (7.5, -13.0)  # a translation that samples far outside
    ref = jwarp.warp_affine(jnp.asarray(x), jnp.asarray(m), border_mode=border)
    got = twarp.warp_affine(torch.from_numpy(x), torch.from_numpy(m), border_mode=border)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("h,w", [(16, 12), (9, 14)])
def test_warp_affine_separable_matches_jax(rng, border, h, w):
    x = rng.standard_normal((5, h, w, 2)).astype(np.float32)
    m = tta_matrices(rng, 5, h, w)
    mx, my = jwarp.separable_margins(22.5, 0.8, 1.2, True, h, w)
    assert (mx, my) == twarp.separable_margins(22.5, 0.8, 1.2, True, h, w)
    for mat in (m, inverse(m)):
        ref = jwarp.warp_affine_separable(jnp.asarray(x), jnp.asarray(mat),
                                          border_mode=border, margin_x=mx, margin_y=my)
        got = twarp.warp_affine_separable(torch.from_numpy(x), torch.from_numpy(mat),
                                          border_mode=border, margin_x=mx, margin_y=my)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_affine_helpers_match_jax(rng):
    ang = rng.uniform(-30, 30, 6).astype(np.float32)
    sc = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    ref_r = jwarp.rotation_matrix(jnp.asarray(ang), jnp.asarray(sc), (4.5, 3.5))
    got_r = twarp.rotation_matrix(torch.from_numpy(ang), torch.from_numpy(sc), (4.5, 3.5))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), atol=1e-6)
    m = tta_matrices(rng, 6, 9, 8)
    np.testing.assert_allclose(twarp.invert_affine(torch.from_numpy(m)).numpy(),
                               np.asarray(jwarp.invert_affine(jnp.asarray(m))), atol=1e-5)
    np.testing.assert_allclose(twarp.hflip_matrix(8).numpy(), np.asarray(jwarp.hflip_matrix(8)))
    m2 = tta_matrices(rng, 6, 9, 8)
    np.testing.assert_allclose(
        twarp.compose_affine(torch.from_numpy(m2), torch.from_numpy(m)).numpy(),
        np.asarray(jwarp.compose_affine(jnp.asarray(m2), jnp.asarray(m))), atol=1e-5)


@pytest.mark.parametrize("separable", [True, False])
def test_apply_and_invert_tta_match_jax(rng, separable):
    h = w = 24
    imgs = rng.standard_normal((6, h, w, 3)).astype(np.float32)
    probs = rng.random((6, h, w, 2)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    fwd = tta_matrices(rng, 6, h, w)
    inv = inverse(fwd)
    mx, my = jwarp.separable_margins(22.5, 0.8, 1.2, True, h, w) if separable else (0, 0)
    jp = jtta.TTAParams(jnp.asarray(fwd), jnp.asarray(inv), separable, mx, my)
    tp = ttta.TTAParams(torch.from_numpy(fwd), torch.from_numpy(inv), separable, mx, my)
    np.testing.assert_allclose(ttta.apply_tta(torch.from_numpy(imgs), tp).numpy(),
                               np.asarray(jtta.apply_tta(jnp.asarray(imgs), jp)), atol=ATOL)
    got = ttta.invert_tta(torch.from_numpy(probs), tp).numpy()
    np.testing.assert_allclose(got, np.asarray(jtta.invert_tta(jnp.asarray(probs), jp)), atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_sample_tta_params_distribution():
    cfg = ttta.TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2))
    n, h, w = 4000, 32, 24
    p = ttta.sample_tta_params(cfg, torch.Generator().manual_seed(0), n, h, w)
    assert (p.margin_x, p.margin_y) == jwarp.separable_margins(22.5, 0.8, 1.2, True, h, w)
    fwd = p.forward.numpy().astype(np.float64)
    # recover flip, scale and angle: the linear part is s*R(-a) . diag(+-1, 1)
    det = fwd[:, 0, 0] * fwd[:, 1, 1] - fwd[:, 0, 1] * fwd[:, 1, 0]
    flip = det < 0
    scale = np.sqrt(np.abs(det))
    angle = np.rad2deg(np.arctan2(fwd[:, 0, 1], fwd[:, 1, 1]))
    assert abs(flip.mean() - 0.5) < 0.04
    assert scale.min() >= 0.8 - 1e-5 and scale.max() <= 1.2 + 1e-5
    assert abs(scale.mean() - 1.0) < 0.01
    assert angle.min() >= -22.5 - 1e-3 and angle.max() <= 22.5 + 1e-3
    assert abs(angle.mean()) < 0.6 and abs(angle.std() - 45 / np.sqrt(12)) < 0.5
    # the center maps to itself, and the inverse inverts
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0, 1.0])
    np.testing.assert_allclose(fwd @ c, np.broadcast_to(c[:2], (n, 2)), atol=1e-3)
    comp = twarp.compose_affine(p.forward, p.inverse).numpy()
    np.testing.assert_allclose(comp, np.broadcast_to([[1, 0, 0], [0, 1, 0]], (n, 2, 3)), atol=1e-4)
    # same draws from the same seed; other draws from another
    again = ttta.sample_tta_params(cfg, torch.Generator().manual_seed(0), n, h, w)
    torch.testing.assert_close(again.forward, p.forward, atol=0, rtol=0)
    other = ttta.sample_tta_params(cfg, torch.Generator().manual_seed(1), n, h, w)
    assert not torch.equal(other.forward, p.forward)


def test_tta_limits_zero_is_identity():
    cfg = ttta.TTAConfig(hflip_p=0.0, rotation_limit=0.0, scale_limit=(0.0, 0.0),
                         separable_warp=False)
    p = ttta.sample_tta_params(cfg, torch.Generator().manual_seed(3), 8, 10, 10)
    np.testing.assert_allclose(p.forward.numpy(), np.broadcast_to([[1, 0, 0], [0, 1, 0]], (8, 2, 3)),
                               atol=1e-6)
    assert not p.separable and p.margin_x == 0
    x = torch.randn(8, 10, 10, 3)
    torch.testing.assert_close(ttta.apply_tta(x, p), x, atol=1e-6, rtol=0)
