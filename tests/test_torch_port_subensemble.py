"""Port parity of masked sub-ensembles (``diffuncertainty_tpu/models/subensemble.py``):
which layers take masks, the materialized (M, ...) member stack and the mask
statistics, and the training half: the Gumbel-relaxed (soft) masked weights,
the soft mean pairwise IoU and the size penalty with their gradients, against
the JAX package on a small random DiffUnet (3 masks, random mask logits),
with ``rows_only`` and ``normalize`` each on and off. The Gumbel noise is
JAX's own (its crc32-keyed draws), handed to the port by replacing
``models/subensemble.py::draw_gumbel``. Float32, atol 1e-6."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.models import subensemble as j_se
from diffuncertainty_tpu_torch.core.params import flax_to_torch, flax_to_torch_stacked
from diffuncertainty_tpu_torch.models import subensemble as t_se
from test_torch_port_slice import small_pair
from torch_threads import one_torch_thread  # noqa: F401

M = 3


@pytest.fixture(scope="module")
def base_and_logits():
    _, _, params = small_pair(rate=0.2)
    base = params["params"]
    rng = np.random.default_rng(5)
    logits = jax.tree.map(lambda z: rng.standard_normal(z.shape).astype(np.float32),
                          j_se.init_mask_logits(base, M))
    return base, logits


def test_maskable_layers_and_zero_logits_match_jax(base_and_logits):
    base, _ = base_and_logits
    ref = t_se.jax_mask_keys(j_se.init_mask_logits(base, M))
    got = t_se.init_mask_logits(flax_to_torch(base), M)
    assert set(got) == set(ref)
    assert not any("norm" in k.split(".")[-1] for k in got)  # GroupNorm takes no mask
    for k, v in ref.items():
        for side in ("in", "out"):
            assert tuple(got[k][side].shape) == tuple(v[side].shape)
            assert not got[k][side].any()


@pytest.mark.parametrize("rows_only", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_materialize_members_matches_jax(base_and_logits, rows_only, normalize):
    base, logits = base_and_logits
    ref = flax_to_torch_stacked(jax.tree.map(np.asarray, j_se.materialize_members(
        base, logits, M, rows_only=rows_only, normalize=normalize)))
    state = flax_to_torch(base)
    got = t_se.materialize_members(state, t_se.jax_mask_keys(logits), M, rows_only=rows_only,
                                   normalize=normalize)
    assert set(got) == set(ref) == set(state)
    for k in ref:
        assert got[k].shape == (M,) + tuple(state[k].shape)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)
    assert not torch.equal(got["input_conv.weight"][0], got["input_conv.weight"][1])
    for k in state:  # norms pass through unmasked
        if state[k].ndim == 1 and not k.endswith(".bias"):
            torch.testing.assert_close(got[k][1], state[k], atol=0, rtol=0)


@pytest.mark.parametrize("rows_only", [False, True])
def test_mask_stats_match_jax(base_and_logits, rows_only):
    _, logits = base_and_logits
    ref = j_se.compute_mask_stats(logits, rows_only=rows_only)
    got = t_se.compute_mask_stats(t_se.jax_mask_keys(logits), rows_only=rows_only)
    assert set(got) == set(ref) and got["num_masks"] == M
    for k in ("fill_fraction_per_member", "mean_fill_fraction", "mean_pairwise_iou",
              "pairwise_iou_matrix"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), atol=1e-6, err_msg=k)
    assert t_se.compute_mask_stats({}) == j_se.compute_mask_stats({}) == {"num_masks": 0}


def test_soft_masks_are_not_ported(base_and_logits):
    """Soft masks are ported (the cases below); what stays refused is a soft
    mask with no generator to draw its Gumbel noise from."""
    base, logits = base_and_logits
    with pytest.raises(ValueError, match="Gumbel"):
        t_se.masked_params(flax_to_torch(base), t_se.jax_mask_keys(logits), 0, hard=False)


def jax_gumbels(logits: dict, rng, member: int) -> dict:
    """The Gumbel noise JAX's ``masked_params(hard=False, rng=rng)`` draws for
    ``member``'s masks: {(port layer, side): (2, C)}."""
    out = {}
    for key, sides in logits.items():
        k = jax.random.fold_in(rng, zlib.crc32(key.encode()) % (2**31))
        for side, kk in zip(("in", "out"), jax.random.split(k)):
            out[(key.replace("/", "."), side)] = np.asarray(
                jax.random.gumbel(kk, (2,) + sides[side][member].shape))
    return out


def inject_gumbels(monkeypatch, noise: dict) -> None:
    monkeypatch.setattr(t_se, "draw_gumbel", lambda layer, side, shape, generator, device:
                        torch.from_numpy(noise[(layer, side)]).to(device))


@pytest.mark.parametrize("rows_only", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_soft_masked_params_match_jax(base_and_logits, monkeypatch, rows_only, normalize):
    base, logits = base_and_logits
    rng, member, temp = jax.random.key(3), 1, 0.7
    ref = flax_to_torch(jax.tree.map(np.asarray, j_se.masked_params(
        base, logits, member, hard=False, rng=rng, temp=temp, rows_only=rows_only,
        normalize=normalize)))
    inject_gumbels(monkeypatch, jax_gumbels(logits, rng, member))
    port_logits = {k: {s: torch.from_numpy(np.asarray(v)) for s, v in d.items()}
                   for k, d in t_se.jax_mask_keys(logits).items()}
    state = flax_to_torch(base)
    got = t_se.masked_params(state, port_logits, member, hard=False, generator=torch.Generator(),
                             temp=temp, rows_only=rows_only, normalize=normalize)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    # relaxed, not binary: the kept fraction of a conv is strictly between 0 and 1
    w, w0 = got["input_conv.weight"], state["input_conv.weight"]
    assert not torch.equal(w, w0) and (w != 0).all()


@pytest.mark.parametrize("rows_only", [False, True])
def test_soft_iou_and_size_penalty_and_their_gradients_match_jax(base_and_logits, rows_only):
    _, logits = base_and_logits
    j_logits = jax.tree.map(jnp.asarray, logits)

    def j_terms(lg):
        return (j_se.mean_pairwise_iou(lg, hard=False, rows_only=rows_only),
                j_se.submodel_size_penalty(lg, 0.3, rows_only=rows_only),
                j_se.mean_pairwise_iou(lg, hard=True, rows_only=rows_only))

    def j_objective(lg):
        iou, size, _ = j_terms(lg)
        return iou + 2.0 * size

    ref_val, ref_grad = jax.jit(jax.value_and_grad(j_objective))(j_logits)
    ref_iou, ref_size, ref_hard = jax.jit(j_terms)(j_logits)
    port = {k: {s: torch.from_numpy(np.asarray(v)).requires_grad_(True) for s, v in d.items()}
            for k, d in t_se.jax_mask_keys(logits).items()}
    iou = t_se.mean_pairwise_iou(port, hard=False, rows_only=rows_only)
    size = t_se.submodel_size_penalty(port, 0.3, rows_only=rows_only)
    np.testing.assert_allclose(iou.item(), float(ref_iou), atol=1e-6)
    np.testing.assert_allclose(size.item(), float(ref_size), atol=1e-6)
    np.testing.assert_allclose((iou + 2.0 * size).item(), float(ref_val), atol=1e-6)
    np.testing.assert_allclose(t_se.mean_pairwise_iou(port, hard=True, rows_only=rows_only).item(),
                               float(ref_hard), atol=1e-6)
    assert 0.0 < iou.item() < 1.0 and size.item() > 0.0
    leaves = [port[k][s] for k in port for s in ("in", "out")]
    grads = torch.autograd.grad(iou + 2.0 * size, leaves, allow_unused=True)
    ref = t_se.jax_mask_keys(ref_grad)
    for (k, s), g in zip([(k, s) for k in port for s in ("in", "out")], grads):
        r = np.asarray(ref[k][s])
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, atol=1e-7, rtol=1e-5, err_msg=f"{k} {s}")
