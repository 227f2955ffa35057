"""Port parity of masked sub-ensembles at inference (the hard masks of
``diffuncertainty_tpu/models/subensemble.py``): which layers take masks,
the materialized (M, ...) member stack and the mask statistics, against the
JAX package on a small random DiffUnet (3 masks, random mask logits), with
``rows_only`` and ``normalize`` each on and off. Float32, atol 1e-6."""

import jax
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.models import subensemble as j_se
from diffuncertainty_tpu_torch.core.params import flax_to_torch, flax_to_torch_stacked
from diffuncertainty_tpu_torch.models import subensemble as t_se
from test_torch_port_slice import small_pair

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
    base, logits = base_and_logits
    with pytest.raises(NotImplementedError, match="Gumbel"):
        t_se.masked_params(flax_to_torch(base), t_se.jax_mask_keys(logits), 0, hard=False)
