"""Port parity: TU/AU/EU heatmaps, Dice, binary GED, batch metrics, AURC, ECE.

Float32 on the CPU. Heatmaps 1e-6 (elementwise entropies of O(1) values);
Dice/GED 1e-6 (ratios of integer counts); AURC and ECE are host numpy code
copied from the JAX package and must agree to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.evaln.tasks import calc_ece as j_calc_ece
from diffuncertainty_tpu.infer.batch_metrics import make_batch_metrics as j_make_bm
from diffuncertainty_tpu.metrics.aurc import aurc as j_aurc
from diffuncertainty_tpu.metrics.dice import dice_bin_masked as j_dice
from diffuncertainty_tpu.metrics.ged import ged_binary as j_ged
from diffuncertainty_tpu.ops.entropy import one_minus_msr as j_msr
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.sampling.sampler import PredictionStack as JStack
from diffuncertainty_tpu.sampling.sampler import SamplerMeta as JMeta
from diffuncertainty_tpu_torch.evaln.tasks import calc_ece
from diffuncertainty_tpu_torch.infer.batch_metrics import make_batch_metrics
from diffuncertainty_tpu_torch.metrics.aurc import aurc
from diffuncertainty_tpu_torch.metrics.dice import dice_bin_masked
from diffuncertainty_tpu_torch.metrics.ged import ged_binary
from diffuncertainty_tpu_torch.ops.entropy import one_minus_msr, uncertainty_heatmaps
from diffuncertainty_tpu_torch.sampling.sampler import PredictionStack


def softmax_stack(rng, shape):
    logits = rng.standard_normal(shape).astype(np.float32) * 2
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def raters(rng, shape, with_ignore=False):
    gt = (rng.random(shape) < 0.4).astype(np.int32)
    gt[..., :2, :] = 0  # some empty rows; whole empty raters below
    gt[0] = 0
    if with_ignore:
        gt[rng.random(shape) < 0.1] = -1
    return gt


@pytest.mark.parametrize("sample_axis,class_axis", [(0, -1), (0, 1), (1, -1)])
def test_uncertainty_heatmaps_match_jax(rng, sample_axis, class_axis):
    p = softmax_stack(rng, (5, 4, 6, 3))
    p[0, 0, 0] = (1.0, 0.0, 0.0)  # p log p at p == 0
    if class_axis == 1:
        p = np.moveaxis(p, -1, 1).copy()
    ref = j_maps(jnp.asarray(p), sample_axis=sample_axis, class_axis=class_axis)
    got = uncertainty_heatmaps(torch.from_numpy(p), sample_axis=sample_axis, class_axis=class_axis)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    np.testing.assert_allclose(one_minus_msr(torch.from_numpy(p), class_axis=class_axis).numpy(),
                               np.asarray(j_msr(jnp.asarray(p), class_axis=class_axis)), atol=1e-7)


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_dice_matches_jax(rng, ignore_index):
    gt = raters(rng, (4, 9, 11), with_ignore=ignore_index is not None)
    pred = (rng.random((4, 9, 11)) < 0.5).astype(np.int32)
    pred[1] = 0
    ref = j_dice(jnp.asarray(pred), jnp.asarray(gt), ignore_index)
    got = dice_bin_masked(torch.from_numpy(pred), torch.from_numpy(gt), ignore_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("ignore_index", [None, 2])
def test_ged_binary_matches_jax_per_image_and_batched(rng, ignore_index):
    probs = softmax_stack(rng, (3, 5, 8, 8, 2))  # (B, P, H, W, 2)
    probs[0, 1, :, :, 1] = 0.0  # an all-background prediction
    probs[0, 1, :, :, 0] = 1.0
    gt = raters(rng, (3, 4, 8, 8))
    if ignore_index is not None:
        gt[rng.random(gt.shape) < 0.1] = ignore_index
    got = ged_binary(torch.from_numpy(probs), torch.from_numpy(gt), ignore_index)
    for i in range(3):
        ref = j_ged(jnp.asarray(probs[i]), jnp.asarray(gt[i]), ignore_index=ignore_index)
        for k in ("ged", "dice", "max_dice_pred", "max_dice_gt", "major_dice", "dice_matrix"):
            np.testing.assert_allclose(got[k][i].numpy(), np.asarray(ref[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("groups,samples", [(4, 1), (2, 3), (1, 1)])
def test_batch_metrics_match_jax(rng, groups, samples):
    b, h, w = 3, 8, 8
    g = softmax_stack(rng, (groups, samples, b, h, w, 2))
    gm = g.mean(1)
    mean = gm.mean(0)
    gt = raters(rng, (b, 4, h, w))
    meta = JMeta(groups, samples, (False,) * groups)
    ref = j_make_bm(num_classes=2, ignore_index=None, meta=meta, compute_likelihood=False)(
        JStack(jnp.asarray(g), jnp.asarray(gm), jnp.asarray(mean)), jnp.asarray(gt))
    got = make_batch_metrics(num_classes=2, ignore_index=None)(
        PredictionStack(torch.from_numpy(g), torch.from_numpy(gm), torch.from_numpy(mean)),
        torch.from_numpy(gt))
    for k in ("dice", "ged_bma", "ged", "max_dice_pred", "max_dice_gt", "major_dice",
              "mean_idx", "group_idx"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6, err_msg=k)
    assert set(got["heatmaps"]) == set(ref["heatmaps"])
    for k in ref["heatmaps"]:
        np.testing.assert_allclose(got["heatmaps"][k].numpy(), np.asarray(ref["heatmaps"][k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ties", [False, True])
def test_aurc_matches_jax(rng, ties):
    risks = rng.random(97)
    confids = np.round(rng.random(97), 1) if ties else rng.random(97)
    assert abs(aurc(risks, confids) - j_aurc(risks, confids)) < 1e-12


def test_calc_ece_matches_jax(rng):
    confids = rng.random(5000).astype(np.float32)
    correct = rng.random(5000) < confids
    confids[:3] = (0.0, 1.0, 1.0)
    assert abs(calc_ece(correct, confids) - j_calc_ece(correct, confids)) < 1e-12
